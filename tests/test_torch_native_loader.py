"""The port's native frame loader (``io/native_loader.py``) over
``native/frameloader.cpp``: held against the port's PIL source and
against the JAX package's loader on the same PNG files, and picked by the
port CLI's source builder.  Where ``native/lib/libframeloader.so`` (git-
ignored, built by tools/build_native.sh) does not load, the fixture
compiles ``native/frameloader.cpp`` with g++ into a temporary directory
and points both packages' loaders at it for the test; nothing is written
into ``native/lib/``.  Skips only where g++ or libpng's header is
missing."""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from openekfmonoslam_tpu.io import native_loader as jloader
from openekfmonoslam_tpu_torch import cli as tcli
from openekfmonoslam_tpu_torch.io import native_loader
from openekfmonoslam_tpu_torch.io.sources import FileSequenceSource

N_FRAMES = 8
SOURCE = Path(__file__).resolve().parent.parent / "native" / "frameloader.cpp"


@pytest.fixture(scope="session")
def built_library(tmp_path_factory):
    """A libframeloader.so compiled from native/frameloader.cpp into a
    temporary directory (as tools/build_native.sh builds it, at -O2)."""
    if shutil.which("g++") is None or not os.path.exists(
            "/usr/include/png.h"):
        pytest.skip("needs g++ and libpng's header to build the loader")
    out = tmp_path_factory.mktemp("frameloader") / "libframeloader.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    str(SOURCE), "-o", str(out), "-lpng", "-lz",
                    "-lpthread"], check=True, capture_output=True,
                   timeout=300)
    return str(out)


@pytest.fixture
def library(request, monkeypatch):
    """The shared library both loaders use in the test: native/lib/'s
    where it loads, else the one built from source."""
    if native_loader.available() and jloader.available():
        return
    path = request.getfixturevalue("built_library")
    for mod in (native_loader, jloader):
        monkeypatch.setattr(mod, "_LIB_PATH", path)
        monkeypatch.setattr(mod, "_lib", None)
    assert native_loader.available() and jloader.available()


@pytest.fixture
def frames(tmp_path, library):
    """8 numbered PNGs, the even ones grey (mode L), the odd ones RGB."""
    rng = np.random.default_rng(0)
    for i in range(1, N_FRAMES + 1):
        if i % 2:
            img = Image.fromarray(rng.integers(0, 256, (48, 64, 3),
                                               dtype=np.uint8), "RGB")
        else:
            img = Image.fromarray(rng.integers(0, 256, (48, 64),
                                               dtype=np.uint8), "L")
        img.save(tmp_path / f"{i:05d}.png")
    return tmp_path


def _all(loader):
    try:
        return np.stack([loader.get(i) for i in range(len(loader))])
    finally:
        loader.close()


def test_matches_pil_and_the_jax_loader(frames):
    paths = native_loader.file_sequence_paths(str(frames), 1, N_FRAMES)
    assert paths == jloader.file_sequence_paths(str(frames), 1, N_FRAMES)
    port = _all(native_loader.NativeFrameLoader(paths, n_threads=2))
    pil = np.stack(list(FileSequenceSource(str(frames), 1, N_FRAMES)))
    assert port.shape == pil.shape == (N_FRAMES, 48, 64)
    assert port.dtype == np.uint8
    # the loader's fixed-point luma and PIL's float one may round apart
    assert np.abs(port.astype(int) - pil.astype(int)).max() <= 1
    # the grey frames decode to the very bytes
    np.testing.assert_array_equal(port[1::2], pil[1::2])
    np.testing.assert_array_equal(
        port, _all(jloader.NativeFrameLoader(paths, n_threads=2)))


def test_iterates_in_order(frames):
    paths = native_loader.file_sequence_paths(str(frames), 1, N_FRAMES)
    loader = native_loader.NativeFrameLoader(paths)
    got = list(loader)
    loader.close()
    assert len(got) == N_FRAMES
    np.testing.assert_array_equal(np.stack(got), _all(
        native_loader.NativeFrameLoader(paths)))


def test_missing_file_returns_none(frames):
    loader = native_loader.NativeFrameLoader([str(frames / "nope.png")])
    assert loader.get(0) is None
    loader.close()


def test_out_of_range(frames):
    paths = native_loader.file_sequence_paths(str(frames), 1, 2)
    loader = native_loader.NativeFrameLoader(paths)
    assert len(loader) == 2
    assert loader.get(5) is None
    assert loader.get(1) is not None
    loader.close()


def test_cli_source_builder_picks_the_native_loader(frames):
    src = tcli.build_source(str(frames), 1, 99)
    assert isinstance(src, native_loader.NativeFrameLoader)
    assert len(src) == N_FRAMES          # only the files that exist
    src.close()
    # real-time simulation keeps its own source, as in the JAX CLI
    assert not isinstance(tcli.build_source(str(frames), 1, 99, 30.0),
                          native_loader.NativeFrameLoader)
