"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at first use,
into ``build/torch_kernels/`` at the repository root (git-ignored), under a
name that hashes the sources and flags, so an edited source is rebuilt.
Importing this module builds nothing and needs no ``nvcc``: only a kernel
launch on a CUDA tensor does.

Each kernel module (``ops/*_kernel.py``) keeps a :class:`LaunchCounter`
that its wrapper bumps once per kernel launch, so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class CamParams(ctypes.Structure):
    """Mirror of ``struct CamParams`` in csrc/common.cuh."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "fx", "fy", "cx", "cy", "k1", "k2", "dx", "dy",
        "tan_x", "tan_y", "pixels_x", "pixels_y")]

    @classmethod
    def from_camera(cls, cam) -> "CamParams":
        return cls(cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.dx,
                   cam.dy, cam.tan_vision_x, cam.tan_vision_y,
                   float(cam.pixels_x), float(cam.pixels_y))


STAR_MAX_SIZES = 14


class StarParams(ctypes.Structure):
    """Mirror of ``struct StarParams`` in csrc/star.cu."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "h", "w", "ii_w", "pad", "n_sizes", "nms_radius")]
        + [("response_threshold", ctypes.c_float),
           ("line_threshold", ctypes.c_float),
           ("size", ctypes.c_int * STAR_MAX_SIZES),
           ("fuse", ctypes.c_int * STAR_MAX_SIZES),
           ("r_in", ctypes.c_float * STAR_MAX_SIZES),
           ("r_out", ctypes.c_float * STAR_MAX_SIZES)])


# C signatures of the exported launchers (csrc/*.cu); each returns a
# cudaError_t, 0 on success.
_SIGNATURES = {
    "ekf_predict": [_P, _P, _P, _P, _I, _F, _F, _F, _P],
    "ekf_measure": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                    ctypes.POINTER(CamParams), _P],
    "ekf_init": [_P, _P, _P, _P, _P, _I, _F, ctypes.POINTER(CamParams), _P],
    "ekf_update": [_P] * 16 + [_I, _I, _F, _P],
    "ekf_star": [_P, ctypes.POINTER(StarParams), _I, _P, _P, _P],
    "ekf_brief": [_P, _I, _I, _P, _P],
    "ekf_brief_generic": [_P, _I, _I, _I, _P, _I, _P, _P],
    "ekf_sinv": [_P] * 11 + [_I, _P],
    "ekf_cholsolve": [_P, _P, _P, _P, _P, _I, _I, _P],
    "ekf_noop": [_P],
}


class LaunchCounter:
    """Counts the launches of one kernel (bumped by its wrapper only)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def hit(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


class KernelLibrary:
    """The built shared library and what its build reported."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.ekf_error_string.argtypes = [ctypes.c_int]
        self.lib.ekf_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Call one launcher; a non-zero cudaError_t raises."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            msg = self.lib.ekf_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


_lock = threading.Lock()
_library: KernelLibrary | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> tuple[float, str]:
    """Compile every source in parallel, then link ``target``."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = target.parent / f"{target.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    so = tmp / target.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    os.replace(so, target)
    shutil.rmtree(tmp, ignore_errors=True)
    text = "\n".join(log)
    target.with_suffix(".log").write_text(text)
    return time.perf_counter() - t0, text


def library() -> KernelLibrary:
    """The kernel library, built on first call (raises if it cannot be)."""
    global _library
    with _lock:
        if _library is None:
            target = BUILD_DIR / f"libekf_kernels_{_digest()}.so"
            if target.exists():
                seconds = 0.0
                log = target.with_suffix(".log").read_text()
            else:
                target.parent.mkdir(parents=True, exist_ok=True)
                seconds, log = _build(target)
            _library = KernelLibrary(target, seconds, log)
        return _library


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_inputs(name: str, tensors: dict) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device,
    float32 except the boolean masks (uint8 storage) and int32 tables."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is not a CUDA tensor")
        want = (t.dtype if t.dtype in (torch.bool, torch.int32)
                else torch.float32)
        if t.dtype != want:
            raise ValueError(f"{name}: {key} must be float32 on the GPU, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")

