"""The port's ``viz/`` (overlays, the planar trajectory, the 3D map view)
against the JAX package's, and the engine's and the CLI's rendering
options.

- ``ellipse_params``, ``draw_prediction_overlay``, ``draw_ransac_debug``,
  ``draw_planar_trajectory`` and ``render_map3d`` of both packages on the
  same seeded numpy arrays: the same numbers, the images pixel for pixel.
- ``snapshot_from_state`` of both packages on the same state, with
  converted (XYZ) and inverse-depth slots, in float64: within 1e-12.
- ``SlamEngine`` of both packages with ``render``, ``render_debug`` and
  ``viz3d_every=2`` over the live test's frames (tests/test_torch_live.py,
  float64): the same files, and the same overlay on every frame; the
  port's CLI with ``--render --render-debug --viz3d 2`` on the CPU writes
  the same file set, and its overlays equal the port's engine's on the
  same config file.  A rendered frame reads the record back in the one
  packed summary copy: the overlays add no host read.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.core import quaternion as jquat
from openekfmonoslam_tpu.engine import engine as jeng
from openekfmonoslam_tpu.filter import state as jstate
from openekfmonoslam_tpu.graph.loop_closure import (
    landmark_world_xyz as jlandmarks)
from openekfmonoslam_tpu.viz import draw as jdraw
from openekfmonoslam_tpu.viz import viewer3d as jview
from openekfmonoslam_tpu_torch import cli
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine import engine as teng
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.filter import mapman
from openekfmonoslam_tpu_torch.viz import draw as tdraw
from openekfmonoslam_tpu_torch.viz import viewer3d as tview
from test_torch_cli import ARGS, CONFIG
from test_torch_live import H, W, make_config, make_frames

F = 24


def scene(seed, dtype=np.float64, F=F):
    """A gray frame and a record's drawing fields, seeded."""
    rng = np.random.default_rng(seed)
    gray = rng.integers(0, 256, (H, W), dtype=np.uint8)
    uv = rng.uniform(-5, [W + 5, H + 5], (F, 2)).astype(dtype)
    A = rng.normal(0, 3, (F, 2, 2))
    S = (A @ A.transpose(0, 2, 1) + np.eye(2)).astype(dtype)
    z = (uv + rng.normal(0, 2, (F, 2))).astype(dtype)
    return dict(gray=gray, uv=uv, S=S, z=z,
                visible=rng.random(F) < 0.8, matched=rng.random(F) < 0.6,
                inliers=rng.random(F) < 0.5,
                new_uv=rng.uniform(0, [W, H], (F, 2)).astype(dtype),
                new_ok=rng.random(F) < 0.3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ellipse_params(dtype):
    S = scene(1, dtype)["S"]
    for s in list(S) + [np.diag([4.0, 1.0]).astype(dtype),
                        np.zeros((2, 2), dtype)]:
        ja, jang = jdraw.ellipse_params(s)
        ta, tang = tdraw.ellipse_params(s)
        assert np.array_equal(ja, ta) and ja.dtype == ta.dtype
        assert jang == tang


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_matches", [True, False])
def test_prediction_overlay(seed, dtype, with_matches):
    s = scene(seed, dtype)
    extra = (s["z"], s["matched"]) if with_matches else ()
    want = jdraw.draw_prediction_overlay(s["gray"], s["uv"], s["S"],
                                         s["visible"], *extra)
    got = tdraw.draw_prediction_overlay(s["gray"], s["uv"], s["S"],
                                        s["visible"], *extra)
    assert got.shape == (H, W, 3) and np.array_equal(got, want)
    assert not np.array_equal(got[..., 0], got[..., 1])    # something drawn


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("with_new", [True, False])
def test_ransac_debug(seed, with_new):
    s = scene(seed)
    extra = (s["new_uv"], s["new_ok"]) if with_new else ()
    want = jdraw.draw_ransac_debug(s["gray"], s["z"], s["matched"],
                                   s["inliers"], *extra)
    got = tdraw.draw_ransac_debug(s["gray"], s["z"], s["matched"],
                                  s["inliers"], *extra)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axes", [(0, 2), (0, 1)])
def test_planar_trajectory(axes):
    rng = np.random.default_rng(6)
    pos = np.cumsum(rng.normal(0, 0.05, (40, 3)), axis=0)
    assert np.array_equal(tdraw.draw_planar_trajectory(pos, 300, axes),
                          jdraw.draw_planar_trajectory(pos, 300, axes))


def map_arrays(seed, n=30, T=12):
    rng = np.random.default_rng(seed)
    lm = rng.normal(0, 1.0, (n, 3)) + [0, 0, 3]
    active = rng.random(n) < 0.8
    is_xyz = rng.random(n) < 0.4
    traj = np.cumsum(rng.normal(0, 0.05, (T, 3)), axis=0)
    q = rng.normal(size=4)
    R = np.asarray(jquat.to_rotation_matrix(jnp.asarray(q / np.linalg.norm(
        q))))
    return lm, active, is_xyz, traj, traj[-1], R, rng.random(n) * 0.3


@pytest.mark.parametrize("case", ["sigma", "no_sigma", "empty"])
def test_render_map3d(case):
    lm, active, is_xyz, traj, r, R, sigma = map_arrays(7)
    if case == "empty":
        active = np.zeros_like(active)
    kw = dict(sigma=sigma) if case == "sigma" else {}
    got = tview.render_map3d(lm, active, is_xyz, traj, r, R, size_px=240,
                             **kw)
    want = jview.render_map3d(lm, active, is_xyz, traj, r, R, size_px=240,
                              **kw)
    assert got.shape == (240, 240, 3) and np.array_equal(got, want)


def converted_state():
    """The port's state after init + 3 steps of the live test, with two
    slots converted to XYZ; and the same state as a JAX SlamState."""
    rt = TRuntime(make_config(tcfg), device="cpu")
    frames = make_frames()
    st = rt.init_step(rt.make_initial_state(), frames[0])
    for f in frames[1:4]:
        st, _ = rt.step(st, f)
    for _ in range(2):
        st = mapman.convert_one_to_xyz(st, 1e9)
    js = jstate.make_initial_state(make_config(jcfg), jnp.float64)
    js = js._replace(**{k: jnp.asarray(getattr(st, k).numpy())
                        for k in ("x", "P", "active", "is_xyz")})
    return st, js


def test_snapshot_from_state_matches_jax():
    st, js = converted_state()
    assert 0 < int((st.active & st.is_xyz).sum()) < int(st.active.sum())
    got = tview.snapshot_from_state(st)
    want = jview.snapshot_from_state(js, jquat, jlandmarks)
    for g, w, name in zip(got, want, ("landmarks", "active", "is_xyz",
                                      "cam_r", "cam_R", "sigma")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype == bool:
            assert np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12,
                                       err_msg=name)


def test_snapshot_reads_back_once(monkeypatch):
    """One device-to-host copy a view: every ``.cpu()`` of the snapshot
    counted."""
    st, _ = converted_state()
    calls = []
    cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        calls.append(tuple(self.shape))
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    tview.snapshot_from_state(st)
    assert len(calls) == 1


RENDER = dict(render=True, render_debug=True, viz3d_every=2)


def file_set(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def overlays(root):
    return sorted(f for f in file_set(root)
                  if f.endswith(".png") and "map3d" not in f)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    frames = make_frames()
    out = {}
    for name, mod, make in (
            ("jax", jcfg, lambda c, p: jeng.SlamEngine(c, output_path=p,
                                                       **RENDER)),
            ("port", tcfg, lambda c, p: teng.SlamEngine(
                c, output_path=p, device="cpu", **RENDER))):
        path = str(tmp / name)
        engine = make(make_config(mod), path)
        engine.init(frames[0])
        for f in frames[1:]:
            engine.step(f)
        engine.close()
        out[name] = path
    out["steps"] = len(frames) - 1
    out["tmp"] = tmp
    return out


def test_engine_writes_the_jax_engines_files(engines):
    got, want = file_set(engines["port"]), file_set(engines["jax"])
    assert got == want
    n = engines["steps"]
    for name in ([f"{i:05d}.png" for i in range(1, n + 1)]
                 + [f"debug/{i:05d}.png" for i in range(1, n + 1)]
                 + [f"map3d_{i:05d}.png" for i in range(2, n + 1, 2)]
                 + ["videoOutput.mp4", "debug/ransacDebug.mp4"]):
        assert name in got, name


def test_engine_overlays_equal_jax(engines):
    names = overlays(engines["port"])
    assert len(names) == 2 * engines["steps"]
    for name in names:
        got = cv2.imread(os.path.join(engines["port"], name))
        want = cv2.imread(os.path.join(engines["jax"], name))
        assert np.array_equal(got, want), name


def test_engine_map3d_views_equal_jax(engines):
    names = [n for n in file_set(engines["port"]) if n.startswith("map3d")]
    assert len(names) == engines["steps"] // 2
    for name in names:
        got = np.asarray(Image.open(os.path.join(engines["port"], name)))
        want = np.asarray(Image.open(os.path.join(engines["jax"], name)))
        assert np.array_equal(got, want), name


def test_engine_reads_the_overlay_fields_in_the_summary_copy(monkeypatch,
                                                           tmp_path):
    """A rendered frame makes as many device-to-host copies as an
    unrendered one: the overlays' fields ride in the packed summary."""
    frames = make_frames()
    calls = []
    cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        calls.append(tuple(self.shape))
        return cpu(self, *args, **kwargs)

    counts = []
    for kw in ({}, dict(render=True, render_debug=True)):
        engine = teng.SlamEngine(make_config(tcfg), device="cpu", **kw,
                                 output_path=str(tmp_path / str(len(kw))))
        assert (engine._sink is not None) == bool(kw)
        engine.init(frames[0])
        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        calls.clear()
        engine.step(frames[1])
        counts.append(len(calls))
        monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    assert counts[0] == counts[1] == 1


def test_cli_render_flags(engines):
    tmp = engines["tmp"]
    frames_dir = tmp / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(make_frames(), start=1):
        Image.fromarray(f).save(frames_dir / f"{i:05d}.png")
    config = tmp / "config.yml"
    config.write_text(CONFIG)
    out = tmp / "cli"
    cli.main([str(config), str(frames_dir), str(out), "--render",
              "--render-debug", "--viz3d", "2", *ARGS])
    got = [f for f in file_set(out)
           if f.endswith((".png", ".mp4"))]
    assert got == [f for f in file_set(engines["jax"])
                   if f.endswith((".png", ".mp4"))]
    # the CLI is the port's engine on the config file: the same overlays
    engine = teng.SlamEngine(str(config), output_path=str(tmp / "cli_eng"),
                             device="cpu", max_features=24, **RENDER)
    teng.run_sequence(engine, [np.asarray(Image.open(frames_dir / n))
                               for n in sorted(os.listdir(frames_dir))])
    engine.close()
    for name in overlays(out):
        assert np.array_equal(cv2.imread(str(out / name)),
                              cv2.imread(str(tmp / "cli_eng" / name))), name
