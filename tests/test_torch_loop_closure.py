"""Both packages' ``SlamEngine(keyframe_every=6, relocalize_after=3)`` in
float64 over the loop-closure scenario of tests/test_loop_closure.py: 46
frames forward, 8 black frames (tracking is lost, the map relocalizes),
then the forward frames reversed, so the camera ends where it started.
The scene is tests/test_torch_live.py's 160x120 sliding window (STAR and
BRIEF-256), nudged so that STAR's float32 integral image is exact.

The two packages take the same relocalizations, keyframe frames and loop
closures (i, j, matches; rms, dr, dq and information within 1e-9), their
records agree within 1e-9, and ``corrected_trajectory()`` agrees within
1e-4 m: its graph is float32 in both packages (measured 1.5e-6).  The
correction brings the endpoint back toward the start (raw 1.28 m, 0.19 m
corrected).  Each engine's graph checkpoint resumes in the other's
engine.
"""

import numpy as np
import pytest

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.engine.engine import SlamEngine as JEngine
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine as TEngine
from openekfmonoslam_tpu_torch.io.sources import SlidingWindowSource
from openekfmonoslam_tpu_torch.vision import star as tstar
from test_torch_live import H, W, exact_integral_frame, make_config
from test_torch_live import make_texture

N_FWD = 46


def scenario_frames(seed=42):
    """Forward over a sliding window, 8 black frames, then the forward
    frames reversed: the camera ends where it started."""
    rng = np.random.default_rng(seed)
    src = SlidingWindowSource(make_texture(rng, 240, 400), (H, W),
                              step_xy=(2, 0), n_frames=N_FWD)
    pad = tstar.integral_pad(16)
    fwd = [exact_integral_frame(f, pad) for f in src]
    return fwd + [np.zeros_like(fwd[0])] * 8 + fwd[::-1][1:]


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    seq = scenario_frames()
    out = {}
    for name, engine, mod, kw in (("jax", JEngine, jcfg, {}),
                                  ("port", TEngine, tcfg,
                                   {"device": "cpu"})):
        eng = engine(make_config(mod), keyframe_every=6,
                     keyframe_capacity=32, relocalize_after=3, **kw)
        eng.init(seq[0])
        for f in seq[1:]:
            eng.step(f)
        ckpt = str(tmp_path_factory.mktemp(name) / "ckpt.npz")
        eng.save_checkpoint(ckpt)
        out[name] = dict(engine=eng, ckpt=ckpt,
                         corrected=eng.corrected_trajectory())
    return out


def test_engines_take_the_same_keyframes_and_closures(loop_runs):
    j, p = loop_runs["jax"]["engine"], loop_runs["port"]["engine"]
    assert p.relocalizations == j.relocalizations >= 1
    assert p.keyframe_frames == j.keyframe_frames
    key = ("i", "j", "matches", "frame_i", "frame_j")
    closures = [tuple(c[k] for k in key) for c in p.loop_closer.closures]
    assert closures == [tuple(c[k] for k in key)
                        for c in j.loop_closer.closures]
    assert closures, "no loop closure accepted"
    for a, b in zip(p.loop_closer.closures, j.loop_closer.closures):
        assert abs(a["rms_px"] - b["rms_px"]) < 1e-9
        for k in ("dr", "dq"):
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=0,
                                       atol=1e-9)
        np.testing.assert_allclose(a["info"], np.asarray(b["info"]),
                                   rtol=1e-9)
    for rp, rj in zip(p.records, j.records):
        for k in ("position", "orientation"):
            np.testing.assert_allclose(rp[k], rj[k], rtol=0, atol=1e-9)
        assert rp["total_matches"] == rj["total_matches"]


def test_corrected_trajectory_against_jax(loop_runs):
    got = loop_runs["port"]["corrected"]
    want = loop_runs["jax"]["corrected"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    raw = np.asarray([r["position"] for r in
                      loop_runs["port"]["engine"].records])
    raw_err = np.linalg.norm(raw[-1] - raw[0])
    corr_err = np.linalg.norm(got[-1] - got[0])
    assert corr_err < 0.8 * raw_err, (corr_err, raw_err)


def test_engine_graph_checkpoints_cross(loop_runs):
    """Each engine's saved graph resumes in the other package's engine."""
    for src, dst, engine, mod, kw in (
            ("jax", "port", TEngine, tcfg, {"device": "cpu"}),
            ("port", "jax", JEngine, jcfg, {})):
        eng = engine(make_config(mod), keyframe_every=6,
                     keyframe_capacity=32, relocalize_after=3, **kw)
        eng.resume(loop_runs[src]["ckpt"])
        saved = np.load(loop_runs[src]["ckpt"] + ".graph.npz")
        for f in saved.files:
            np.testing.assert_array_equal(
                np.asarray(getattr(eng.pose_graph, f)), saved[f], f)
        k = int(saved["n_nodes"])
        assert eng.optimize_pose_graph(iterations=2).shape == (k, 3)
