"""The ported live path (``init_step``, ``step``, ``scan_frames``) end to
end against the JAX package.

Both packages run the s3 profile's front end (STAR detector, BRIEF-256
with a 33 px patch, the descriptor matcher with subpixel refinement) at
160x120 in float64, with a low STAR response threshold so the small frames
carry enough corners: ``init_step``, then 6 ``step``s over a sliding
window.  Every frame's keypoints, match, inlier and visibility masks and
new-feature slots must be identical, and ``x_cam`` within 1e-9.  The
frames are nudged by one grey level in a few pixels so that the padded
frame's mean is an integer: then the float32 integral image is exact in
any summation order and both packages see the same STAR maps (the live
path's subpixel refinement reads them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu.vision import fast as jfast
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine import scan_runner
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.eval import replay as treplay
from openekfmonoslam_tpu_torch.io.sources import SlidingWindowSource
from openekfmonoslam_tpu_torch.vision import fast as tfast
from openekfmonoslam_tpu_torch.vision import star as tstar

H, W = 120, 160
T_STEPS = 6


def make_config(mod):
    cam = mod.CameraCalibration(
        pixels_x=W, pixels_y=H, fx=120.0, fy=120.0, cx=80.0, cy=60.0,
        k1=0.0, k2=0.0, dx=0.01, dy=0.01, angular_vision_x=45.0,
        angular_vision_y=35.0)
    ekf = mod.EKFParams(min_matches_per_image=12,
                        detect_new_features_image_areas_divide_times=1)
    return mod.SlamConfig(
        camera=cam, ekf=ekf, max_features=24, max_keypoints=128,
        dtype="float64",
        detector=mod.DetectorConfig(kind="STAR",
                                    star_response_threshold=8.0))


def make_texture(rng, h, w, n_blobs=400):
    """Blobby texture with plenty of STAR responses."""
    img = np.zeros((h, w), np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(6, h - 6), rng.integers(6, w - 6)
        s = rng.integers(2, 5)
        img[y - s:y + s, x - s:x + s] = rng.integers(60, 255)
    return img.astype(np.uint8)


def exact_integral_frame(img: np.ndarray, pad: int) -> np.ndarray:
    """``img`` with interior pixels moved by one grey level until the
    edge-padded frame sums to m * n with m an integer that the float32
    mean gives back exactly (as sum / n and as sum * (1 / n)): the centred
    values are then integers and every float32 prefix sum is exact."""
    img = img.astype(np.int64)
    h, w = img.shape
    n = (h + 2 * pad) * (w + 2 * pad)
    total = int(np.pad(img, pad, mode="edge").sum())
    assert total < 2 ** 24
    for m in sorted(range(1, 255), key=lambda m: abs(m * n - total)):
        s32, n32 = np.float32(m * n), np.float32(n)
        if s32 / n32 == m and s32 * (np.float32(1) / n32) == m:
            break
    delta = m * n - total
    inner = img[1:-1, 1:-1].reshape(-1)
    step = 1 if delta > 0 else -1
    while delta:
        movable = np.nonzero((inner + step >= 0) & (inner + step <= 255))[0]
        take = movable[:abs(delta)]
        inner[take] += step
        delta -= step * len(take)
    img[1:-1, 1:-1] = inner.reshape(h - 2, w - 2)
    return img.astype(np.uint8)


def make_frames(seed=42):
    rng = np.random.default_rng(seed)
    src = SlidingWindowSource(make_texture(rng, 240, 400), (H, W),
                              step_xy=(2, 0), n_frames=T_STEPS + 1)
    pad = tstar.integral_pad(16)
    return np.stack([exact_integral_frame(f, pad) for f in src])


def record_fields(rec):
    return {k: np.asarray(v) for k, v in rec._asdict().items()}


@pytest.fixture(scope="module")
def runs():
    frames = make_frames()
    jrt = JRuntime(make_config(jcfg))
    trt = TRuntime(make_config(tcfg), device="cpu")

    js = jrt.make_initial_state()
    js, juv, jok, jslot = jax.jit(jrt.init_step_recorded)(
        js, jnp.asarray(frames[0]))
    jstep = jax.jit(jrt.step)
    jrecs = []
    for f in frames[1:]:
        js, rec = jstep(js, jnp.asarray(f))
        jrecs.append(record_fields(rec))

    ts = trt.make_initial_state()
    ts, tuv, tok, tslot = trt.init_step_recorded(ts, frames[0])
    init_state = ts
    trecs = []
    for f in frames[1:]:
        ts, rec = trt.step(ts, f)
        trecs.append({k: v.numpy() for k, v in rec._asdict().items()})
    return dict(frames=frames, jrt=jrt, trt=trt,
                jinit=(np.asarray(juv), np.asarray(jok), np.asarray(jslot)),
                tinit=(tuv.numpy(), tok.numpy(), tslot.numpy()),
                init_state=init_state, jrecs=jrecs, trecs=trecs,
                jstate=js, tstate=ts)


def test_frames_have_exact_integrals():
    frames = make_frames()
    pad = tstar.integral_pad(16)
    for f in frames:
        p = np.pad(f, pad, mode="edge").astype(np.int64)
        assert p.sum() % p.size == 0


def test_init_step_matches_jax(runs):
    (juv, jok, jslot), (tuv, tok, tslot) = runs["jinit"], runs["tinit"]
    assert np.array_equal(jok, tok) and np.array_equal(jslot, tslot)
    assert jok.sum() >= 8
    np.testing.assert_array_equal(juv, tuv)


def test_keypoints_identical_every_frame(runs):
    """The front end's keypoints (positions, order, validity) inside the
    border mask, on every frame, from each package's own precompute."""
    jrt, trt = runs["jrt"], runs["trt"]
    K = jrt.config.max_keypoints
    jpre = jax.jit(jrt.frontend.precompute)    # the step's (jitted) chain
    for f in runs["frames"]:
        jaux = jpre(jnp.asarray(f))
        jk = jfast.detect_keypoints(jaux["score_nms"],
                                    jrt._border_mask(f.shape), K)
        taux = trt.frontend.precompute(torch.as_tensor(f))
        tk = tfast.detect_keypoints(taux["score_nms"],
                                    trt._border_mask(f.shape), K)
        assert np.array_equal(np.asarray(jk.valid), tk.valid.numpy())
        assert int(tk.valid.sum()) >= 20
        assert np.array_equal(np.asarray(jk.yx), tk.yx.numpy())
        np.testing.assert_array_equal(np.asarray(jaux["score_raw"]),
                                      taux["score_raw"].numpy())


@pytest.mark.parametrize("field", ["matched", "inliers", "visible",
                                   "new_ok", "new_slot", "total_matches",
                                   "li_inliers", "hi_inliers", "n_active",
                                   "n_visible"])
def test_masks_and_counts_identical_every_frame(runs, field):
    for t, (j, r) in enumerate(zip(runs["jrecs"], runs["trecs"])):
        assert np.array_equal(j[field], r[field]), (field, t)


@pytest.mark.parametrize("field,tol", [("x_cam", 1e-9), ("P_cam", 1e-9),
                                       ("z", 1e-9), ("pred_uv", 1e-9),
                                       ("new_uv", 1e-9)])
def test_values_within_tolerance_every_frame(runs, field, tol):
    for t, (j, r) in enumerate(zip(runs["jrecs"], runs["trecs"])):
        np.testing.assert_allclose(r[field], j[field], rtol=0, atol=tol,
                                   err_msg=f"{field} frame {t + 1}")


def test_tracking_is_exercised(runs):
    recs = runs["trecs"]
    assert all(r["total_matches"] >= 8 for r in recs)
    assert sum(int(r["new_ok"].sum()) for r in recs) >= 1


def test_scan_frames_equals_stepwise(runs):
    trt = runs["trt"]
    frames = torch.as_tensor(runs["frames"][1:])
    state, recs = scan_runner.scan_frames(trt, runs["init_state"], frames)
    for t, r in enumerate(runs["trecs"]):
        for k, v in r.items():
            assert np.array_equal(getattr(recs, k)[t].numpy(), v), (k, t)
    assert torch.equal(state.x, runs["tstate"].x)
    assert torch.equal(state.P, runs["tstate"].P)


def test_scan_frames_masked_keeps_last_real_state(runs):
    trt = runs["trt"]
    frames = torch.as_tensor(runs["frames"][1:])
    real = torch.tensor([True] * 4 + [False] * (len(frames) - 4))
    state, _ = scan_runner.scan_frames_masked(trt, runs["init_state"],
                                              frames, real)
    ref, _ = scan_runner.scan_frames(trt, runs["init_state"], frames[:4])
    assert torch.equal(state.x, ref.x) and torch.equal(state.P, ref.P)
    assert torch.equal(state.frame, ref.frame)


def test_run_sequence_on_device_and_live_log_replay(runs):
    """run_sequence_on_device gives the step-by-step records, and the
    recorded injection log replays through step_injected to the live
    trajectory."""
    trt = runs["trt"]
    _, recs = scan_runner.run_sequence_on_device(trt, runs["frames"],
                                                 chunk=4)
    np.testing.assert_array_equal(
        recs.x_cam, np.stack([r["x_cam"] for r in runs["trecs"]]))
    log = treplay.record_live_log(trt, runs["frames"], chunk=4)
    assert len(log["frames"]) == T_STEPS and len(log["init"]) >= 8
    traj = treplay.replay_through_engine(trt, log)
    np.testing.assert_allclose(traj, log["trajectory"], rtol=0, atol=1e-9)
