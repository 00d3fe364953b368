"""The ported filter replay path end to end against the JAX package.

Both packages bootstrap the same map with ``add_features_at`` and run the
same numpy-made injection log through ``step_injected`` in float64: drift
with pixel noise, ~10% gross outliers (+30 px, so the rescue and the
high-innovation update fire), misses, new features pinned to slots
(including occupied ones), and a MinMatchesPerImage that forces adds and
culls.  Every StepRecord field must agree on every frame: x_cam and P_cam
within 1e-9, every mask and count exactly.  ``replay_through_engine`` and
``handmatching.replay`` must give the JAX trajectories.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.config import EKFParams as JEKF
from openekfmonoslam_tpu.config import SlamConfig as JConfig
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu.eval import replay as jreplay
from openekfmonoslam_tpu.filter import features as jfeat
from openekfmonoslam_tpu.io import handmatching as jhand
from openekfmonoslam_tpu_torch.config import EKFParams as TEKF
from openekfmonoslam_tpu_torch.config import SlamConfig as TConfig
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.eval import replay as treplay
from openekfmonoslam_tpu_torch.filter import features as tfeat
from openekfmonoslam_tpu_torch.filter.state import state_to_numpy
from openekfmonoslam_tpu_torch.io import handmatching as thand

F = 12
T_FRAMES = 25
EKF = dict(min_matches_per_image=8)


def make_log(seed=3):
    """An injection log in the eval/replay format, from numpy only."""
    rng = np.random.default_rng(seed)
    n0 = 9
    track = np.zeros((F, 2))
    track[:n0] = rng.uniform([120, 90], [520, 390], size=(n0, 2))
    log = {"init": [(track[i].copy(), i) for i in range(n0)], "frames": []}
    for t in range(T_FRAMES):
        track += np.array([0.7, 0.25]) + rng.normal(0, 0.05, (F, 2))
        z = track + rng.normal(0, 0.4, (F, 2))
        z[rng.random(F) < 0.1] += 30.0
        matched = rng.random(F) < 0.9
        new = []
        if t % 3 == 1:
            for slot in rng.choice(F, size=3, replace=False):
                uv = rng.uniform([100, 80], [540, 400])
                new.append((uv, int(slot)))
                track[slot] = uv
        log["frames"].append({"z": z, "matched": matched, "new": new})
    return log


def arrays(entries):
    uv = np.zeros((F, 2))
    valid = np.zeros((F,), bool)
    slots = np.full((F,), F, np.int32)
    for i, (p, s) in enumerate(entries):
        uv[i], valid[i], slots[i] = p, True, s
    return uv, valid, slots


@pytest.fixture(scope="module")
def runs():
    jrt = JRuntime(JConfig(max_features=F, dtype="float64",
                           ekf=dataclasses.replace(JEKF(), **EKF)))
    trt = TRuntime(TConfig(max_features=F, dtype="float64",
                           ekf=dataclasses.replace(TEKF(), **EKF)),
                   device="cpu")
    log = make_log()
    uv0, valid0, slots0 = arrays(log["init"])
    js = jrt.make_initial_state()
    js = jfeat.add_features_at(js, jrt.camera, jrt.config, jnp.asarray(uv0),
                               jnp.zeros((F, 8), jnp.uint32),
                               jnp.asarray(slots0), jnp.asarray(valid0))
    ts = trt.make_initial_state()
    ts = tfeat.add_features_at(ts, trt.camera, trt.config,
                               torch.tensor(uv0),
                               torch.zeros((F, 8), dtype=torch.int32),
                               torch.tensor(slots0), torch.tensor(valid0))
    boot = (js, ts)
    jstep = jax.jit(jrt.step_injected)
    jrecs, trecs = [], []
    for fr in log["frames"]:
        uv, valid, slots = arrays(fr["new"])
        js, jr = jstep(js, jnp.asarray(fr["z"]), jnp.asarray(fr["matched"]),
                       new_uv=jnp.asarray(uv), new_desc=None,
                       new_valid=jnp.asarray(valid),
                       new_slot=jnp.asarray(slots))
        ts, tr = trt.step_injected(ts, fr["z"], fr["matched"], new_uv=uv,
                                   new_valid=valid, new_slot=slots)
        jrecs.append(jr)
        trecs.append(tr)
    return dict(jrt=jrt, trt=trt, log=log, boot=boot, js=js, ts=ts,
                jrecs=jrecs, trecs=trecs)


def test_bootstrap_states_agree(runs):
    js, ts = runs["boot"]
    got = state_to_numpy(ts)
    for name in js._fields:
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)),
                                   rtol=1e-12, atol=1e-12)


def test_every_record_field_agrees_on_every_frame(runs):
    for t, (jr, tr) in enumerate(zip(runs["jrecs"], runs["trecs"])):
        for name in jr._fields:
            a = np.asarray(getattr(jr, name))
            b = getattr(tr, name).numpy()
            assert a.shape == b.shape, (t, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9,
                                           err_msg=f"frame {t} {name}")
            else:
                np.testing.assert_array_equal(b, a,
                                              err_msg=f"frame {t} {name}")


def test_the_log_exercises_every_branch(runs):
    recs = runs["trecs"]
    hi = sum(int(r.hi_inliers) for r in recs)
    added = sum(int(r.new_ok.sum()) for r in recs)
    li_short = sum(int(r.li_inliers + r.hi_inliers) < EKF[
        "min_matches_per_image"] for r in recs)
    missed = sum(int((~r.matched & r.visible).sum()) for r in recs)
    outliers = sum(int((r.matched & ~r.inliers).sum()) for r in recs)
    assert hi > 0 and added > 0 and li_short > 0
    assert missed > 0 and outliers > 0
    active = [int(r.n_active) for r in recs]
    assert any(b < a for a, b in zip(active, active[1:]))   # culls happen


def test_final_states_agree(runs):
    got = state_to_numpy(runs["ts"])
    for name in runs["js"]._fields:
        np.testing.assert_allclose(got[name],
                                   np.asarray(getattr(runs["js"], name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_replay_through_engine_matches_jax(runs):
    jt = jreplay.replay_through_engine(runs["jrt"], runs["log"])
    tt = treplay.replay_through_engine(runs["trt"], runs["log"])
    assert tt.shape == (T_FRAMES, 13)
    np.testing.assert_allclose(tt, jt, rtol=1e-9, atol=1e-9)
    # and both equal the step-by-step run above
    np.testing.assert_allclose(
        tt, np.stack([r.x_cam.numpy() for r in runs["trecs"]]),
        rtol=0, atol=1e-12)


def test_handmatching_replay_matches_jax(runs, tmp_path):
    rng = np.random.default_rng(9)
    lines = ["%YAML:1.0"]
    for t in range(3):
        z = runs["log"]["frames"][t]["z"]
        entries = []
        for i in range(F):
            x, y = z[i] if rng.random() < 0.85 else (-1, -1)
            entries.append(f"{{ x: {x:.3f}, y: {y:.3f} }}")
        lines.append(f"frame{t}: [ " + ", ".join(entries) + " ]")
    path = tmp_path / "hand.yml"
    path.write_text("\n".join(lines) + "\n")
    jframes = jhand.load_hand_matches(str(path), F)
    tframes = thand.load_hand_matches(str(path), F)
    for (jz, jm), (tz, tm) in zip(jframes, tframes):
        np.testing.assert_array_equal(tz, jz)
        np.testing.assert_array_equal(tm, jm)
    js, ts = runs["boot"]

    class JittedRuntime:      # the JAX replay drives a jitted step
        step_injected = staticmethod(jax.jit(runs["jrt"].step_injected))

    js_end, jrecs = jhand.replay(JittedRuntime(), js, jframes)
    ts_end, trecs = thand.replay(runs["trt"], ts, tframes)
    np.testing.assert_allclose(
        np.stack([r.x_cam.numpy() for r in trecs]),
        np.stack([np.asarray(r.x_cam) for r in jrecs]), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ts_end.P.numpy(), np.asarray(js_end.P),
                               rtol=1e-9, atol=1e-9)
