"""The port's stream-batched step (``parallel/batch_runner.py``) on the CPU.

B = 2 streams of 120x128 frames go through the port's batched init and
step, held against the JAX package's ``make_batched_init`` /
``make_batched_step`` in float64 (x 1e-9, masks and match counts
identical) on the FAST profile (``tests/test_batch_runner.py``'s config)
and on the STAR profile (test_torch_live.py's config with its
exact-integral frames), and against the port's own single-stream ``step``
per stream (masks and records identical; x and P within 1e-12, since a
vmapped product may sum in another order).  Streams are independent bit
for bit; the rare paths (detection, addition) run only when a stream needs
them, once for the batch; ``scan_batched_sequences`` equals stepping.
The plain versions that used to write into unbatched tensors vmap, bit for
bit against a per-stream loop (the init chain's bearing angles to an ulp:
see ``test_plain_versions_vmap``), and each kernel's custom op carries the
stream axis through its vmap rule to one launcher call.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu.parallel import batch_runner as jbr
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter import mapman
from openekfmonoslam_tpu_torch.filter.state import SlamState
from openekfmonoslam_tpu_torch.ops import init_kernel, predict_kernel
from openekfmonoslam_tpu_torch.parallel import batch_runner as br

import test_torch_live as live

B, T = 2, 3
H, W = 120, 128
MASKS = ("visible", "matched", "inliers", "new_ok", "new_slot",
         "total_matches", "li_inliers", "hi_inliers", "n_active",
         "n_visible")


def fast_config(mod, **ekf):
    cfg = mod.SlamConfig(max_features=12, max_keypoints=64,
                         max_hypotheses=12, dtype="float64")
    if ekf:
        cfg = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf,
                                                               **ekf))
    return cfg


def fast_frames(seed=42, b=B, t=T):
    """B translation sequences of a blocky texture, one per stream."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, t, H, W), np.uint8)
    for i in range(b):
        big = np.kron(rng.integers(0, 255, (40, 44)), np.ones((4, 4)))
        for j in range(t):
            out[i, j] = big[20:20 + H, 20 + 2 * j:20 + 2 * j + W]
    return out


def star_frames():
    """test_torch_live.py's exact-integral frames, and the same sequence
    mirrored for the second stream."""
    fr = live.make_frames()[:T]
    mirrored = np.stack([live.exact_integral_frame(
        np.ascontiguousarray(f[:, ::-1]), live.tstar.integral_pad(16))
        for f in fr])
    return np.stack([fr, mirrored])


def port_batched(rt, frames):
    """Batched init on frame 0, then batched steps; (states, [records])."""
    st = br.make_batched_init(rt)(br.make_batch_states(rt, frames.shape[0]),
                                  frames[:, 0])
    step = br.make_batched_step(rt)
    recs = []
    for t in range(1, frames.shape[1]):
        st, rec = step(st, frames[:, t])
        recs.append(rec)
    return st, recs


def port_single(rt, frames):
    s = rt.init_step(rt.make_initial_state(), frames[0])
    recs = []
    for f in frames[1:]:
        s, rec = rt.step(s, f)
        recs.append(rec)
    return s, recs


@pytest.mark.parametrize("profile", ["fast", "star"])
def test_matches_jax(profile):
    if profile == "fast":
        frames = fast_frames()
        jrt, trt = JRuntime(fast_config(jcfg)), TRuntime(fast_config(tcfg),
                                                         device="cpu")
    else:
        frames = star_frames()
        jrt = JRuntime(live.make_config(jcfg))
        trt = TRuntime(live.make_config(tcfg), device="cpu")
    js = jbr.make_batched_init(jrt)(jbr.make_batch_states(jrt, B),
                                    jnp.asarray(frames[:, 0]))
    jstep = jbr.make_batched_step(jrt)
    ts, trecs = port_batched(trt, frames)
    for t in range(1, T):
        js, jrec = jstep(js, jnp.asarray(frames[:, t]))
        trec = trecs[t - 1]
        for k in MASKS:
            np.testing.assert_array_equal(getattr(trec, k).numpy(),
                                          np.asarray(getattr(jrec, k)),
                                          err_msg=f"frame {t} {k}")
        np.testing.assert_allclose(trec.x_cam.numpy(),
                                   np.asarray(jrec.x_cam), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-9)
    assert (np.asarray(jrec.total_matches) > 0).all()


def assert_same_stream(batched_rec, b, rec):
    """Stream b of a batched record against a single-stream record: every
    mask and count identical, the floats within 1e-12 (equal when they
    are)."""
    for k, v in rec._asdict().items():
        got = getattr(batched_rec, k)[b]
        if v.dtype.is_floating_point:
            if not torch.equal(got, v):
                torch.testing.assert_close(got, v, rtol=0, atol=1e-12)
        else:
            assert torch.equal(got, v), k


def assert_same_state(states, b, s):
    for k, v in s._asdict().items():
        got = getattr(states, k)[b]
        if v.dtype.is_floating_point and not torch.equal(got, v):
            torch.testing.assert_close(got, v, rtol=0, atol=1e-12)
        elif not v.dtype.is_floating_point:
            assert torch.equal(got, v), k


@pytest.mark.parametrize("profile", ["fast", "star"])
def test_matches_single_stream(profile):
    if profile == "fast":
        frames, rt = fast_frames(), TRuntime(fast_config(tcfg), device="cpu")
    else:
        frames = star_frames()
        rt = TRuntime(live.make_config(tcfg), device="cpu")
    st, recs = port_batched(rt, frames)
    for b in range(B):
        s, srecs = port_single(rt, frames[b])
        for rec_b, rec in zip(recs, srecs):
            assert_same_stream(rec_b, b, rec)
        assert_same_state(st, b, s)


def test_streams_independent():
    """Changing stream 1's frames must not change stream 0 (bit for
    bit)."""
    rt = TRuntime(fast_config(tcfg), device="cpu")
    frames = fast_frames()
    other = frames.copy()
    other[1] = frames[1, :, ::-1]
    sa, _ = port_batched(rt, frames)
    sb, _ = port_batched(rt, other)
    assert torch.equal(sa.x[0], sb.x[0]) and torch.equal(sa.P[0], sb.P[0])
    assert not torch.equal(sa.x[1], sb.x[1])


def test_seeds_set_each_streams_rng():
    rt = TRuntime(fast_config(tcfg), device="cpu")
    st = br.make_batch_states(rt, 3, seeds=[5, 6, 7])
    assert st.rng.tolist() == [5, 6, 7]
    assert st.x.shape == (3, rt.config.padded_state_dim)
    with pytest.raises(ValueError):
        br.make_batch_states(rt, 3, seeds=[1, 2])


class Calls:
    """Counts the calls of the rare paths (one call under vmap is one
    batched call)."""

    def __init__(self, rt, monkeypatch):
        self.detect = self.add = 0
        detect = rt.detect_candidates
        add = feat_mod._add_features_impl

        def counted_detect(*args, **kwargs):
            self.detect += 1
            return detect(*args, **kwargs)

        def counted_add(*args, **kwargs):
            self.add += 1
            return add(*args, **kwargs)

        monkeypatch.setattr(rt, "detect_candidates", counted_detect)
        monkeypatch.setattr(feat_mod, "_add_features_impl", counted_add)


def test_rare_paths_gated_at_batch_level(monkeypatch):
    """No stream in need: no detection and no addition.  One stream in
    need (stream 1 sees a flat frame): one detection for the batch, and
    stream 0's state and record equal its single-stream run with zero
    new_uv."""
    rt = TRuntime(fast_config(tcfg, min_matches_per_image=4), device="cpu")
    frames = fast_frames(t=2)
    st0 = br.make_batched_init(rt)(br.make_batch_states(rt, B), frames[:, 0])
    calls = Calls(rt, monkeypatch)
    _, rec = br.batched_step(rt, st0, frames[:, 1])
    assert (rec.li_inliers >= 4).all()
    assert calls.detect == 0 and calls.add == 0
    assert not rec.new_uv.any() and not rec.new_ok.any()

    flat = frames.copy()
    flat[1, 1] = 128
    st, rec = br.batched_step(rt, st0, flat[:, 1])
    assert calls.detect == 1 and calls.add == 1
    assert rec.li_inliers[1] == 0 and rec.li_inliers[0] >= 4
    s0 = rt.init_step(rt.make_initial_state(), frames[0, 0])
    s0, rec0 = rt.step(s0, frames[0, 1])
    assert_same_stream(rec, 0, rec0)
    assert_same_state(st, 0, s0)
    assert not rec.new_uv[0].any()


def test_scan_matches_stepping():
    rt = TRuntime(fast_config(tcfg), device="cpu")
    frames = fast_frames()
    st = br.make_batched_init(rt)(br.make_batch_states(rt, B), frames[:, 0])
    final, recs = br.scan_batched_sequences(rt, st, frames[:, 1:])
    assert recs.x_cam.shape == (T - 1, B, 13)
    s = st
    for t in range(1, T):
        s, rec = br.batched_step(rt, s, frames[:, t])
        for k, v in rec._asdict().items():
            assert torch.equal(getattr(recs, k)[t - 1], v), k
    assert all(torch.equal(a, b) for a, b in zip(final, s))


def _stack_states(states):
    return SlamState(*(torch.stack(f) for f in zip(*states)))


def test_plain_versions_vmap():
    """predict_plain, convert_one_to_xyz and add_covariance_plain under
    torch.func.vmap equal a per-stream loop bit for bit."""
    rt = TRuntime(fast_config(tcfg), device="cpu")
    frames = fast_frames()
    st, _ = port_batched(rt, frames)
    cfg = rt.config
    lin, ang = cfg.ekf.linear_accel_sd ** 2, cfg.ekf.angular_accel_sd ** 2

    got = vmap(lambda P, x: predict_kernel.predict_plain(P, x, 1.0, lin,
                                                         ang))(st.P, st.x)
    for b in range(B):
        want = predict_kernel.predict_plain(st.P[b], st.x[b], 1.0, lin, ang)
        assert all(torch.equal(g[b], w) for g, w in zip(got, want))

    # a threshold every inverse-depth slot is below: each stream converts
    conv = vmap(lambda s: mapman.convert_one_to_xyz(s, 1e9))(st)
    assert conv.is_xyz.sum() == st.is_xyz.sum() + B
    for b in range(B):
        one = mapman.convert_one_to_xyz(
            SlamState(*(f[b] for f in st)), 1e9)
        assert all(torch.equal(g[b], w) for g, w in zip(conv, one))

    rng = np.random.default_rng(3)
    C, F = cfg.max_features, cfg.max_features
    cam = Camera.from_calibration(cfg.camera)
    cuv = torch.tensor(rng.uniform(10, 110, (B, C, 2)))
    slots = torch.tensor(np.stack([rng.permutation(F), rng.permutation(F)]),
                         dtype=torch.int32)
    ok = torch.tensor(rng.random((B, C)) < 0.5)
    slots[1, 3], ok[1, 3] = slots[1, 5], True      # two on one slot
    ok[1, 5] = True
    r_add = (1.0, 1.0, 0.25)
    got = vmap(lambda P, c7, u, s, o: init_kernel.add_covariance_plain(
        cam, P, c7, u, s, o, 1.0, r_add))(st.P, st.x[:, :7], cuv, slots, ok)
    for b in range(B):
        feats, P_new = init_kernel.add_covariance_plain(
            cam, st.P[b], st.x[b, :7], cuv[b], slots[b], ok[b], 1.0, r_add)
        assert torch.equal(got[1][b], P_new)
        # the bearing angles' atan2: PyTorch's CPU kernels take a tensor's
        # last elements by a scalar loop after the SIMD ones, and the two
        # round atan2 differently, so an angle may move by an ulp when the
        # stream axis changes which candidates fall in the tail
        torch.testing.assert_close(got[0][b], feats, rtol=0, atol=1e-15)


def test_custom_op_vmap_rules_launch_once(monkeypatch):
    """The custom ops' vmap rules: each operand's stream axis moved to the
    front (or an unbatched operand expanded), one launcher call for the
    batch, the outputs per stream.  The launcher is stood in for by the
    plain version over the stacked streams (no card here)."""
    calls = []

    def fake_predict(P, x, dt, lin, ang):
        calls.append(P.shape)
        outs = [predict_kernel.predict_plain(P[b], x[b], dt, lin, ang)
                for b in range(P.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    monkeypatch.setattr(predict_kernel, "predict_cuda", fake_predict)
    rng = np.random.default_rng(0)
    N = 20
    A = rng.standard_normal((N, N))
    P0 = torch.tensor(A @ A.T)
    xs = torch.tensor(rng.standard_normal((N, 3)))     # stream axis last
    op = predict_kernel._batched_op()
    got = vmap(lambda x: op(P0, x, 1.0, 0.1, 0.2), in_dims=1)(xs)
    assert calls == [(3, N, N)]
    for b in range(3):
        want = predict_kernel.predict_plain(P0, xs[:, b], 1.0, 0.1, 0.2)
        assert all(torch.equal(g[b], w) for g, w in zip(got, want))
