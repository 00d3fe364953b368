"""The kernels' batched launches (one launch over B stacked streams, a
stream index in the grid) against B single launches, bit for bit, at
shapes the main path does not reach: odd F and C (per-stream outputs off
16-byte boundaries), predict's scalar fallback (N % 4 != 0), an update
with one stream using no slot, an addition with no valid candidate in one
stream and a duplicate slot in another, RANSAC's support count at odd F
with one stream matching no slot, STAR by both routes and BRIEF by
both variants on an odd frame size, the S-inverse at M = 1, 7, 192 and 336
with one stream's S all identity rows (every row masked); and the wrappers
under
``torch.func.vmap`` on the card, one launch for the batch through each
kernel's custom op.  ``chip_smoke.py`` phase 2 checks the main path's
shapes.

These tests need a CUDA device and skip without one.  This module imports
no JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_batched_kernels.py
"""

import numpy as np
import pytest
import torch
from torch.func import vmap

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.ops import (brief_kernel, init_kernel,
                                           measure_kernel, predict_kernel,
                                           ransac_kernel, sinv, star_kernel,
                                           update_kernel)
from openekfmonoslam_tpu_torch.vision import brief, star

from test_torch_cuda_kernels import ransac_inputs

pytestmark = pytest.mark.cuda

CFG = SlamConfig()
CAM = Camera.from_calibration(CFG.camera)
B = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _spd(rng, n):
    A = rng.standard_normal((n, 40))
    P = A @ A.T / 40 + 0.5 * np.eye(n)
    return 0.5 * (P + P.T)


def _f32(a, dev):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)


def _same(batched, single_of):
    """Every output of the batched launch equals stream b's single launch
    for every b, bit for bit."""
    for b in range(B):
        for got, want in zip(batched, single_of(b)):
            assert torch.equal(got[b], want), b


@pytest.mark.parametrize("N", [43, 640, 1024])
def test_predict(dev, N):
    rng = np.random.default_rng(N)
    P = _f32([_spd(rng, N) for _ in range(B)], dev)
    x = _f32(rng.standard_normal((B, N)) * 0.1, dev)
    args = (1.0, 0.01, 0.02)
    _same(predict_kernel.predict_cuda(P, x, *args),
          lambda b: predict_kernel.predict_cuda(P[b], x[b], *args))


@pytest.mark.parametrize("F", [7, 96])
@pytest.mark.parametrize("quirks", [False, True])
def test_measure(dev, F, quirks):
    rng = np.random.default_rng(F)
    feats = np.zeros((B, F, 6))
    feats[..., 3:5] = rng.normal(0, 0.3, (B, F, 2))
    feats[..., 5] = np.abs(rng.normal(1.0, 0.3, (B, F))) + 0.2
    q = np.array([1.0, 0.02, -0.03, 0.01])
    cam7 = _f32([np.concatenate([rng.normal(0, 0.02, 3),
                                 q / np.linalg.norm(q)]) for _ in range(B)],
                dev)
    feats = _f32(feats, dev)
    is_xyz = torch.tensor(rng.random((B, F)) < 0.3, device=dev)
    active = torch.tensor(rng.random((B, F)) < 0.9, device=dev)
    _same(measure_kernel.measure_cuda(CAM, cam7, feats, is_xyz, active,
                                      quirks),
          lambda b: measure_kernel.measure_cuda(CAM, cam7[b], feats[b],
                                                is_xyz[b], active[b], quirks))


@pytest.mark.parametrize("N,F", [(256, 20), (640, 96)])
def test_update(dev, N, F):
    rng = np.random.default_rng(N + F)
    ops = []
    for b in range(B):
        P = _spd(rng, N)
        H = rng.standard_normal((2 * F, N)) * 0.05
        uv = rng.uniform(0, 600, (F, 2))
        ops.append((P, rng.standard_normal(N) * 0.1, H @ P, H @ P @ H.T, uv,
                    uv + rng.standard_normal((F, 2)),
                    rng.uniform(size=F) < (0.0 if b == 0 else 0.6)))
    args = [_f32([o[k] for o in ops], dev) for k in range(6)]
    args.append(torch.tensor(np.stack([o[6] for o in ops]), device=dev))
    x_out, P_out, _ = update_kernel.joint_update_cuda(*args, 1.0)
    assert torch.equal(x_out[0], args[1][0])      # no slot used: unchanged
    assert torch.equal(P_out[0], args[0][0])
    _same((x_out, P_out), lambda b: update_kernel.joint_update_cuda(
        *(a[b] for a in args), 1.0)[:2])


@pytest.mark.parametrize("N,C", [(128, 5), (640, 96)])
def test_init_and_augment(dev, N, C):
    rng = np.random.default_rng(N + C)
    F = (N - 13) // 6
    qs = rng.standard_normal((B, 4))
    c7 = _f32([np.concatenate([rng.normal(0, 0.1, 3), q / np.linalg.norm(q)])
               for q in qs], dev)
    cuv = _f32(rng.uniform(20, 600, (B, C, 2)), dev)
    P = _f32([_spd(rng, N) for _ in range(B)], dev)
    r_add = (1.0, 1.0, 0.25)
    chain = init_kernel._chain_cuda(CAM, c7, cuv, 1.0, P, r_add)
    _same(chain, lambda b: init_kernel._chain_cuda(CAM, c7[b], cuv[b], 1.0,
                                                   P[b], r_add))
    slots = torch.tensor(np.stack([rng.choice(F, C, replace=False)
                                   for _ in range(B)]), dtype=torch.int32,
                         device=dev)
    ok = torch.tensor(rng.random((B, C)) < 0.6, device=dev)
    ok[0] = False                                   # stream 0 adds nothing
    ok[2, :2] = True
    slots[2, 1] = slots[2, 0]                       # two on one slot
    P_new = init_kernel.augment_cuda(P, chain[3], slots, ok)
    assert torch.equal(P_new[0], P[0])
    _same((P_new,), lambda b: (init_kernel.augment_cuda(
        P[b], chain[3][b], slots[b], ok[b]),))


def _masked_s(rng, m, used_frac):
    """An update's masked S: identity rows and columns for the unused
    slots, an SPD block on the used ones."""
    used = rng.random(m) < used_frac
    h = rng.normal(size=(m, 30)) * 3.0
    S = np.zeros((m, m))
    S[np.ix_(used, used)] = (h @ h.T)[np.ix_(used, used)]
    S[np.diag_indices(m)] += 1.0
    return S


@pytest.mark.parametrize("M", [1, 7, 192, 336])
def test_sinv(dev, M):
    rng = np.random.default_rng(M)
    # stream 0 has every row masked (S = I); the others use more and more
    S = _f32([_masked_s(rng, M, frac) for frac in (0.0, 0.5, 1.0)], dev)
    X, info = sinv.sinv_cuda(S)
    assert torch.equal(X[0], torch.eye(M, device=dev))
    assert info.tolist() == [0] * B
    _same((X,), lambda b: (sinv.sinv_cuda(S[b])[0],))
    # under torch.func.vmap, through the custom op: one launch set
    before = sinv.LAUNCHES.count
    got = vmap(sinv.newton_schulz_inverse)(S)
    assert sinv.LAUNCHES.count == before + 1
    assert torch.equal(got, X)


def _ransac_batch(dev, F, N):
    """B streams' RANSAC frames stacked; stream 0 matches no slot."""
    frames = [ransac_inputs(np.random.default_rng(F + b), F, N, dev,
                            matched_frac=0.0 if b == 0 else 0.9)
              for b in range(B)]
    return [torch.stack(parts) for parts in zip(*frames)]


@pytest.mark.parametrize("F,N", [(37, 256), (96, 640)])
@pytest.mark.parametrize("deadband", [False, True])
def test_ransac_support(dev, F, N, deadband):
    args = _ransac_batch(dev, F, N)
    sup, good = ransac_kernel.support_cuda(CAM, *args, 1.0, 1.0, deadband)
    assert not sup[0].any() and not good[0].any()
    _same((sup, good), lambda b: ransac_kernel.support_cuda(
        CAM, *(a[b] for a in args), 1.0, 1.0, deadband))
    # under torch.func.vmap, through the custom op: one launch
    before = ransac_kernel.LAUNCHES.count
    got = vmap(lambda *a: ransac_kernel.support(CAM, *a, 1.0, 1.0,
                                                deadband))(*args)
    assert ransac_kernel.LAUNCHES.count == before + 1
    assert torch.equal(got[0], sup) and torch.equal(got[1], good)


def _frames(dev, h=483, w=645):
    rng = np.random.default_rng(7)
    return [torch.tensor(rng.integers(0, 256, (h, w), dtype=np.uint8),
                         device=dev) for _ in range(B)]


@pytest.mark.parametrize("route", ["staged", "direct"])
def test_star(dev, route):
    s = star_kernel.StarSettings()
    grays = _frames(dev)
    h, w = grays[0].shape
    ii = torch.stack([star._integral(g, star.integral_pad(s.max_size))
                      for g in grays])
    _same(star_kernel.star_cuda(ii, h, w, s, route),
          lambda b: star_kernel.star_cuda(ii[b], h, w, s, route))


@pytest.mark.parametrize("n_bits,variant", [(256, "s256"), (256, "generic"),
                                            (512, "generic")])
def test_brief(dev, n_bits, variant):
    pattern = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(n_bits, 33, 7), dev)
    smoothed = torch.stack([brief.smooth(g, 2.0) for g in _frames(dev)])
    got = brief_kernel.dense_planes_cuda(smoothed, pattern, variant)
    _same((got,), lambda b: (torch.stack(brief_kernel.dense_planes_cuda(
        smoothed[b], pattern, variant)),))


def test_wrappers_under_vmap_launch_once(dev):
    """predict, measure, update, STAR and BRIEF through torch.func.vmap on
    the card: one launch each for the batch, the batched launch's bits."""
    rng = np.random.default_rng(1)
    N, F = 640, 96
    P = _f32([_spd(rng, N) for _ in range(B)], dev)
    x = _f32(rng.standard_normal((B, N)) * 0.1, dev)
    before = predict_kernel.LAUNCHES.count
    got = vmap(lambda P_, x_: predict_kernel.predict(P_, x_, 1.0, 0.01,
                                                     0.02))(P, x)
    assert predict_kernel.LAUNCHES.count == before + 1
    _same(got, lambda b: predict_kernel.predict_cuda(P[b], x[b], 1.0, 0.01,
                                                     0.02))
    # a shared (unbatched) operand is expanded to every stream
    x_shared = x[0]
    got = vmap(lambda P_: predict_kernel.predict(P_, x_shared, 1.0, 0.01,
                                                 0.02))(P)
    _same(got, lambda b: predict_kernel.predict_cuda(P[b], x_shared, 1.0,
                                                     0.01, 0.02))
    s = star_kernel.StarSettings()
    grays = _frames(dev, 480, 640)
    ii = torch.stack([star._integral(g, star.integral_pad(s.max_size))
                      for g in grays])
    before = star_kernel.LAUNCHES.count
    got = vmap(lambda i: star_kernel.star_from_integral(i, 480, 640, s))(ii)
    assert star_kernel.LAUNCHES.count == before + 1
    _same(got, lambda b: star_kernel.star_cuda(ii[b], 480, 640, s))
    pattern = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(256, 33, 7), dev)
    smoothed = torch.stack([brief.smooth(g, 2.0) for g in grays])
    before = brief_kernel.LAUNCHES.count
    got = vmap(lambda im: torch.stack(brief_kernel.dense_planes(
        im, pattern)))(smoothed)
    assert brief_kernel.LAUNCHES.count == before + 1
    _same((got,), lambda b: (torch.stack(brief_kernel.dense_planes_cuda(
        smoothed[b], pattern)),))
