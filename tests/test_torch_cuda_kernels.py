"""The CUDA kernels against their plain versions, on the card, at shapes
the main path does not reach: ragged tiles, one slot, several blocks, an S
too large for shared memory (the device-memory factorization), the
predict kernel's scalar fallback (N % 4 != 0, an unaligned base), odd
frame sizes and other STAR and BRIEF settings (both STAR routes, both
BRIEF variants), the S-inverse from M = 1 to
3100 and cond 1e2 to 1e6, both measure variants at F = 1 to 513 with
their masks, and the blocked Cholesky solve from M = 1 to 640 and K = 1 to 1024
at cond 1e2 to 1e4.  The filter kernels are held against float64;
STAR and BRIEF must equal their float32 plain versions bit for bit.
``chip_smoke.py`` checks the main path's shapes.

These tests need a CUDA device and skip without one.  This module imports
no JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.ops import (brief_kernel, cholsolve,
                                           init_kernel, measure_kernel,
                                           predict_kernel, sinv, spd_core,
                                           star_kernel, update_kernel)
from openekfmonoslam_tpu_torch.vision import brief, star

pytestmark = pytest.mark.cuda

CFG = SlamConfig()
CAM = Camera.from_calibration(CFG.camera)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _f32(a, dev):
    return torch.tensor(a, dtype=torch.float32, device=dev)


def _spd(rng, n):
    A = rng.standard_normal((n, 40))
    P = A @ A.T / 40 + 0.5 * np.eye(n)
    return 0.5 * (P + P.T)


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("N,offset", [(13, 0), (19, 0), (200, 0), (640, 0),
                                      (640, 1), (645, 0), (1037, 0)])
def test_predict_kernel(dev, N, offset):
    """Both data paths: 16-byte vectors where N % 4 == 0 and the base is
    aligned (200, 640), scalars where N % 4 != 0 (13, 19, 645, 1037) or
    the base is not (640 at an offset of one float)."""
    rng = np.random.default_rng(N)
    P64, x = _spd(rng, N), rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    x = _f32(x, dev)
    buf = torch.zeros(N * N + offset, dtype=torch.float32, device=dev)
    P = buf[offset:].view(N, N)
    P.copy_(_f32(P64, dev))
    x_k, P_k = predict_kernel.predict(P, x, 1.0, 1e-6, 4e-6)
    x_t, P_t = predict_kernel.predict_plain(P.double(), x.double(), 1.0,
                                            1e-6, 4e-6)
    assert _err(x_k, x_t) <= 1e-6 and _err(P_k, P_t) <= 1e-4
    assert torch.equal(P_k[13:, 13:], P[13:, 13:])
    assert torch.equal(P_k, P_k.T)


def _measure_inputs(rng, F, dev):
    feats = np.zeros((F, 6))
    feats[:, 3] = rng.normal(0, 0.3, F)
    feats[:, 4] = rng.normal(0, 0.2, F)
    feats[:, 5] = rng.uniform(0.2, 1.5, F)
    feats[:, 0:3] = rng.normal(0, 0.05, (F, 3))
    is_xyz = rng.random(F) < 0.3
    feats[is_xyz, 0:3] = rng.normal(0, 0.5, (is_xyz.sum(), 3)) + [0, 0, 3]
    feats[is_xyz, 3:] = 0
    q = np.array([1.0, 0.02, -0.03, 0.01])
    cam7 = np.concatenate([rng.normal(0, 0.02, 3), q / np.linalg.norm(q)])
    return (_f32(cam7, dev), _f32(feats, dev),
            torch.tensor(is_xyz, device=dev),
            torch.tensor(rng.random(F) < 0.9, device=dev))


def _check_measure(got, ref, is_xyz):
    """The kernel's masked outputs against the float64 plain version's:
    visibility equal, the visible slots within 1e-6 relative, and the
    masks exact (invisible slots, Hc's columns 7:13 and the retired dims
    of XYZ slots are 0)."""
    assert torch.equal(got[3], ref[3])
    m = ref[3]
    assert got[1].shape == ref[1].shape == (m.numel(), 2, 13)
    for a, b in zip(ref[:3], got[:3]):
        assert not b[~m].any()
        a, b = a[m], b[m].double()
        if a.numel():
            lim = 1e-6 * (a.abs() + max(float(a.abs().max()), 1.0))
            assert bool(((b - a).abs() <= lim).all())
    assert not got[1][..., 7:].any()
    assert not got[2][is_xyz][..., 3:].any()


@pytest.mark.parametrize("F", [1, 33, 37, 168, 300, 513])
def test_measure_kernel(dev, F):
    cam7, feats, is_xyz, active = _measure_inputs(
        np.random.default_rng(F), F, dev)
    got = measure_kernel.measure(CAM, cam7, feats, is_xyz, active)
    ref = measure_kernel.measure_plain(CAM, cam7.double(), feats.double(),
                                       is_xyz, active)
    _check_measure(got, ref, is_xyz)


@pytest.mark.parametrize("F", [1, 7, 33, 96, 168, 513])
def test_measure_kernel_quirks_variant(dev, F):
    """The QUIRKS instantiation against the float64 plain quirks chain, to
    the measure bound (1e-6 relative); it counts as a quirks launch."""
    cam7, feats, is_xyz, active = _measure_inputs(
        np.random.default_rng(F + 1), F, dev)
    measure_kernel.LAUNCHES.reset()
    measure_kernel.QUIRKS_LAUNCHES.reset()
    got = measure_kernel.measure(CAM, cam7, feats, is_xyz, active,
                                 quirks=True)
    assert (measure_kernel.LAUNCHES.count,
            measure_kernel.QUIRKS_LAUNCHES.count) == (0, 1)
    ref = measure_kernel.measure_plain(CAM, cam7.double(), feats.double(),
                                       is_xyz, active, quirks=True)
    correct = measure_kernel.measure_plain(CAM, cam7.double(),
                                           feats.double(), is_xyz, active)
    _check_measure(got, ref, is_xyz)
    m = ref[3]
    if int(m.sum()) > 1:        # the variant differs from the correct math
        assert not torch.allclose(ref[1][m], correct[1][m], rtol=0,
                                  atol=1e-9)


def spd_plus(rng, m, scale=10.0):
    """tests/test_cholsolve.py ``_spd``: A A^T + scale I."""
    A = rng.normal(size=(m, m)).astype(np.float32)
    return A @ A.T + scale * np.eye(m, dtype=np.float32)


def _solve_rel_err(X, S, B):
    want = torch.linalg.solve(S.double(), B.double())
    return _err(X, want) / float(want.abs().max())


@pytest.mark.parametrize("M,K", [(1, 1), (7, 3), (48, 200), (64, 128),
                                 (65, 1), (192, 640), (336, 1024),
                                 (640, 1000)])
@pytest.mark.parametrize("cond", [1e2, 1e3, 1e4])
def test_cholsolve_kernel(dev, M, K, cond):
    """The spd_cond matrices within 1e-6 cond relative of the float64
    solve, and A A^T + 10 I within the JAX kernel test's 1e-4."""
    rng = np.random.default_rng(M + K)
    B = _f32(rng.normal(size=(M, K)), dev)
    S = _f32(spd_cond(M, cond), dev)
    cholsolve.LAUNCHES.reset()
    X = cholsolve.chol_solve_cuda(S, B)
    torch.cuda.synchronize()
    assert cholsolve.LAUNCHES.count == 1
    assert X.shape == (M, K) and bool(torch.isfinite(X).all())
    assert _solve_rel_err(X, S, B) <= 1e-6 * cond
    S2 = _f32(spd_plus(rng, M), dev)
    assert _solve_rel_err(cholsolve.chol_solve_cuda(S2, B), S2, B) <= 1e-4


def test_solve_spd_routes(dev):
    """A CUDA float32 S launches the kernel; float64, or force_kernel=False,
    takes the library Cholesky solve."""
    rng = np.random.default_rng(0)
    S = _f32(spd_plus(rng, 96), dev)
    B = _f32(rng.normal(size=(96, 40)), dev)
    cholsolve.LAUNCHES.reset()
    X = cholsolve.solve_spd(S, B)
    assert cholsolve.LAUNCHES.count == 1
    assert _solve_rel_err(X, S, B) <= 1e-4
    cholsolve.solve_spd(S.double(), B.double())
    cholsolve.solve_spd(S, B, force_kernel=False)
    assert cholsolve.LAUNCHES.count == 1
    with pytest.raises(ValueError, match="float32"):
        cholsolve.chol_solve_cuda(S.double(), B.double())


@pytest.mark.parametrize("F,use_frac", [(1, 1.0), (8, 0.5), (96, 0.6),
                                        (96, 1.0), (130, 0.7), (130, 0.0),
                                        (260, 1.0), (723, 1.0)])
def test_update_kernel(dev, F, use_frac):
    """Against the float64 chain, with the factor the update used: L L^T
    equals the masked S.  2F = 520 rows all used factor in device memory
    (their packed triangle exceeds shared memory); at 2F = 1446 the solve's
    slabs also move to device memory."""
    rng = np.random.default_rng(F)
    N = 13 + 6 * F
    P = _spd(rng, N)
    H = rng.standard_normal((2 * F, N)) * 0.05
    HP = H @ P
    x = rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    uv = rng.uniform(0, 600, (F, 2))
    args = [_f32(a, dev) for a in (P, x, HP, HP @ H.T, uv,
                                   uv + rng.standard_normal((F, 2)))]
    use = torch.tensor(rng.uniform(size=F) < use_frac, device=dev)
    x_k, P_k, factor = update_kernel.joint_update_cuda(*args, use, 1.0)
    if use_frac == 0.0:
        assert torch.equal(x_k, args[1]) and torch.equal(P_k, args[0])
        return
    d = [a.double() for a in args]
    x_t, P_t = update_kernel.update_plain(*d, use, 1.0)
    assert _err(x_k, x_t) <= 5e-5 and _err(P_k, P_t) <= 5e-4
    assert torch.equal(P_k, P_k.T)
    u2 = use[:, None].expand(-1, 2).reshape(-1).double()
    # the masked S with r = 1 on every row: pixel_error 1.0 on used rows,
    # 1.0 on unused ones
    S = d[3] * (u2[:, None] * u2[None, :]) + torch.eye(
        2 * F, dtype=torch.float64, device=dev)
    L = spd_core.dense_factor(factor, 2 * F)
    assert int(factor.meta[0]) == int(u2.sum())
    assert int(factor.meta[1]) == 0
    assert _err(L @ L.T, S) <= 1e-4 * float(S.abs().max())


@pytest.mark.parametrize("C", [1, 200])
def test_init_kernel(dev, C):
    rng = np.random.default_rng(C)
    q = rng.standard_normal(4)
    cam7 = _f32(np.concatenate([rng.normal(0, 0.1, 3),
                                q / np.linalg.norm(q)]), dev)
    uv = _f32(rng.uniform(20, 600, (C, 2)), dev)
    got = init_kernel.init_chain(CAM, cam7, uv, 1.0)
    ref = init_kernel.init_plain(CAM, cam7.double(), uv.double(), 1.0)
    for a, b, tol in zip(got, ref, (1e-5, 2e-2, 1e-4)):
        assert a.shape == b.shape and _err(a, b) <= tol


def spd_cond(m, cond, seed=0):
    """tests/test_sinv.py ``_spd``: eigenvalues geomspace(1, cond)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    s = (q * np.geomspace(1.0, cond, m)) @ q.T
    return ((s + s.T) / 2).astype(np.float32)


def masked_s(m, seed=1):
    """tests/test_sinv.py's masked S: identity rows for unused slots."""
    rng = np.random.default_rng(seed)
    used = rng.random(m) < 0.6
    h = rng.normal(size=(m, 30)) * 3.0
    s = np.zeros((m, m), np.float32)
    s[np.ix_(used, used)] = (h @ h.T)[np.ix_(used, used)]
    s[np.diag_indices(m)] += 1.0
    return s


def _sinv_rel_err(x, s):
    want = torch.linalg.inv(s.double())
    return _err(x, want) / float(want.abs().max())


@pytest.mark.parametrize("M", [1, 7, 192, 336, 640])
@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6])
def test_sinv_kernel(dev, M, cond):
    """Relative error against the float64 inverse within the TPU kernel
    test's bound, 3e-5 max(cond / 1e2, 1), and no non-positive pivot.  At
    M = 640 the packed triangle exceeds shared memory and the
    factorization runs in device memory."""
    S = _f32(spd_cond(M, cond), dev)
    X, info = sinv.sinv_cuda(S)
    torch.cuda.synchronize()
    assert X.shape == (M, M) and bool(torch.isfinite(X).all())
    assert _sinv_rel_err(X, S) <= 3e-5 * max(cond / 1e2, 1.0)
    assert int(info) == 0


@pytest.mark.parametrize("M", [192, 336])
def test_sinv_kernel_masked_identity_rows(dev, M):
    S = _f32(masked_s(M), dev)
    X, info = sinv.sinv_cuda(S)
    assert _sinv_rel_err(X, S) <= 1e-4
    assert int(info) == 0
    # the identity rows and columns of S are those of S^-1, exactly
    eye = torch.eye(M, device=dev)
    off = S != eye
    ident = ~(off.any(dim=1) | off.any(dim=0))
    assert bool(ident.any())
    assert torch.equal(X[ident], eye[ident])
    assert torch.equal(X[:, ident], eye[:, ident])


def test_sinv_kernel_beyond_shared_memory(dev):
    """M = 3100: the solve's slabs of 8 identity columns no longer fit its
    shared memory and move to device memory."""
    S = _f32(spd_cond(3100, 1e2), dev)
    X, info = sinv.sinv_cuda(S)
    assert _sinv_rel_err(X, S) <= 3e-5 and int(info) == 0


def test_sinv_kernel_counts_a_non_positive_pivot(dev):
    """An S that is not positive definite: the kernels still launch and
    run, and info counts the failed pivot."""
    S = _f32(spd_cond(64, 1e2), dev)
    S[10, 10] = -5.0
    _, info = sinv.sinv_cuda(S)
    assert int(info) >= 1


def test_spd_inverse_routes_large_s_to_cholesky(dev):
    S = _f32(spd_cond(600, 1e2), dev)
    sinv.LAUNCHES.reset()
    X = sinv.spd_inverse(S, 1.0)
    assert sinv.LAUNCHES.count == 0
    assert _sinv_rel_err(X, S) <= 1e-4
    sinv.spd_inverse(S[:336, :336].contiguous(), 1.0)
    assert sinv.LAUNCHES.count == 1


def test_update_chain_at_the_large_map(dev):
    """N = 1024, 2F = 336: update() takes the chain with the S-inverse
    kernel (no fused launch); both routes agree with float64."""
    from openekfmonoslam_tpu_torch.filter import update as upd
    F, N = 168, 1024
    rng = np.random.default_rng(3)
    P = _spd(rng, N)
    H = rng.standard_normal((2 * F, N)) * 0.05
    HP = H @ P
    x = rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    uv = rng.uniform(0, 600, (F, 2))
    args = [_f32(a, dev) for a in (P, x, HP, HP @ H.T, uv,
                                   uv + rng.standard_normal((F, 2)))]
    use = torch.tensor(rng.uniform(size=F) < 0.6, device=dev)
    assert not update_kernel.update_kernel_applicable(args[0], args[2])
    x_t, P_t = update_kernel.update_plain(*[a.double() for a in args], use,
                                          1.0)
    sinv.LAUNCHES.reset()
    update_kernel.LAUNCHES.reset()
    x_c, P_c = upd.update_chain(*args, use, 1.0)
    assert (sinv.LAUNCHES.count, update_kernel.LAUNCHES.count) == (1, 0)
    x_f, P_f = update_kernel.joint_update(*args, use, 1.0)
    for xk, Pk in ((x_c, P_c), (x_f, P_f)):
        assert _err(xk, x_t) <= 5e-5 and _err(Pk, P_t) <= 5e-4


def test_wrappers_refuse_float64_cuda_tensors(dev):
    P = torch.eye(20, dtype=torch.float64, device=dev)
    x = torch.zeros(20, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        predict_kernel.predict(P, x, 1.0, 1e-6, 1e-6)
    with pytest.raises(ValueError, match="float32"):
        sinv.sinv_cuda(P)


def _gray(rng, h, w, dev):
    img = rng.integers(0, 30, (h, w))
    for _ in range(h * w // 80):
        y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(1, 6)
        img[max(y - r, 0):y + r, max(x - r, 0):x + r] = rng.integers(60, 256)
    return torch.tensor(img, dtype=torch.uint8, device=dev)


@pytest.mark.parametrize("h,w,settings", [
    (483, 645, star_kernel.StarSettings()),
    (480, 640, star_kernel.StarSettings(nms_radius=3)),
    (37, 50, star_kernel.StarSettings(max_size=4, response_threshold=5.0,
                                      nms_radius=1)),
    (200, 131, star_kernel.StarSettings(max_size=45, line_threshold=6.0)),
    (5, 7, star_kernel.StarSettings(response_threshold=1.0)),
    (150, 170, star_kernel.StarSettings(max_size=32, response_threshold=5.0)),
    (150, 170, star_kernel.StarSettings(max_size=64, response_threshold=5.0,
                                        nms_radius=1)),
    (100, 150, star_kernel.StarSettings(response_threshold=5.0,
                                        nms_radius=5))])
@pytest.mark.parametrize("route", ["planned", "direct"])
def test_star_kernel(dev, h, w, settings, route):
    """One launch a call, by the planned route (staged up to max size 44,
    direct from 45) and by the direct route forced, bit for bit; NMS radius
    5 takes the row max's own pass."""
    gray = _gray(np.random.default_rng(h), h, w, dev)
    ii = star._integral(gray, star.integral_pad(settings.max_size))
    planned = star_kernel.star_plan(settings)[0]
    assert planned == ("direct" if settings.max_size >= 45 else "staged")
    route = planned if route == "planned" else route
    star_kernel.LAUNCHES.reset()
    star_kernel.DIRECT_LAUNCHES.reset()
    raw, nms = star_kernel.star_cuda(ii, h, w, settings, route)
    assert (star_kernel.LAUNCHES.count, star_kernel.DIRECT_LAUNCHES.count) \
        == ((1, 0) if route == "staged" else (0, 1))
    raw_p, nms_p = star_kernel.star_plain(ii, h, w, settings)
    assert torch.equal(raw, raw_p) and torch.equal(nms, nms_p)
    if h * w > 100:
        assert int((nms > 0).sum()) > 0


def test_star_kernel_refuses_staged_where_it_does_not_fit(dev):
    s = star_kernel.StarSettings(max_size=64)
    ii = torch.zeros((20 + 2 * 129 + 1, 20 + 2 * 129 + 1), device=dev)
    with pytest.raises(ValueError, match="route"):
        star_kernel.star_cuda(ii, 20, 20, s, "staged")


@pytest.mark.parametrize("h,w,n_bits,patch", [
    (483, 645, 256, 33), (480, 640, 256, 33), (50, 70, 256, 15),
    (301, 97, 256, 33), (483, 645, 128, 33), (480, 640, 512, 33),
    (97, 130, 256, 49), (70, 66, 512, 15)])
@pytest.mark.parametrize("variant", ["own", "generic"])
def test_brief_kernel(dev, h, w, n_bits, patch, variant):
    """Each pattern by its own variant (s256 for the shipped one) and by
    the generic variant, bit for bit, one launch a call."""
    smoothed = brief.smooth(_gray(np.random.default_rng(w), h, w, dev))
    pattern = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(n_bits, patch), dev)
    variant = pattern.variant if variant == "own" else variant
    brief_kernel.LAUNCHES.reset()
    brief_kernel.GENERIC_LAUNCHES.reset()
    got = brief_kernel.dense_planes_cuda(smoothed, pattern, variant)
    assert (brief_kernel.LAUNCHES.count,
            brief_kernel.GENERIC_LAUNCHES.count) == (
        (1, 0) if variant == "s256" else (0, 1))
    want = brief_kernel.dense_planes_plain(smoothed, pattern)
    assert len(got) == len(want) == n_bits // 32
    for a, b in zip(got, want):
        assert a.shape == (h - 2 * pattern.half, w - 2 * pattern.half)
        assert torch.equal(a, b)


def test_brief_kernel_refuses_what_it_does_not_take(dev):
    smoothed = torch.zeros((100, 100), device=dev)
    other = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(256, 15), dev)
    with pytest.raises(ValueError, match="s256"):
        brief_kernel.dense_planes_cuda(smoothed, other, "s256")
    wide = brief_kernel.BriefPattern.make(
        *brief.make_shared_pattern(1024, 33), dev)
    with pytest.raises(ValueError, match="512"):
        brief_kernel.dense_planes_cuda(smoothed, wide)
