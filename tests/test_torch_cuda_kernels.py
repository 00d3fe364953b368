"""The four CUDA kernels against their float64 plain versions, on the card,
at shapes the main path does not reach: ragged tiles, one slot, several
blocks, and an S too large for shared memory (the update's device-memory
inverse).  ``chip_smoke.py`` checks the main path's shapes.

These tests need a CUDA device and skip without one.  This module imports
no JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.ops import (init_kernel, measure_kernel,
                                           predict_kernel, sinv,
                                           update_kernel)

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


@pytest.mark.parametrize("N", [13, 200, 1037])
def test_predict_kernel(dev, N):
    rng = np.random.default_rng(N)
    P, x = _f32(_spd(rng, N), dev), rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    x = _f32(x, dev)
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


@pytest.mark.parametrize("F", [1, 37, 300])
def test_measure_kernel(dev, F):
    cam7, feats, is_xyz, active = _measure_inputs(
        np.random.default_rng(F), F, dev)
    got = measure_kernel.measure(CAM, cam7, feats, is_xyz, active)
    ref = measure_kernel.measure_plain(CAM, cam7.double(), feats.double(),
                                       is_xyz, active)
    assert torch.equal(got[3], ref[3])
    m = ref[3]
    for a, b in zip(ref[:3], got[:3]):
        a, b = a[m], b[m].double()
        if a.numel():
            lim = 1e-6 * (a.abs() + max(float(a.abs().max()), 1.0))
            assert bool(((b - a).abs() <= lim).all())


@pytest.mark.parametrize("F,use_frac", [(1, 1.0), (8, 0.5), (96, 0.6),
                                        (130, 0.7), (130, 0.0)])
def test_update_kernel(dev, F, use_frac):
    """F = 130 gives 2F = 260, whose S (270 KB) exceeds shared memory."""
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
    x_k, P_k, Sinv_k = update_kernel.joint_update_cuda(*args, use, 1.0)
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
    inv = sinv.spd_inverse(S)
    assert _err(Sinv_k, inv) <= 1e-4 * float(inv.abs().max())


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


def test_wrappers_refuse_float64_cuda_tensors(dev):
    P = torch.eye(20, dtype=torch.float64, device=dev)
    x = torch.zeros(20, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        predict_kernel.predict(P, x, 1.0, 1e-6, 1e-6)
