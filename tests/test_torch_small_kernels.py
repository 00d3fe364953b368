"""The predict and measure kernels' plain versions, and the measurement
prediction around them, against the JAX package in float64.

- ``predict_plain`` against JAX ``filter/predict.predict`` at N = 13
  (the camera state alone), 19, 640 (the s3 map) and 1024 (the large
  map), to 1e-12.
- ``measure_plain``, which returns the masked Hc (F, 2, 13), Hf and uv the
  CUDA kernel writes, against JAX ``measurements_with_jacobians`` and
  ``visibility`` plus the JAX caller's epilogue
  (openekfmonoslam_tpu/filter/measure.py:151-158), at F = 1, 7, 96 and
  168, with both ``quirks`` values, on inverse-depth and XYZ slots,
  inactive slots, slots behind the camera or outside the image, and a
  slot whose camera-frame depth is below 1e-6 (the clamp), to 1e-9.
- The port's ``predict_measurements`` against JAX's on the same state
  (both ``quirks`` values and both H P layouts), to 1e-9.

The CUDA kernels themselves run only on a GPU
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.config import SlamConfig as JConfig
from openekfmonoslam_tpu.core.camera import Camera as JCamera
from openekfmonoslam_tpu.filter import measure as jmeas
from openekfmonoslam_tpu.filter import measure_fast as jmf
from openekfmonoslam_tpu.filter import predict as jpred
from openekfmonoslam_tpu.filter import state as jstate
from openekfmonoslam_tpu_torch.config import SlamConfig as TConfig
from openekfmonoslam_tpu_torch.core import quaternion as tquat
from openekfmonoslam_tpu_torch.core.camera import Camera as TCamera
from openekfmonoslam_tpu_torch.filter import measure as tmeas
from openekfmonoslam_tpu_torch.filter import state as tstate
from openekfmonoslam_tpu_torch.ops import measure_kernel, predict_kernel

JCAM = JCamera.from_calibration(JConfig().camera, jnp.float64)
TCAM = TCamera.from_calibration(TConfig().camera)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- predict

def _spd_state(rng, n):
    A = rng.standard_normal((n, 40))
    P = A @ A.T / 40 + 0.5 * np.eye(n)
    P = 0.5 * (P + P.T)
    x = rng.standard_normal(n) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    return P, x


@pytest.mark.parametrize("N", [13, 19, 640, 1024])
def test_predict_plain_matches_jax_predict(N):
    """predict_plain is JAX's predict in float64, at the camera state
    alone, a ragged N and the two shipped maps' N."""
    P, x = _spd_state(np.random.default_rng(N), N)
    x[10:13] *= 3.0                     # a visible rotation a frame
    cfg = JConfig()
    js = jstate.make_initial_state(cfg, jnp.float64)
    js = js._replace(x=jnp.asarray(x), P=jnp.asarray(P))
    want = jpred.predict(js, cfg)
    lin = cfg.ekf.linear_accel_sd ** 2
    ang = cfg.ekf.angular_accel_sd ** 2
    x_t, P_t = predict_kernel.predict_plain(torch.tensor(P), torch.tensor(x),
                                            1.0, lin, ang)
    np.testing.assert_allclose(_np(x_t), np.asarray(want.x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(_np(P_t), np.asarray(want.P), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(_np(P_t)[13:, 13:], P[13:, 13:])


# ---------------------------------------------------------------- measure

def _measure_scene(rng, F):
    """(feats, is_xyz, active, cam7): inverse-depth and XYZ slots in front
    of the camera, some behind it or off the image, about 10% inactive,
    and, for F >= 7, slot 3 an XYZ point on the camera plane (|z| < 1e-6,
    so the clamp to 1 applies)."""
    q = rng.standard_normal(4) * np.array([1.0, 0.05, 0.05, 0.05]) \
        + np.array([3.0, 0, 0, 0])
    q /= np.linalg.norm(q)
    cam7 = np.concatenate([rng.normal(0, 0.05, 3), q])
    feats = np.zeros((F, 6))
    feats[:, 0:3] = cam7[:3] + rng.normal(0, 0.05, (F, 3))
    feats[:, 3] = rng.uniform(-0.6, 0.6, F)
    feats[:, 4] = rng.uniform(-0.5, 0.5, F)
    feats[:, 5] = rng.uniform(0.1, 1.2, F)
    # a few bearings behind the camera or far off the image
    feats[rng.random(F) < 0.15, 3] += np.pi
    is_xyz = rng.random(F) < 0.35
    feats[is_xyz, 0:3] = rng.normal(0, 1.5, (is_xyz.sum(), 3)) + [0, 0, 4]
    feats[is_xyz, 3:] = 0.0
    active = rng.random(F) < 0.9
    if F >= 7:
        R = tquat.to_rotation_matrix(torch.tensor(q)).numpy()
        feats[3] = 0.0
        feats[3, 0:3] = cam7[:3] + R @ np.array([0.4, -0.2, 0.0])
        is_xyz[3], active[3] = True, True
    return feats, is_xyz, active, cam7


def _jax_masked(feats, is_xyz, active, cam7, quirks):
    """The JAX chain, then its caller's epilogue (filter/measure.py:
    151-158): the masked (uv, Hc, Hf, visible)."""
    c7, fe = jnp.asarray(cam7), jnp.asarray(feats)
    uv, Hc7, Hf = jmf.measurements_with_jacobians(JCAM, c7, fe, is_xyz,
                                                  quirks=quirks)
    visible = jmf.visibility(JCAM, c7, fe, is_xyz, active, uv)
    F = feats.shape[0]
    vis = visible[:, None, None].astype(jnp.float64)
    Hc = jnp.concatenate([Hc7 * vis, jnp.zeros((F, 2, 6), jnp.float64)],
                         axis=-1)
    Hf = Hf * vis
    first3 = jnp.arange(6) < 3
    feat_dim_mask = jnp.where(jnp.asarray(is_xyz)[:, None], first3[None, :],
                              True)
    Hf = Hf * feat_dim_mask[:, None, :].astype(jnp.float64)
    uv = jnp.where(visible[:, None], uv, 0.0)
    return [np.asarray(a) for a in (uv, Hc, Hf, visible)]


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("F", [1, 7, 96, 168])
def test_masked_measure_plain_matches_jax(F, quirks):
    feats, is_xyz, active, cam7 = _measure_scene(
        np.random.default_rng(F + 10 * quirks), F)
    want = _jax_masked(feats, is_xyz, active, cam7, quirks)
    got = measure_kernel.measure_plain(
        TCAM, torch.tensor(cam7), torch.tensor(feats), torch.tensor(is_xyz),
        torch.tensor(active), quirks=quirks)
    assert tuple(got[1].shape) == (F, 2, 13)
    np.testing.assert_array_equal(_np(got[3]), want[3])
    for a, b in zip(want[:3], got[:3]):
        assert np.isfinite(_np(b)).all()
        np.testing.assert_allclose(_np(b), a, rtol=1e-9, atol=1e-9)
    vis = want[3]
    if F >= 7:
        # the clamped slot, its XYZ retired dims and the zero columns
        assert not vis[3]
        assert not _np(got[1])[..., 7:].any()
        assert not _np(got[2])[is_xyz][..., 3:].any()
    if F >= 96:
        # the scene has every kind of slot
        assert 0 < vis.sum() < active.sum()
        assert (is_xyz & vis).any() and (~is_xyz & vis).any()


def test_measure_masks_keep_non_finite_values():
    """The masks multiply by 0 or 1, as the PyTorch chain does, so a
    non-finite value in a masked slot stays non-finite in Hc and Hf, and
    uv, which is selected, is 0 there."""
    feats, is_xyz, active, cam7 = _measure_scene(np.random.default_rng(4), 7)
    active[:] = False
    feats[0, 5] = np.inf                 # an inverse-depth slot: rho = inf
    is_xyz[0] = False
    uv, Hc, Hf, vis = measure_kernel.measure_plain(
        TCAM, torch.tensor(cam7), torch.tensor(feats), torch.tensor(is_xyz),
        torch.tensor(active))
    assert not _np(vis).any()
    assert not np.isfinite(_np(Hf)[0]).all()
    assert not _np(uv).any()
    assert np.isfinite(_np(Hc)[1:]).all() and not _np(Hc)[1:].any()


# ----------------------------------------------- predict_measurements

@pytest.mark.parametrize("layout", ["blocks", "dense"])
@pytest.mark.parametrize("quirks", [False, True])
def test_predict_measurements_matches_jax(quirks, layout):
    F = 24
    feats, is_xyz, active, cam7 = _measure_scene(np.random.default_rng(7), F)
    jc = JConfig(max_features=F)
    tc = TConfig(max_features=F)
    N = tc.padded_state_dim
    P, x = _spd_state(np.random.default_rng(8), N)
    x[:7] = cam7
    x[13:13 + 6 * F] = feats.reshape(-1)
    js = jstate.make_initial_state(jc, jnp.float64)._replace(
        x=jnp.asarray(x), P=jnp.asarray(P), active=jnp.asarray(active),
        is_xyz=jnp.asarray(is_xyz))
    ts = tstate.make_initial_state(tc, torch.float64, "cpu")._replace(
        x=torch.tensor(x), P=torch.tensor(P), active=torch.tensor(active),
        is_xyz=torch.tensor(is_xyz))
    want = jmeas.predict_measurements(js, JCAM, quirks=quirks,
                                      hp_layout=layout)
    got = tmeas.predict_measurements(ts, TCAM, quirks=quirks,
                                     hp_layout=layout)
    np.testing.assert_array_equal(_np(got.visible), np.asarray(want.visible))
    assert 0 < int(got.visible.sum()) < int(got.visible.numel())
    for name in ("uv", "Hc", "Hf", "S", "HP", "Sfull"):
        a, b = np.asarray(getattr(want, name)), _np(getattr(got, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9,
                                   err_msg=name)
