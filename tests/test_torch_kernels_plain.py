"""The plain PyTorch versions of the CUDA kernels against the JAX
functions their TPU kernels replace, and the wrapper rules (the STAR and
BRIEF plain versions are held against JAX in tests/test_torch_vision.py).

Each ``*_plain`` is compared with the JAX package's CPU chain (the XLA
path its TPU-gated kernel dispatch falls back to) on the same numpy
inputs: in float64 to 1e-10, and in float32 within the bounds of the JAX
kernel tests (tests/test_update_kernel.py, tests/test_measure_kernel.py).
The CUDA kernels themselves run only on a GPU (chip_smoke.py); here the
tests check that a CPU tensor takes the plain path without counting a
launch, and that a CUDA launch function refuses CPU tensors instead of
falling back.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu.config import CameraCalibration as JCal
from openekfmonoslam_tpu.config import SlamConfig as JConfig
from openekfmonoslam_tpu.core.camera import Camera as JCamera
from openekfmonoslam_tpu.filter import features as jfeat
from openekfmonoslam_tpu.filter import measure_fast as jmf
from openekfmonoslam_tpu.filter import predict as jpred
from openekfmonoslam_tpu.filter import ransac as jransac
from openekfmonoslam_tpu.filter import update as jupd
from openekfmonoslam_tpu.filter.measure import Prediction as JPrediction
from openekfmonoslam_tpu.filter.state import SlamState as JState
from openekfmonoslam_tpu_torch.config import CameraCalibration as TCal
from openekfmonoslam_tpu_torch.config import SlamConfig as TConfig
from openekfmonoslam_tpu_torch.core.camera import Camera as TCamera
from openekfmonoslam_tpu_torch.engine import step as tstep
from openekfmonoslam_tpu_torch.filter import measure as tmeas
from openekfmonoslam_tpu_torch.filter import ransac as transac
from openekfmonoslam_tpu_torch.filter.state import SlamState as TState
from openekfmonoslam_tpu_torch.ops import (brief_kernel, cuda_lib,
                                           init_kernel, measure_kernel,
                                           predict_kernel, ransac_kernel,
                                           sinv, spd_core, star_kernel,
                                           update_kernel)
from openekfmonoslam_tpu_torch.vision import brief as tbrief
from openekfmonoslam_tpu_torch.vision import star as tstar

N, F = 128, 16
KERNELS = (predict_kernel, measure_kernel, update_kernel, init_kernel,
           star_kernel, brief_kernel, ransac_kernel)
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


def _np(t):
    return t.detach().cpu().numpy()


def _state_arrays(rng):
    P0 = rng.standard_normal((N, 40))
    P = P0 @ P0.T / 40 + 0.5 * np.eye(N)
    x = rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    return P, x


def _jax_state(P, x, dtype):
    return JState(x=jnp.asarray(x, dtype), P=jnp.asarray(P, dtype),
                  active=jnp.ones(F, bool), is_xyz=jnp.zeros(F, bool),
                  times_predicted=jnp.zeros(F, jnp.int32),
                  times_matched=jnp.zeros(F, jnp.int32),
                  descriptors=jnp.zeros((F, 8), jnp.uint32),
                  patch_pose=jnp.zeros((F, 7), jnp.float32),
                  birth=jnp.zeros(F, jnp.int32),
                  rng=jax.random.PRNGKey(0), frame=jnp.int32(0))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_predict_plain_matches_jax_chain(dtype):
    jd, td = DTYPES[dtype]
    P, x = _state_arrays(np.random.default_rng(1))
    cfg = JConfig()
    ref = jpred.predict(_jax_state(P, x, jd), cfg)
    lin = cfg.ekf.linear_accel_sd ** 2
    ang = cfg.ekf.angular_accel_sd ** 2
    xg, Pg = predict_kernel.predict_plain(torch.tensor(P, dtype=td),
                                          torch.tensor(x, dtype=td), 1.0,
                                          lin, ang)
    tol = 1e-10 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(_np(Pg), np.asarray(ref.P), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(xg), np.asarray(ref.x), rtol=0,
                               atol=1e-10 if dtype == "float64" else 1e-6)
    # rows/cols >= 13 pass through bit-exactly
    np.testing.assert_array_equal(_np(Pg)[13:, 13:],
                                  P.astype(_np(Pg).dtype)[13:, 13:])


def _measure_scene(rng):
    feats = np.zeros((F, 6))
    feats[:, 0:3] = rng.normal(0, 0.05, (F, 3))
    feats[:, 3] = rng.uniform(-0.5, 0.5, F)
    feats[:, 4] = rng.uniform(-0.4, 0.4, F)
    feats[:, 5] = rng.uniform(0.1, 1.0, F)
    is_xyz = rng.random(F) < 0.3
    feats[is_xyz, 0:3] = rng.normal(0, 1, (is_xyz.sum(), 3)) + [0, 0, 4]
    feats[is_xyz, 3:] = 0.0
    active = rng.random(F) < 0.9
    q = np.array([1.0, 0.02, -0.03, 0.01])
    cam7 = np.concatenate([rng.normal(0, 0.02, 3), q / np.linalg.norm(q)])
    return feats, is_xyz, active, cam7


def _check_masks(visible, is_xyz, uv, Hc, Hf):
    """measure_plain's masks (openekfmonoslam_tpu/filter/measure.py:
    151-158): invisible slots all zero, Hc's columns 7:13 zero, the
    retired dims of visible XYZ slots zero.  The visible slots' values
    are compared with the unmasked JAX chain, with Hf's retired dims of
    XYZ slots, which that chain already computes as 0."""
    for t in (uv, Hc, Hf):
        assert not _np(t)[~visible].any()
    assert not _np(Hc)[..., 7:].any()
    assert not _np(Hf)[is_xyz][..., 3:].any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_measure_plain_matches_jax_chain(dtype):
    jd, td = DTYPES[dtype]
    feats, is_xyz, active, cam7 = _measure_scene(np.random.default_rng(2))
    jc = JCamera.from_calibration(JCal(), jd)
    tc = TCamera.from_calibration(TCal())
    uv1, Hc1, Hf1 = jmf.measurements_with_jacobians(
        jc, jnp.asarray(cam7, jd), jnp.asarray(feats, jd), is_xyz)
    vis1 = jmf.visibility(jc, jnp.asarray(cam7, jd), jnp.asarray(feats, jd),
                          is_xyz, active, uv1)
    uv2, Hc2, Hf2, vis2 = measure_kernel.measure_plain(
        tc, torch.tensor(cam7, dtype=td), torch.tensor(feats, dtype=td),
        torch.tensor(is_xyz), torch.tensor(active))
    np.testing.assert_array_equal(_np(vis2), np.asarray(vis1))
    assert _np(vis2).sum() >= F // 2
    m = np.asarray(vis1)
    _check_masks(m, is_xyz, uv2, Hc2, Hf2)
    for a, b in ((uv1, uv2), (Hc1, Hc2[..., :7]), (Hf1, Hf2)):
        a, b = np.asarray(a)[m], _np(b)[m]
        if dtype == "float64":
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=1e-6 * max(np.abs(a).max(), 1.0))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_measure_plain_quirks_matches_jax_chain(dtype):
    """The quirks flag of ``measure``: its plain version is the JAX quirks
    chain, and a CPU tensor takes it without a launch of either variant."""
    jd, td = DTYPES[dtype]
    feats, is_xyz, active, cam7 = _measure_scene(np.random.default_rng(6))
    jc = JCamera.from_calibration(JCal(), jd)
    tc = TCamera.from_calibration(TCal())
    want = jmf.measurements_with_jacobians(
        jc, jnp.asarray(cam7, jd), jnp.asarray(feats, jd), is_xyz,
        quirks=True)
    args = (tc, torch.tensor(cam7, dtype=td), torch.tensor(feats, dtype=td),
            torch.tensor(is_xyz), torch.tensor(active))
    measure_kernel.LAUNCHES.reset()
    measure_kernel.QUIRKS_LAUNCHES.reset()
    got = measure_kernel.measure(*args, quirks=True)
    for a, b in zip(got, measure_kernel.measure_plain(*args, quirks=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (measure_kernel.LAUNCHES.count,
            measure_kernel.QUIRKS_LAUNCHES.count) == (0, 0)
    m = _np(got[3])
    assert m.sum() >= F // 2
    _check_masks(m, is_xyz, *got[:3])
    for a, b in zip(want, (got[0], got[1][..., :7], got[2])):
        a, b = np.asarray(a)[m], _np(b)[m]
        if dtype == "float64":
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=1e-6 * max(np.abs(a).max(), 1.0))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        measure_kernel.measure_cuda(*args, quirks=True)
    assert measure_kernel.QUIRKS_LAUNCHES.count == 0


def _update_problem(rng, use_frac):
    P, x = _state_arrays(rng)
    H = rng.standard_normal((2 * F, N)) * 0.05
    HP = H @ P
    Sfull = HP @ H.T
    uv = rng.uniform(0, 600, (F, 2))
    z = uv + rng.standard_normal((F, 2))
    use = rng.uniform(size=F) < use_frac
    return P, x, HP, Sfull, uv, z, use


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("use_frac", [0.6, 0.0])
def test_update_plain_matches_jax_chain(dtype, use_frac):
    jd, td = DTYPES[dtype]
    P, x, HP, Sfull, uv, z, use = _update_problem(np.random.default_rng(0),
                                                  use_frac)
    pred = JPrediction(uv=jnp.asarray(uv, jd), visible=jnp.asarray(use),
                       Hc=jnp.zeros((F, 2, 13), jd),
                       Hf=jnp.zeros((F, 2, 6), jd), S=jnp.zeros((F, 2, 2), jd),
                       HP=jnp.asarray(HP, jd), Sfull=jnp.asarray(Sfull, jd))
    ref = jupd.update(_jax_state(P, x, jd), pred, jnp.asarray(z, jd),
                      jnp.asarray(use), 1.0)
    args = [torch.tensor(a, dtype=td) for a in (P, x, HP, Sfull, uv, z)]
    xg, Pg = update_kernel.update_plain(*args, torch.tensor(use), 1.0)
    if use_frac == 0.0:
        # no applied match: exact pass-through
        np.testing.assert_array_equal(_np(xg), _np(args[1]))
        np.testing.assert_array_equal(_np(Pg), _np(args[0]))
        np.testing.assert_array_equal(np.asarray(ref.P), _np(Pg))
        return
    xt, Pt = (1e-10, 1e-10) if dtype == "float64" else (5e-5, 5e-4)
    np.testing.assert_allclose(_np(xg), np.asarray(ref.x), rtol=0, atol=xt)
    np.testing.assert_allclose(_np(Pg), np.asarray(ref.P), rtol=0, atol=Pt)
    Pn = _np(Pg)
    np.testing.assert_allclose(Pn, Pn.T, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_init_plain_matches_jax_jacfwd(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    C = 24
    q = rng.standard_normal(4)
    cam7 = np.concatenate([rng.normal(0, 0.1, 3), q / np.linalg.norm(q)])
    uv = rng.uniform(20, 600, (C, 2))
    rho0 = 1.0
    jc = JCamera.from_calibration(JCal(), jd)
    c7 = jnp.asarray(cam7, jd)

    def feat_and_jacs(uvi):
        uv_rho = jnp.concatenate([uvi, jnp.asarray([rho0], jd)])
        f = jfeat.init_feature(jc, c7, uv_rho)
        J1 = jax.jacfwd(lambda c: jfeat.init_feature(jc, c, uv_rho))(c7)
        J2 = jax.jacfwd(lambda m: jfeat.init_feature(jc, c7, m))(uv_rho)
        return f, J1, J2

    f_r, J1_r, J2_r = jax.vmap(feat_and_jacs)(jnp.asarray(uv, jd))
    f_k, J1_k, J2_k = init_kernel.init_plain(
        TCamera.from_calibration(TCal()), torch.tensor(cam7, dtype=td),
        torch.tensor(uv, dtype=td), rho0)
    assert (f_k.shape, J1_k.shape, J2_k.shape) == ((C, 6), (C, 6, 7),
                                                  (C, 6, 3))
    if dtype == "float64":
        for a, b in ((f_r, f_k), (J1_r, J1_k), (J2_r, J2_k)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-10,
                                       atol=1e-10)
        return
    np.testing.assert_allclose(_np(f_k), np.asarray(f_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(J1_k), np.asarray(J1_r), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(_np(J2_k), np.asarray(J2_r), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("cond", ["moderate", "high"])
def test_sinv_plain_inverses(cond):
    rng = np.random.default_rng(4)
    M = 32
    A = rng.standard_normal((M, M))
    S = A @ A.T / M + np.eye(M)
    if cond == "high":          # exercises the Newton-Schulz rescue branch
        S = S + np.diag(np.geomspace(1.0, 1e5, M))
    St = torch.tensor(S)
    ref = np.linalg.inv(S)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(_np(sinv.spd_inverse(St)), ref, rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(_np(sinv.ns_inverse(St, lam_floor=1.0)), ref,
                               rtol=0, atol=1e-9 * scale)


def _ransac_problem(rng):
    """A RANSAC frame on the s3 camera: the state with _measure_scene's
    slots in x, the prediction's uv (visible slots), a small H P and an
    SPD S per slot, matches 0.7 px off with two outliers 30 px off."""
    P, x = _state_arrays(rng)
    feats, is_xyz, active, cam7 = _measure_scene(rng)
    x[:7] = cam7
    x[13:13 + 6 * F] = feats.reshape(-1)
    cam = TCamera.from_calibration(TCal())
    uv, _, _, vis = measure_kernel.measure_plain(
        cam, torch.tensor(cam7), torch.tensor(feats), torch.tensor(is_xyz),
        torch.tensor(active))
    uv, vis = _np(uv), _np(vis)
    HP = rng.standard_normal((2 * F, N)) * 2e-3
    A = rng.standard_normal((F, 2, 2))
    S = A @ A.transpose(0, 2, 1) + np.eye(2)
    z = uv + rng.normal(scale=0.7, size=(F, 2))
    z[[1, 4]] += 30.0
    matched = vis & (rng.random(F) < 0.9)
    return dict(x=x, HP=HP, S=S, z=z, uv=uv, matched=matched,
                active=active, is_xyz=is_xyz)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("deadband", [False, True])
def test_support_plain_is_the_two_step_chain(dtype, deadband):
    """``support_plain`` is filter/ransac.py's two steps composed, bit for
    bit, and the JAX package's: masks and support equal (in float32
    outside the slots whose float64 distance lies within 1e-3 px of the
    threshold)."""
    jd, td = DTYPES[dtype]
    pr = _ransac_problem(np.random.default_rng(7))
    cam = TCamera.from_calibration(TCal())
    t = {k: torch.tensor(v, dtype=td if v.dtype.kind == "f" else None)
         for k, v in pr.items()}
    thr, pe = 1.0, 1.0
    got = ransac_kernel.support_plain(
        cam, t["x"], t["HP"], t["S"], t["z"], t["uv"], t["matched"],
        t["active"], t["is_xyz"], pe, thr, deadband)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert int(got[0].max()) >= 3
    state = TState(x=t["x"], P=None, active=t["active"],
                   is_xyz=t["is_xyz"], times_predicted=None,
                   times_matched=None, descriptors=None, patch_pose=None,
                   birth=None, rng=None, frame=None)
    pred = tmeas.Prediction(uv=t["uv"], visible=t["matched"], Hc=None,
                            Hf=None, S=t["S"], HP=t["HP"], Sfull=None)
    states_x = transac._batched_state_only_updates(
        state, pred, t["z"], t["matched"], pe, deadband=deadband)
    want = transac._support_counts(states_x, state, cam, t["z"],
                                   t["matched"], thr)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    js = _jax_state(np.eye(N), pr["x"], jd)._replace(
        active=jnp.asarray(pr["active"]), is_xyz=jnp.asarray(pr["is_xyz"]))
    jp = JPrediction(uv=jnp.asarray(pr["uv"], jd), visible=None, Hc=None,
                     Hf=None, S=jnp.asarray(pr["S"], jd),
                     HP=jnp.asarray(pr["HP"], jd), Sfull=None)
    jc = JCamera.from_calibration(JCal(), jd)
    jx = jransac._batched_state_only_updates(
        js, jp, jnp.asarray(pr["z"], jd), pr["matched"], pe,
        deadband=deadband)
    j_sup, j_good = jransac._support_counts(jx, js, jc,
                                            jnp.asarray(pr["z"], jd),
                                            pr["matched"], thr)
    good = _np(got[1])
    if dtype == "float32":
        x64 = ransac_kernel.hypotheses_plain(
            *(torch.tensor(pr[k]) for k in ("x", "HP", "S", "z", "uv")),
            torch.tensor(pr["matched"]), pe, deadband)
        uv64 = tmeas.measure_one(cam, x64[:, None, :7],
                                 x64[:, 13:13 + 6 * F].reshape(-1, F, 6),
                                 torch.tensor(pr["is_xyz"])[None])
        dist = np.linalg.norm(pr["z"][None] - _np(uv64), axis=-1)
        edge = np.abs(dist - thr) < 1e-3
    else:
        edge = np.zeros_like(good)
    np.testing.assert_array_equal(good[~edge], np.asarray(j_good)[~edge])
    if not edge.any():
        np.testing.assert_array_equal(_np(got[0]), np.asarray(j_sup))


# ------------------------------------------------------------- wrappers

def _wrapper_inputs():
    rng = np.random.default_rng(5)
    P, x, HP, Sfull, uv, z, use = _update_problem(rng, 0.5)
    feats, is_xyz, active, cam7 = _measure_scene(rng)
    r = _ransac_problem(rng)
    cam = TCamera.from_calibration(TCal())
    t = torch.tensor
    gray = torch.tensor(rng.integers(0, 256, (45, 61)), dtype=torch.uint8)
    star = star_kernel.StarSettings(max_size=4, response_threshold=5.0)
    ii = tstar._integral(gray, tstar.integral_pad(star.max_size))
    pattern = brief_kernel.BriefPattern.make(
        *tbrief.make_shared_pattern(patch_size=15), "cpu")
    return {
        star_kernel: (star_kernel.star_from_integral, (ii, 45, 61, star)),
        brief_kernel: (brief_kernel.dense_planes,
                       (tbrief.smooth(gray), pattern)),
        predict_kernel: (predict_kernel.predict,
                         (t(P), t(x), 1.0, 1e-6, 1e-5)),
        measure_kernel: (measure_kernel.measure,
                         (cam, t(cam7), t(feats), t(is_xyz), t(active))),
        update_kernel: (update_kernel.joint_update,
                        (t(P), t(x), t(HP), t(Sfull), t(uv), t(z), t(use),
                         1.0)),
        init_kernel: (init_kernel.init_chain,
                      (cam, t(cam7), t(uv[:5]), 1.0)),
        ransac_kernel: (ransac_kernel.support,
                        (cam, *(t(r[k]) for k in ("x", "HP", "S", "z", "uv",
                                                  "matched", "active",
                                                  "is_xyz")), 1.0, 1.0)),
    }


@pytest.mark.parametrize("module", KERNELS, ids=lambda m: m.__name__)
def test_cpu_tensor_takes_plain_path_without_a_launch(module):
    fn, args = _wrapper_inputs()[module]
    module.LAUNCHES.reset()
    plain = {predict_kernel: predict_kernel.predict_plain,
             measure_kernel: measure_kernel.measure_plain,
             update_kernel: update_kernel.update_plain,
             init_kernel: init_kernel.init_plain,
             star_kernel: star_kernel.star_plain,
             brief_kernel: brief_kernel.dense_planes_plain,
             ransac_kernel: ransac_kernel.support_plain}[module]
    for got, want in zip(fn(*args), plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert module.LAUNCHES.count == 0


@pytest.mark.parametrize("module", KERNELS, ids=lambda m: m.__name__)
def test_cuda_launch_refuses_cpu_tensors(module):
    fn, args = _wrapper_inputs()[module]
    launch = {predict_kernel: predict_kernel.predict_cuda,
              measure_kernel: measure_kernel.measure_cuda,
              update_kernel: update_kernel.joint_update_cuda,
              init_kernel: init_kernel.init_cuda,
              star_kernel: star_kernel.star_cuda,
              brief_kernel: brief_kernel.dense_planes_cuda,
              ransac_kernel: ransac_kernel.support_cuda}[module]
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        launch(*args)
    assert module.LAUNCHES.count == 0


def test_runtime_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.SlamRuntime(TConfig(max_features=8))
    rt = tstep.SlamRuntime(TConfig(max_features=8), device="cpu")
    assert rt.device == torch.device("cpu")
    # SlamConfig()'s FAST + BRIEF front end runs on the CPU, and so do the
    # PATCH descriptor and the NCC matcher
    state, rec = rt.step(rt.make_initial_state(),
                         np.zeros((48, 64), np.uint8))
    assert torch.isfinite(state.x).all() and int(rec.total_matches) == 0
    patch = dataclasses.replace(
        TConfig(max_features=8),
        descriptor=dataclasses.replace(TConfig().descriptor, kind="PATCH"))
    for cfg in (patch, dataclasses.replace(patch, matcher="ncc")):
        rt = tstep.SlamRuntime(cfg, device="cpu")
        state, rec = rt.step(rt.make_initial_state(),
                             np.zeros((48, 64), np.uint8))
        assert torch.isfinite(state.x).all()
        assert state.descriptors.dtype == torch.float32
        assert state.descriptors.shape == (8, 225)
    # the parity mode is ported: it builds on the CPU as on the card
    assert tstep.SlamRuntime(dataclasses.replace(TConfig(),
                                                 reference_quirks=True),
                             "cpu").quirks


def test_cam_params_mirror_the_cuda_struct():
    src = (Path(cuda_lib.CSRC) / "common.cuh").read_text()
    body = re.search(r"struct CamParams \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+)[,;]", body.replace("float", ""))
    assert names == [n for n, _ in cuda_lib.CamParams._fields_]
    star_src = (Path(cuda_lib.CSRC) / "star.cu").read_text()
    body = re.search(r"struct StarParams \{(.*?)\};", star_src, re.S).group(1)
    names = re.findall(r"(\w+)(?:\[\w+\])?[,;]",
                       re.sub(r"\b(int|float)\b", "", body))
    assert names == [n for n, _ in cuda_lib.StarParams._fields_]
    assert f"#define STAR_MAX_SIZES {cuda_lib.STAR_MAX_SIZES}" in star_src
    # the constants that size the wrappers' scratch
    core_src = (Path(cuda_lib.CSRC) / "spd_core.cuh").read_text()
    assert re.search(rf"constexpr int NB = {spd_core.NB};", core_src)
    for mod, name in ((sinv, "sinv.cu"), (update_kernel, "update.cu")):
        src = (Path(cuda_lib.CSRC) / name).read_text()
        assert re.search(rf"constexpr int SLAB = {mod.SLAB};", src)
        assert (f"constexpr int SOLVE_SMEM_MAX = "
                f"{mod.SOLVE_SMEM_MAX // 1024} * 1024;") in src
    # one launcher per kernel module, every one declared for ctypes
    exported = set()
    for cu in Path(cuda_lib.CSRC).glob("*.cu"):
        exported |= set(re.findall(r"EKF_EXPORT int (\w+)\(", cu.read_text()))
    assert exported == set(cuda_lib._SIGNATURES)
