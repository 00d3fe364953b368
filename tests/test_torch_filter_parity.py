"""The PyTorch port against the JAX package, module by module, in float64.

Both packages get the same numpy inputs; every float result must agree to
1e-10 (absolute and relative), every mask, counter and slot id exactly.
The JAX side runs its CPU chain (its Pallas kernels are TPU-gated); the
port runs its plain PyTorch versions, which its wrappers pick for CPU
tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jconfig
from openekfmonoslam_tpu.core import camera as jcam
from openekfmonoslam_tpu.core import quaternion as jquat
from openekfmonoslam_tpu.filter import features as jfeat
from openekfmonoslam_tpu.filter import mapman as jmap
from openekfmonoslam_tpu.filter import measure as jmeas
from openekfmonoslam_tpu.filter import measure_fast as jmf
from openekfmonoslam_tpu.filter import predict as jpred
from openekfmonoslam_tpu.filter import ransac as jransac
from openekfmonoslam_tpu.filter import shardable as jshard
from openekfmonoslam_tpu.filter import state as jstate
from openekfmonoslam_tpu.filter import update as jupd
from openekfmonoslam_tpu_torch import config as tconfig
from openekfmonoslam_tpu_torch.core import camera as tcam
from openekfmonoslam_tpu_torch.core import quaternion as tquat
from openekfmonoslam_tpu_torch.filter import features as tfeat
from openekfmonoslam_tpu_torch.filter import mapman as tmap
from openekfmonoslam_tpu_torch.filter import measure as tmeas
from openekfmonoslam_tpu_torch.filter import measure_fast as tmf
from openekfmonoslam_tpu_torch.filter import predict as tpred
from openekfmonoslam_tpu_torch.filter import ransac as transac
from openekfmonoslam_tpu_torch.filter import shardable as tshard
from openekfmonoslam_tpu_torch.filter import state as tstate
from openekfmonoslam_tpu_torch.filter import update as tupd

TOL = dict(rtol=1e-10, atol=1e-10)
F = 10


def close(t, j, **kw):
    """torch result ``t`` against JAX result ``j`` (float 1e-10, else equal)."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    b = np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, **(kw or TOL))
    else:
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def configs(f=F, **ekf):
    ekf = {"min_matches_per_image": 6, **ekf}
    jc = jconfig.SlamConfig(max_features=f, dtype="float64",
                            ekf=dataclasses.replace(jconfig.EKFParams(),
                                                    **ekf))
    tc = tconfig.SlamConfig(max_features=f, dtype="float64",
                            ekf=dataclasses.replace(tconfig.EKFParams(),
                                                    **ekf))
    return jc, tc


def cameras():
    return (jcam.Camera.from_calibration(jconfig.CameraCalibration(),
                                         jnp.float64),
            tcam.Camera.from_calibration(tconfig.CameraCalibration()))


def to_torch_state(js):
    return tstate.state_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")


@pytest.fixture(scope="module")
def scene():
    """A mapped JAX state: 8 features added, one converted to XYZ, the
    camera moved and the covariance propagated; and its torch copy."""
    rng = np.random.default_rng(7)
    jc, tc = configs()
    jc_cam, tc_cam = cameras()
    js = jstate.make_initial_state(jc, jnp.float64)
    n = 8
    uv = rng.uniform([80, 60], [560, 420], size=(n, 2))
    desc = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint32)
    js = jfeat.add_features(js, jc_cam, jc, jnp.asarray(uv),
                            jnp.asarray(desc), jnp.ones((n,), bool))
    x = np.asarray(js.x).copy()
    x[0:3] = [0.02, -0.01, 0.03]
    q = np.array([1.0, 0.01, -0.02, 0.015])
    x[3:7] = q / np.linalg.norm(q)
    x[7:10] = [0.01, 0.002, -0.004]
    x[10:13] = [0.003, -0.002, 0.001]
    js = js._replace(x=jnp.asarray(x), frame=jnp.int32(3))
    js = jpred.predict(js, jc)
    js = jmap._convert_slot(js, jnp.int32(2))
    return dict(js=js, ts=to_torch_state(js), jc=jc, tc=tc, jcam=jc_cam,
                tcam=tc_cam, rng=rng)


# --------------------------------------------------------------- config

def test_config_yml_loads_identically(tmp_path):
    path = tmp_path / "config.yml"
    path.write_text(
        '%YAML:1.0\n'
        'RunConfiguration:\n'
        '  ExtendedKalmanFilter: "S3"\n'
        '  CameraCalibration: "Cam"\n'
        '  FeatureDetector: "STAR"\n'
        '  DescriptorExtractor: "BRIEF"\n'
        'ExtendedKalmanFilter:\n'
        '  S3:\n'
        '    MinMatchesPerImage: "55"\n'
        '    MaxMapSize: "300"\n'
        '    LinearAccelSD: "0.0009"\n'
        '    AlwaysRemoveUnseenMapFeatures: "false"\n'
        'CameraCalibration:\n'
        '  Cam:\n'
        '    FX: "520.5"\n'
        '    K1: "-0.01"\n'
        'FeatureDetector:\n'
        '  STAR:\n'
        '    Type: "STAR"\n'
        '    MaxSize: "32"\n'
        'DescriptorExtractor:\n'
        '  BRIEF:\n'
        '    Type: "BRIEF"\n'
        '    BytesLength: "32"\n')
    j = jconfig.load_config(str(path), max_features=40)
    t = tconfig.load_config(str(path), max_features=40)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    # the port drops the JAX package's TPU-only switches and keeps the rest
    assert set(jd) - set(td) == {
        "measure_kernel", "update_kernel", "predict_kernel", "star_kernel",
        "init_kernel", "brief_kernel", "matmul_precision"}
    assert {k: jd[k] for k in td} == td
    assert tconfig.parse_opencv_yml(str(path)) == \
        jconfig.parse_opencv_yml(str(path))
    assert (t.state_dim, t.padded_state_dim) == (j.state_dim,
                                                 j.padded_state_dim)
    assert tconfig.auto_max_features(t.ekf) == \
        jconfig.auto_max_features(j.ekf)
    assert t.descriptor.width == j.descriptor.width
    s3 = tconfig.SlamConfig()
    assert (tconfig.auto_max_features(s3.ekf), s3.state_dim,
            s3.padded_state_dim) == (96, 589, 640)


# ----------------------------------------------------------- quaternion

def test_quaternion_functions():
    rng = np.random.default_rng(0)
    vs = np.concatenate([rng.normal(scale=0.3, size=(6, 3)),
                         np.zeros((1, 3)), np.full((1, 3), 1e-10)])
    close(tquat.from_axis_angle(T(vs)), jax.vmap(jquat.from_axis_angle)(vs))
    q1, q2 = rng.normal(size=(2, 5, 4))
    close(tquat.multiply(T(q1), T(q2)), jax.vmap(jquat.multiply)(q1, q2))
    close(tquat.conjugate(T(q1)), jax.vmap(jquat.conjugate)(q1))
    close(tquat.to_rotation_matrix(T(q1)),
          jax.vmap(jquat.to_rotation_matrix)(q1))
    close(tquat.normalize(T(q1)), jax.vmap(jquat.normalize)(q1))
    close(tquat.normalize_jacobian(T(q1)),
          jax.vmap(jquat.normalize_jacobian)(q1))
    close(tquat.to_euler(T(q1)), jax.vmap(jquat.to_euler)(q1))
    th, ph = rng.uniform(-2, 2, size=(2, 7))
    close(tquat.directional_vector(T(th), T(ph)),
          jax.vmap(jquat.directional_vector)(th, ph))


def test_camera_functions():
    jc, tc = cameras()
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.normal(size=(20, 2)),
                        rng.uniform(-1, 4, size=(20, 1))], axis=1)
    uv = rng.uniform([-50, -50], [700, 530], size=(20, 2))
    uv[0] = [jc.cx, jc.cy]                       # the floored radius
    close(tcam.project(tc, T(p)), jcam.project(jc, p))
    close(tcam.back_project(tc, T(uv)), jcam.back_project(jc, uv))
    close(tcam.distort(tc, T(uv)), jcam.distort(jc, uv))
    close(tcam.undistort(tc, T(uv)), jcam.undistort(jc, uv))
    close(tcam.in_front_and_in_fov(tc, T(p)), jcam.in_front_and_in_fov(jc, p))
    close(tcam.in_image(tc, T(uv)), jcam.in_image(jc, uv))
    assert tc.tan_vision_x == pytest.approx(float(jc.tan_vision_x), 1e-14)


# ------------------------------------------------------ state, shardable

def test_state_layout_and_roundtrip(scene):
    jc, tc = scene["jc"], scene["tc"]
    j0 = jstate.make_initial_state(jc, jnp.float64)
    t0 = tstate.make_initial_state(tc, torch.float64, "cpu")
    for name in jstate.SlamState._fields:
        got = tstate.state_to_numpy(t0)[name]
        close(got, getattr(j0, name))
    js, ts = scene["js"], scene["ts"]
    back = tstate.state_to_numpy(ts)
    for name in jstate.SlamState._fields:
        close(back[name], getattr(js, name))
    close(tstate.dim_active_mask(ts), jstate.dim_active_mask(js))
    close(tstate.slot_offsets(F), jstate.slot_offsets(F))
    close(tstate.zero_inactive(ts.P, tstate.dim_active_mask(ts)),
          jstate.zero_inactive(js.P, jstate.dim_active_mask(js)))
    close(ts.features, js.features)


@pytest.mark.parametrize("start", [3, 19])
def test_shardable_placements(start):
    rng = np.random.default_rng(start)
    P = rng.normal(size=(40, 40))
    rows, cols, blk = (rng.normal(size=(4, 40)), rng.normal(size=(40, 4)),
                       rng.normal(size=(4, 4)))
    for s in (start, jnp.int32(start)):
        ts = start if isinstance(s, int) else torch.tensor(start)
        close(tshard.place_rows(T(P), T(rows), ts),
              jshard.place_rows(P, rows, s))
        close(tshard.place_cols(T(P), T(cols), ts),
              jshard.place_cols(P, cols, s))
        close(tshard.place_block(T(P), T(blk), ts, ts),
              jshard.place_block(P, blk, s, s))
        close(tshard.select_rows(T(P), ts, 4), jshard.select_rows(P, s, 4))


# ----------------------------------------------------- predict, measure

def test_predict(scene):
    js, ts = scene["js"], scene["ts"]
    cam13 = np.asarray(js.x[:13])
    close(tpred.motion_model(T(cam13), 1.0), jpred.motion_model(cam13, 1.0))
    close(tpred.motion_jacobian(T(cam13), 1.0),
          jpred.motion_jacobian(cam13, 1.0))
    still = cam13.copy()
    still[10:13] = 0.0                           # the small-angle branch
    close(tpred.motion_jacobian(T(still), 1.0),
          jpred.motion_jacobian(still, 1.0))
    jp = jpred.predict(js, scene["jc"])
    tp = tpred.predict(ts, scene["tc"])
    close(tp.x, jp.x)
    close(tp.P, jp.P)


def test_measurements_with_jacobians_and_visibility(scene):
    js, ts = scene["js"], scene["ts"]
    jc, tc = scene["jcam"], scene["tcam"]
    rng = np.random.default_rng(3)
    feats = np.asarray(js.features).copy()
    feats[5] = [0.1, 0.2, -3.0, 2.8, 0.3, 0.5]   # behind the camera
    is_xyz = np.asarray(js.is_xyz)
    active = rng.random(F) < 0.8
    cam7 = np.asarray(js.x[:7])
    juv, jHc, jHf = jmf.measurements_with_jacobians(jc, cam7, feats, is_xyz)
    tuv, tHc, tHf = tmf.measurements_with_jacobians(tc, T(cam7), T(feats),
                                                    T(is_xyz))
    close(tuv, juv)
    close(tHc, jHc)
    close(tHf, jHf)
    close(tmf.visibility(tc, T(cam7), T(feats), T(is_xyz), T(active), tuv),
          jmf.visibility(jc, cam7, feats, is_xyz, active, juv))
    # the reference's bug-compatible chain, to 1e-12
    quv, qHc, qHf = jmf.measurements_with_jacobians(jc, cam7, feats, is_xyz,
                                                    quirks=True)
    got = tmf.measurements_with_jacobians(tc, T(cam7), T(feats), T(is_xyz),
                                          quirks=True)
    for t_, j_ in zip(got, (quv, qHc, qHf)):
        close(t_, j_, rtol=1e-12, atol=1e-12)
    close(got[0], tuv, rtol=0, atol=0)           # the same value h(x)
    assert not np.allclose(got[1].numpy(), np.asarray(jHc))
    assert not np.allclose(got[2].numpy(), np.asarray(jHf))


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("layout", ["blocks", "dense"])
def test_predict_measurements(scene, layout, quirks):
    jp = jmeas.predict_measurements(scene["js"], scene["jcam"],
                                    quirks=quirks, hp_layout=layout)
    tp = tmeas.predict_measurements(scene["ts"], scene["tcam"],
                                    quirks=quirks, hp_layout=layout)
    assert int(np.sum(np.asarray(jp.visible))) >= 5
    for name in jmeas.Prediction._fields:
        close(getattr(tp, name), getattr(jp, name))
    close(tmeas.dense_H(tp.Hc, tp.Hf, 80), jmeas.dense_H(jp.Hc, jp.Hf, 80))
    close(tmeas.diag_blocks_2x2(tp.Sfull), jmeas.diag_blocks_2x2(jp.Sfull))
    close(tmeas.innovation_covariances(scene["ts"].P, tp.Hc, tp.Hf),
          jmeas.innovation_covariances(scene["js"].P, jp.Hc, jp.Hf))


def test_measure_one_batched(scene):
    js = scene["js"]
    cam7 = np.asarray(js.x[:7])
    feats = np.asarray(js.features)
    is_xyz = np.asarray(js.is_xyz)
    ref = jax.vmap(lambda f, s: jmeas.measure_one(scene["jcam"], cam7, f, s)
                   )(feats, is_xyz)
    close(tmeas.measure_one(scene["tcam"], T(cam7)[None], T(feats),
                            T(is_xyz)), ref)


# -------------------------------------------------------- update, ransac

def _matches(scene, seed, outliers=(1,)):
    rng = np.random.default_rng(seed)
    jp = jmeas.predict_measurements(scene["js"], scene["jcam"])
    tp = tmeas.predict_measurements(scene["ts"], scene["tcam"])
    z = np.asarray(jp.uv) + rng.normal(scale=0.7, size=(F, 2))
    z[list(outliers)] += 30.0
    matched = np.asarray(jp.visible) & (rng.random(F) < 0.9)
    return jp, tp, z, matched


@pytest.mark.parametrize("seed", [0, 1])
def test_kalman_update_and_finalize(scene, seed):
    jp, tp, z, use = _matches(scene, seed)
    js, ts = scene["js"], scene["ts"]
    jk = jupd.kalman_update(js, jp, z, use, 1.0)
    tk = tupd.kalman_update(ts, tp, T(z), T(use), 1.0)
    close(tk.x, jk.x)
    close(tk.P, jk.P)
    for applied in (True, False):
        jf = jupd.finalize_update(jk, jnp.asarray(applied))
        tf = tupd.finalize_update(tk, torch.tensor(applied))
        close(tf.x, jf.x)
        close(tf.P, jf.P)
    ju = jupd.update(js, jp, z, use, 1.0)
    tu = tupd.update(ts, tp, T(z), T(use), 1.0)
    close(tu.x, ju.x)
    close(tu.P, ju.P)
    jr, jH = jupd.masked_innovation(jp, z, use, js.P.shape[0])
    tr, tH = tupd.masked_innovation(tp, T(z), T(use), ts.P.shape[0])
    close(tr, jr)
    close(tH, jH)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_and_rescue(scene, seed):
    jp, tp, z, matched = _matches(scene, seed, outliers=(1, 4))
    js, ts = scene["js"], scene["ts"]
    args = (1.0, 0.99, 1.0, 96)
    jr = jransac.ransac(js, jp, jnp.asarray(z), jnp.asarray(matched),
                        scene["jcam"], *args)
    tr = transac.ransac(ts, tp, T(z), T(matched), scene["tcam"], *args)
    for name in jransac.RansacResult._fields:
        close(getattr(tr, name), getattr(jr, name))
    assert int(jr.best_support) > 0
    jx = jransac._batched_state_only_updates(js, jp, z, matched, 1.0)
    tx = transac._batched_state_only_updates(ts, tp, T(z), T(matched), 1.0)
    close(tx, jx)
    close(transac._support_counts(tx, ts, scene["tcam"], T(z), T(matched),
                                  1.0)[0],
          jransac._support_counts(jx, js, scene["jcam"], z, matched, 1.0)[0])
    # rescue against the post-update prediction
    js2 = jupd.update(js, jp, z, jr.inliers, 1.0)
    ts2 = tupd.update(ts, tp, T(z), tr.inliers, 1.0)
    jp2 = jmeas.predict_measurements(js2, scene["jcam"])
    tp2 = tmeas.predict_measurements(ts2, scene["tcam"])
    close(transac.rescue_outliers(tp2, T(z), tr.outliers, 5.9915),
          jransac.rescue_outliers(jp2, z, jr.outliers, 5.9915))
    S = np.asarray(jp.S)
    close(transac._solve2x2(T(S), T(z)), jransac._solve2x2(S, z))


# ---------------------------------------------------------- parity mode

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("option", ["visit_key", "deadband", "parity_visit",
                                    "all"])
def test_ransac_parity_options(scene, seed, option):
    """Each of the parity arguments of ``ransac`` (and all three) gives the
    JAX masks, support and visit count exactly; the visit key has ties."""
    jp, tp, z, matched = _matches(scene, seed, outliers=(1, 4))
    js, ts = scene["js"], scene["ts"]
    key = np.random.default_rng(seed).integers(0, 6, F).astype(np.int32)
    kw = {"visit_key": dict(visit_key=key), "deadband": dict(deadband=True),
          "parity_visit": dict(parity_visit=True),
          "all": dict(visit_key=key, deadband=True, parity_visit=True)}[option]
    args = (1.0, 0.99, 1.0, 1000)
    jr = jransac.ransac(js, jp, jnp.asarray(z), jnp.asarray(matched),
                        scene["jcam"], *args,
                        **{k: jnp.asarray(v) if k == "visit_key" else v
                           for k, v in kw.items()})
    tr = transac.ransac(ts, tp, T(z), T(matched), scene["tcam"], *args,
                        **{k: T(v) if k == "visit_key" else v
                           for k, v in kw.items()})
    for name in jransac.RansacResult._fields:
        close(getattr(tr, name), getattr(jr, name))
    if option == "deadband":
        close(transac._batched_state_only_updates(ts, tp, T(z), T(matched),
                                                  1.0, deadband=True),
              jransac._batched_state_only_updates(js, jp, z, matched, 1.0,
                                                  deadband=True))


def _scan_cases():
    """(support, matched, p, max_hypotheses) cases: random supports with
    ties, and the edges (all-zero support, e <= 0, e >= 1, one match, no
    match, support above the match count)."""
    rng = np.random.default_rng(2024)
    cases = []
    for k in range(200):
        n = int(rng.choice([1, 3, 8, 17, 40]))
        matched = rng.random(n) < rng.uniform(0.2, 1.0)
        support = rng.integers(0, max(int(matched.sum()), 1) + 1, n)
        if k % 5 == 0:
            support = rng.integers(0, 3, n)                 # many ties
        p = float(rng.choice([0.99, 0.5, 0.999, 0.9]))
        cases.append((support, matched, p, int(rng.choice([1000, 96, 3]))))
    n = 12
    cases += [
        (np.zeros(n, int), np.ones(n, bool), 0.99, 1000),   # e >= 1
        (np.full(n, n), np.ones(n, bool), 0.99, 1000),      # e <= 0
        (np.full(n, 2 * n), rng.random(n) < 0.5, 0.99, 1000),
        (np.arange(n), np.eye(n, dtype=bool)[5], 0.99, 1000),   # one match
        (np.arange(n), np.zeros(n, bool), 0.99, 1000),       # no match
        (np.array([9, 9, 10, 10, 3, 10]), np.ones(6, bool), 0.99, 1000),
        (np.array([1, 2, 3, 4, 5, 6]), np.ones(6, bool), 0.99, 1),
    ]
    return cases


def test_adaptive_visit_scan_equals_the_jax_scan():
    # one compile per length: p and the hypothesis cap go in as values
    jscan = jax.jit(jransac._adaptive_visit_scan)
    for i, (support, matched, p, mh) in enumerate(_scan_cases()):
        want = jscan(jnp.asarray(support, jnp.int32), jnp.asarray(matched),
                     jnp.float64(p), jnp.int32(mh))
        got = transac._adaptive_visit_scan(
            torch.tensor(support, dtype=torch.int32), T(matched), p, mh)
        assert [int(g) for g in got] == [int(w) for w in want], (
            i, support, matched, p, mh)
        assert all(g.dtype == torch.int32 and g.dim() == 0 for g in got)


@pytest.mark.parametrize("threshold", [1e9, 0.0, 0.05])
def test_conversion_candidate_order_key(scene, threshold):
    js, ts = scene["js"], scene["ts"]
    key = np.random.default_rng(4).permutation(F).astype(np.int32)
    jd, jslot = jmap.conversion_candidate(js, threshold,
                                          order_key=jnp.asarray(key))
    td, tslot = tmap.conversion_candidate(ts, threshold, order_key=T(key))
    close(td, jd)
    close(tslot, jslot)
    jc = jmap.convert_one_to_xyz(js, threshold, enable=jnp.asarray(True),
                                 order_key=jnp.asarray(key))
    tc = tmap.convert_one_to_xyz(ts, threshold, enable=torch.tensor(True),
                                 order_key=T(key))
    got = tstate.state_to_numpy(tc)
    for name in jstate.SlamState._fields:
        close(got[name], getattr(jc, name))


def test_kalman_update_deadband(scene):
    """Residual components of +-1e-13 are zeroed, +-1e-11 kept; with only
    the former used, the deadband leaves x exactly as it was."""
    jp, tp, _, use = _matches(scene, 0)
    js, ts = scene["js"], scene["ts"]
    uv = np.asarray(jp.uv)
    tiny = np.array([1e-13, -1e-13, 1e-11, -1e-11])[np.arange(2 * F)
                                                      % 4].reshape(F, 2)
    z = uv + tiny
    for u in (use, use & (np.arange(F) % 2 == 0)):
        jk = jupd.kalman_update(js, jp, z, u, 1.0, deadband=True)
        tk = tupd.kalman_update(ts, tp, T(z), T(u), 1.0, deadband=True)
        close(tk.x, jk.x)
        close(tk.P, jk.P)
    z0 = uv + tiny * (np.abs(tiny) < 1e-12)
    tk = tupd.kalman_update(ts, tp, T(z0), T(use), 1.0, deadband=True)
    assert torch.equal(tk.x, ts.x)
    assert not torch.equal(tupd.kalman_update(ts, tp, T(z0), T(use),
                                              1.0).x, ts.x)


def test_update_deadband_takes_the_chain(scene, monkeypatch):
    """update(deadband=True) equals JAX and never takes the fused kernel,
    even where the kernel applies (as JAX at filter/update.py:139)."""
    from openekfmonoslam_tpu_torch.ops import update_kernel

    jp, tp, z, use = _matches(scene, 1)
    js, ts = scene["js"], scene["ts"]
    want = jupd.update(js, jp, z, use, 1.0, deadband=True)
    monkeypatch.setattr(update_kernel, "update_kernel_applicable",
                        lambda P, HP: True)

    def fused(*args):
        raise AssertionError("the fused update was called")

    monkeypatch.setattr(update_kernel, "joint_update", fused)
    got = tupd.update(ts, tp, T(z), T(use), 1.0, deadband=True)
    close(got.x, want.x)
    close(got.P, want.P)
    with pytest.raises(AssertionError, match="fused"):
        tupd.update(ts, tp, T(z), T(use), 1.0)


# ------------------------------------------------------------- features

def test_init_feature_and_jacobians(scene):
    js = scene["js"]
    cam7 = np.asarray(js.x[:7])
    uv_rho = np.array([200.0, 150.0, 1.0])
    jcam_, tcam_ = scene["jcam"], scene["tcam"]
    close(tfeat.init_feature(tcam_, T(cam7), T(uv_rho)),
          jfeat.init_feature(jcam_, cam7, uv_rho))
    J1 = jax.jacfwd(lambda c: jfeat.init_feature(jcam_, c, uv_rho))(cam7)
    J2 = jax.jacfwd(lambda m: jfeat.init_feature(jcam_, cam7, m))(uv_rho)
    tJ1 = torch.func.jacfwd(
        lambda c: tfeat.init_feature(tcam_, c, T(uv_rho)))(T(cam7))
    tJ2 = torch.func.jacfwd(
        lambda m: tfeat.init_feature(tcam_, T(cam7), m))(T(uv_rho))
    close(tJ1, J1)
    close(tJ2, J2)


def test_assign_slots(scene):
    active = np.asarray(scene["js"].active)
    for valid in (np.ones(F, bool), np.arange(F) % 3 == 0,
                  np.zeros(F, bool)):
        js, jok = jfeat.assign_slots(jnp.asarray(active), jnp.asarray(valid))
        ts, tok = tfeat.assign_slots(T(active), T(valid))
        close(ts, js)
        close(tok, jok)


def test_add_features(scene):
    rng = np.random.default_rng(11)
    C = 5
    uv = rng.uniform([80, 60], [560, 420], size=(C, 2))
    desc = rng.integers(0, 2 ** 32, size=(C, 8), dtype=np.uint32)
    valid = np.array([True, False, True, True, True])
    ja = jfeat.add_features(scene["js"], scene["jcam"], scene["jc"],
                            jnp.asarray(uv), jnp.asarray(desc),
                            jnp.asarray(valid))
    ta = tfeat.add_features(scene["ts"], scene["tcam"], scene["tc"], T(uv),
                            T(desc.view(np.int32)), T(valid))
    got = tstate.state_to_numpy(ta)
    for name in jstate.SlamState._fields:
        close(got[name], getattr(ja, name))


def test_add_features_at_frees_colliding_slots(scene):
    rng = np.random.default_rng(12)
    C = 4
    uv = rng.uniform([80, 60], [560, 420], size=(C, 2))
    desc = np.zeros((C, 8), np.uint32)
    slots = np.array([1, 9, 3, F], np.int32)     # 1, 3 occupied; 9 free
    ok = np.array([True, True, True, False])
    for okk in (ok, np.zeros(C, bool)):
        ja = jfeat.add_features_at(scene["js"], scene["jcam"], scene["jc"],
                                   jnp.asarray(uv), jnp.asarray(desc),
                                   jnp.asarray(slots), jnp.asarray(okk))
        ta = tfeat.add_features_at(scene["ts"], scene["tcam"], scene["tc"],
                                   T(uv), T(desc.view(np.int32)), T(slots),
                                   T(okk))
        got = tstate.state_to_numpy(ta)
        for name in jstate.SlamState._fields:
            close(got[name], getattr(ja, name))


# --------------------------------------------------------------- mapman

def test_mapman_functions(scene):
    js, ts = scene["js"], scene["ts"]
    rng = np.random.default_rng(5)
    pred_m = rng.random(F) < 0.7
    inl = pred_m & (rng.random(F) < 0.5)
    desc = rng.integers(0, 2 ** 32, size=(F, 8), dtype=np.uint32)
    refreshed = rng.random(F) < 0.5
    for ref in (None, refreshed):
        jn = jmap.update_counters(js, jnp.asarray(pred_m), jnp.asarray(inl),
                                  jnp.asarray(desc),
                                  None if ref is None else jnp.asarray(ref))
        tn = tmap.update_counters(ts, T(pred_m), T(inl),
                                  T(desc.view(np.int32)),
                                  None if ref is None else T(ref))
        got = tstate.state_to_numpy(tn)
        for name in jstate.SlamState._fields:
            close(got[name], getattr(jn, name))
    close(tmap.bad_feature_mask(tn, 0.5), jmap.bad_feature_mask(jn, 0.5))
    close(tmap.linearity_index(ts), jmap.linearity_index(js))
    remove = np.zeros(F, bool)
    remove[[0, 2]] = True                        # one inverse-depth, one XYZ
    jr = jmap.remove_features(js, jnp.asarray(remove))
    tr = tmap.remove_features(ts, T(remove))
    got = tstate.state_to_numpy(tr)
    for name in jstate.SlamState._fields:
        close(got[name], getattr(jr, name))
    for needed in (-3, 0, 4, 40):
        for kw in ((True, 0, 0), (False, 8, 0), (False, 0, 50)):
            close(tmap.map_pressure(ts, torch.tensor(needed), *kw),
                  jmap.map_pressure(js, jnp.int32(needed), *kw))


@pytest.mark.parametrize("threshold", [1e9, 0.0])
def test_convert_one_to_xyz(scene, threshold):
    js, ts = scene["js"], scene["ts"]
    jd, jslot = jmap.conversion_candidate(js, threshold)
    td, tslot = tmap.conversion_candidate(ts, threshold)
    close(td, jd)
    close(tslot, jslot)
    for enable in (True, False):
        jc = jmap.convert_one_to_xyz(js, threshold, enable=jnp.asarray(enable))
        tc = tmap.convert_one_to_xyz(ts, threshold,
                                     enable=torch.tensor(enable))
        got = tstate.state_to_numpy(tc)
        for name in jstate.SlamState._fields:
            close(got[name], getattr(jc, name))
    j1 = jmap._convert_slot(js, jnp.int32(4))
    t1 = tmap._convert_slot(ts, torch.tensor(4))
    close(t1.P, j1.P)
    close(t1.x, j1.x)
    close(t1.is_xyz, j1.is_xyz)
