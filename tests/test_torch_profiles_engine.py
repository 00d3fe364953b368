"""Every front-end profile through the port's entry points, against the
JAX package.

  * the seven profiles of tests/test_detector_family.py (FAST/BRIEF,
    STAR/BRIEF, ORB/ORB, SIFT/SURF, SURF/SURF, HARRIS/BRIEF,
    SHI_TOMASI/ORB) with that test's settings, through ``init_step`` and 3
    ``step``s of both packages in float64 on its 120x128 scene (blocks of
    random grey, smoothed, sliding 1 px a frame).  The scene is rounded to
    grey levels and nudged so that STAR's float32 integral image is exact
    (tests/test_torch_live.py), the same frames for every profile.  Every
    mask and count is identical, ``x_cam`` and ``P_cam`` within 1e-9;
  * the two engine smokes of tests/test_config_matrix.py (the samples
    file's default selection EKF / STAR / BRIEF / S3, and MatlabEKF / Fast
    / ORB / MatlabCam), through ``SlamEngine`` of both packages from a
    config file with those profiles' values, in float64: records within
    1e-9.  The samples file itself is not in the repository, so the file
    here is written with the values tests/test_config_matrix.py checks.
    On the default selection (STAR at 640x480) the float32 integral image
    of a noise frame is not exact, so the two packages' STAR maps differ by
    float32 reassociation (tests/test_torch_vision.py) and the subpixel
    fits move the pose: there the records agree within TOL_STAR_640;
  * a checkpoint with SURF descriptor slots (float32) saved by each package
    and resumed by the other: the descriptors equal as float32, and the
    resumed runs' records agree with the saving package's within 1e-9.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.engine import engine as jeng
from openekfmonoslam_tpu.engine.step import SlamRuntime as JRuntime
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine import engine as teng
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime as TRuntime
from openekfmonoslam_tpu_torch.vision import brief as tbrief
from openekfmonoslam_tpu_torch.vision import star as tstar
from test_torch_live import exact_integral_frame

PROFILES = [("FAST", "BRIEF"), ("STAR", "BRIEF"), ("ORB", "ORB"),
            ("SIFT", "SURF"), ("SURF", "SURF"), ("HARRIS", "BRIEF"),
            ("SHI_TOMASI", "ORB")]
MASKS = ("matched", "inliers", "visible", "new_ok", "new_slot",
         "total_matches", "li_inliers", "hi_inliers", "n_active",
         "n_visible")
VALUES = ("position", "orientation", "linear_velocity", "angular_velocity",
          "covariance_cam")
COUNTERS = ("frame", "total_matches", "li_inliers", "hi_inliers",
            "n_active", "n_visible", "n_xyz", "n_inverse_depth")


def profile_config(mod, det, desc):
    """tests/test_detector_family.py's profile settings, in float64."""
    return mod.SlamConfig(
        max_features=16, max_keypoints=96, max_hypotheses=16,
        dtype="float64",
        detector=mod.DetectorConfig(
            kind=det, threshold=20.0, star_response_threshold=5.0,
            quality=0.005, surf_quality=0.01),
        descriptor=mod.DescriptorConfig(kind=desc, patch_size=17),
        ekf=dataclasses.replace(mod.SlamConfig().ekf,
                                min_matches_per_image=10))


@functools.lru_cache(maxsize=1)
def scene_frames(n=4):
    rng = np.random.default_rng(42)
    big = np.kron(rng.integers(0, 255, (40, 44)),
                  np.ones((4, 4))).astype(np.float32)
    big = tbrief.smooth(torch.as_tensor(big), 1.0).numpy()
    big = np.clip(np.round(big), 0, 255).astype(np.uint8)
    pad = tstar.integral_pad(16)
    return tuple(exact_integral_frame(big[20:140, 20 + sx:148 + sx], pad)
                 for sx in range(n))


@functools.lru_cache(maxsize=None)
def profile_runs(det, desc):
    frames = scene_frames()
    jrt = JRuntime(profile_config(jcfg, det, desc))
    trt = TRuntime(profile_config(tcfg, det, desc), device="cpu")
    js = jax.jit(jrt.init_step)(jrt.make_initial_state(),
                                jnp.asarray(frames[0]))
    jstep = jax.jit(jrt.step)
    ts = trt.init_step(trt.make_initial_state(), frames[0])
    jrecs, trecs = [], []
    for f in frames[1:]:
        js, rec = jstep(js, jnp.asarray(f))
        jrecs.append({k: np.asarray(v) for k, v in rec._asdict().items()})
        ts, rec = trt.step(ts, f)
        trecs.append({k: v.numpy() for k, v in rec._asdict().items()})
    return jrecs, trecs, js, ts


@pytest.mark.parametrize("det,desc", PROFILES)
def test_profile_masks_and_counts_identical(det, desc):
    jrecs, trecs, js, ts = profile_runs(det, desc)
    for t, (j, r) in enumerate(zip(jrecs, trecs)):
        for k in MASKS:
            assert np.array_equal(j[k], r[k]), (k, t)
    assert all(r["total_matches"] >= 5 for r in trecs)
    assert int(ts.active.sum()) >= 8
    want = torch.int32 if desc in ("BRIEF", "ORB") else torch.float32
    assert ts.descriptors.dtype == want
    assert np.array_equal(np.asarray(js.active), ts.active.numpy())


@pytest.mark.parametrize("det,desc", PROFILES)
def test_profile_values_within_1e9(det, desc):
    jrecs, trecs, js, ts = profile_runs(det, desc)
    for t, (j, r) in enumerate(zip(jrecs, trecs)):
        for k in ("x_cam", "P_cam", "z", "pred_uv", "new_uv"):
            np.testing.assert_allclose(r[k], j[k], rtol=0, atol=1e-9,
                                       err_msg=f"{k} frame {t + 1}")
    jd, td = np.asarray(js.descriptors), ts.descriptors.numpy()
    if td.dtype == np.float32:
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    else:
        assert np.array_equal(td.view(np.uint32), jd)


# ------------------------------------------------ config-matrix smokes

CONFIG = """%YAML:1.0
RunConfiguration:
  ExtendedKalmanFilter: "{ekf}"
  FeatureDetector: "{det}"
  DescriptorExtractor: "{desc}"
  CameraCalibration: "{cam}"
ExtendedKalmanFilter:
  EKF:
    LinearAccelSD: "0.0005"
    AngularAccelSD: "0.00005"
    MinMatchesPerImage: "20"
    MaxMapSize: "240"
  MatlabEKF:
    LinearAccelSD: "0.007"
    AngularAccelSD: "0.007"
    MinMatchesPerImage: "25"
    MaxMapSize: "300"
FeatureDetector:
  STAR:
    Type: "STAR"
  Fast:
    Type: "FAST"
    Threshold: "50"
DescriptorExtractor:
  BRIEF:
    Type: "BRIEF"
    BytesLength: "32"
  ORB:
    Type: "ORB"
CameraCalibration:
  S3:
    PixelsX: "640"
    PixelsY: "480"
    FX: "525.060143149240389"
    FY: "525.060143149240389"
    CX: "320.0"
    CY: "240.0"
    K1: "-7.613e-3"
    K2: "0.0"
    DX: "0.01"
    DY: "0.01"
    PixelErrorX: "1.0"
    PixelErrorY: "1.0"
    AngularVisionX: "62.7"
    AngularVisionY: "49.1"
  MatlabCam:
    PixelsX: "320"
    PixelsY: "240"
    FX: "194.0625"
    FY: "194.0625"
    CX: "160.0"
    CY: "120.0"
    K1: "0.0"
    K2: "0.0"
    DX: "0.01"
    DY: "0.01"
    PixelErrorX: "1.0"
    PixelErrorY: "1.0"
    AngularVisionX: "79.0"
    AngularVisionY: "63.4"
"""
SELECTIONS = {
    "default": dict(ekf="EKF", det="STAR", desc="BRIEF", cam="S3"),
    "alternate": dict(ekf="MatlabEKF", det="Fast", desc="ORB",
                      cam="MatlabCam"),
}
SMOKE = dict(max_features=16, max_keypoints=64, max_hypotheses=16,
             dtype="float64")
# STAR maps from inexact float32 integral images (5.2e-9 measured on these
# frames); every other selection agrees within 1e-9
TOL_STAR_640 = 1e-7


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_config_matrix_engine_smoke_matches_jax(tmp_path, selection):
    """3 frames of sensor noise through SlamEngine of both packages, as
    tests/test_config_matrix.py's ``_smoke`` runs the JAX step."""
    path = tmp_path / "config.yml"
    path.write_text(CONFIG.format(**SELECTIONS[selection]))
    te = teng.SlamEngine(str(path), device="cpu", **SMOKE)
    je = jeng.SlamEngine(str(path), **SMOKE)
    for part in ("camera", "ekf", "detector", "descriptor"):
        assert (dataclasses.asdict(getattr(te.config, part))
                == dataclasses.asdict(getattr(je.config, part))), part
    h, w = te.config.camera.pixels_y, te.config.camera.pixels_x
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (h, w), np.uint8) for _ in range(4)]
    for eng in (te, je):
        eng.init(frames[0])
        for f in frames[1:]:
            eng.step(f)
    assert np.isfinite(te.state_vector).all()
    assert np.isfinite(te.covariance).all()
    tol = TOL_STAR_640 if selection == "default" else 1e-9
    assert len(te.records) == len(je.records) == 3
    for t, (g, want) in enumerate(zip(te.records, je.records)):
        for k in COUNTERS:
            assert g[k] == want[k], (k, t)
        for k in VALUES:
            np.testing.assert_allclose(g[k], want[k], rtol=0, atol=tol,
                                       err_msg=f"{k} record {t}")


# ------------------------------------- SURF slots across the packages

CKPT_AT = 2


@pytest.fixture(scope="module")
def surf_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surf")
    frames = scene_frames(6)
    jc = profile_config(jcfg, "SURF", "SURF")
    tc = profile_config(tcfg, "SURF", "SURF")
    je = jeng.SlamEngine(jc)
    te = teng.SlamEngine(tc, device="cpu")
    for eng, name in ((je, "jax.npz"), (te, "port.npz")):
        eng.init(frames[0])
        for k, f in enumerate(frames[1:]):
            eng.step(f)
            if k + 1 == CKPT_AT:
                eng.save_checkpoint(str(tmp / name))
    return dict(tmp=tmp, frames=frames, jc=jc, tc=tc, je=je, te=te)


def test_surf_checkpoint_is_float32_in_both_packages(surf_runs):
    tmp = surf_runs["tmp"]
    with np.load(tmp / "jax.npz") as j, np.load(tmp / "port.npz") as p:
        assert set(j.files) == set(p.files)
        for f in j.files:
            assert j[f].dtype == p[f].dtype and j[f].shape == p[f].shape, f
        assert p["descriptors"].dtype == np.float32
        assert p["descriptors"].shape == (16, 64)
        assert np.abs(p["descriptors"]).sum() > 0
        np.testing.assert_allclose(p["descriptors"], j["descriptors"],
                                   rtol=0, atol=1e-6)


def test_port_resumes_a_jax_surf_checkpoint(surf_runs):
    tmp, frames = surf_runs["tmp"], surf_runs["frames"]
    te = teng.SlamEngine(surf_runs["tc"], device="cpu")
    te.resume(str(tmp / "jax.npz"))
    with np.load(tmp / "jax.npz") as j:
        assert te.state.descriptors.dtype == torch.float32
        assert np.array_equal(te.state.descriptors.numpy(),
                              j["descriptors"])
    for f in frames[1 + CKPT_AT:]:
        te.step(f)
    want = surf_runs["je"].records[CKPT_AT:]
    for t, (g, w) in enumerate(zip(te.records, want)):
        for k in COUNTERS:
            assert g[k] == w[k], (k, t)
        for k in VALUES:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9)


def test_jax_resumes_a_port_surf_checkpoint(surf_runs):
    tmp, frames = surf_runs["tmp"], surf_runs["frames"]
    je = jeng.SlamEngine(surf_runs["jc"])
    je.resume(str(tmp / "port.npz"))
    with np.load(tmp / "port.npz") as p:
        assert np.asarray(je.state.descriptors).dtype == np.float32
        assert np.array_equal(np.asarray(je.state.descriptors),
                              p["descriptors"])
    for f in frames[1 + CKPT_AT:]:
        je.step(f)
    want = surf_runs["te"].records[CKPT_AT:]
    for t, (g, w) in enumerate(zip(je.records, want)):
        for k in COUNTERS:
            assert g[k] == w[k], (k, t)
        for k in VALUES:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-9)


# ------------------------------------------------------- the port's CLI

CLI_CONFIG = """%YAML:1.0
RunConfiguration:
  ExtendedKalmanFilter: "EKF"
  FeatureDetector: "{det}"
  DescriptorExtractor: "{desc}"
  CameraCalibration: "Scene"
ExtendedKalmanFilter:
  EKF:
    MinMatchesPerImage: "10"
    DetectNewFeaturesImageAreasDivideTimes: "1"
FeatureDetector:
  {det}:
    Type: "{det}"
    Threshold: "20"
DescriptorExtractor:
  {desc}:
    Type: "{desc}"
CameraCalibration:
  Scene:
    PixelsX: "128"
    PixelsY: "120"
    FX: "120.0"
    FY: "120.0"
    K1: "0.0"
    K2: "0.0"
    CX: "64.0"
    CY: "60.0"
    DX: "0.01"
    DY: "0.01"
    PixelErrorX: "1.0"
    PixelErrorY: "1.0"
    AngularVisionX: "45.0"
    AngularVisionY: "35.0"
"""


@pytest.mark.parametrize("det,desc", [("FAST", "BRIEF"), ("ORB", "ORB"),
                                      ("SIFT", "SIFT"), ("HARRIS", "SURF")])
def test_cli_runs_the_profile(tmp_path, det, desc):
    """``python -m openekfmonoslam_tpu_torch.cli`` on the CPU with a config
    that selects the profile: the records equal SlamEngine's over the same
    frames, the descriptor slots have the profile's dtype, and TF32 is
    off."""
    from PIL import Image

    from openekfmonoslam_tpu_torch import cli
    from openekfmonoslam_tpu_torch.io.sources import FileSequenceSource

    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(scene_frames(6), start=1):
        Image.fromarray(f).save(frames_dir / f"{i:05d}.png")
    config = tmp_path / "config.yml"
    config.write_text(CLI_CONFIG.format(det=det, desc=desc))
    out = tmp_path / "out"
    cli.main([str(config), str(frames_dir), str(out), "--device", "cpu",
              "--max-features", "16", "--progress", "0"])
    import json
    recs = [json.loads(line) for line in open(out / "records.jsonl")]
    engine = teng.SlamEngine(str(config), device="cpu", max_features=16)
    assert engine.config.detector.kind == det
    want = teng.run_sequence(engine, FileSequenceSource(str(frames_dir), 1,
                                                        99))
    assert len(recs) == len(want) == 5
    for got, w in zip(recs, want):
        for k in COUNTERS + VALUES:
            assert got[k] == w[k], k
    assert sum(r["total_matches"] for r in recs) > 0
    binary = desc in ("BRIEF", "ORB")
    assert engine.state.descriptors.dtype == (torch.int32 if binary
                                              else torch.float32)
    # the engine's runtime keeps matmuls (the float descriptors' L2
    # distance among them) true float32 on the card
    assert not torch.backends.cuda.matmul.allow_tf32
