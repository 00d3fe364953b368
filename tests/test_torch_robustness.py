"""Degenerate-input robustness of the port's engine: the state never goes
NaN or Inf.

The cases of the JAX package's tests/test_robustness.py, driven through
the port's ``SlamEngine`` on the CPU: a black, white, noise, gradient and
checkerboard frame three times between textured ones; a black bootstrap
frame followed by recovery on a textured scene; 20 frames of pure noise.
Each checks finite x and P with diag P >= -1e-6.  Every case runs with the
JAX test's configuration (the FAST detector at threshold 12) and with a
STAR detector (response threshold 8), each in both dtypes; the STAR cases
keep their plain dtype ids.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openekfmonoslam_tpu_torch.config import (CameraCalibration,
                                              DetectorConfig, EKFParams,
                                              SlamConfig)
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine

H, W = 96, 128


DETECTORS = {
    # the JAX test's: the default FAST detector at threshold 12
    "FAST": dataclasses.replace(SlamConfig().detector, threshold=12.0),
    "STAR": DetectorConfig(kind="STAR", star_response_threshold=8.0),
}


def small_cfg(dtype, detector="STAR"):
    cam = CameraCalibration(
        pixels_x=W, pixels_y=H, fx=100.0, fy=100.0, cx=64.0, cy=48.0,
        k1=-0.01, k2=0.001, dx=0.01, dy=0.01,
        angular_vision_x=45.0, angular_vision_y=35.0)
    ekf = EKFParams(min_matches_per_image=8,
                    detect_new_features_image_areas_divide_times=1)
    return SlamConfig(camera=cam, ekf=ekf, max_features=12, max_keypoints=64,
                      max_hypotheses=12, dtype=dtype,
                      detector=DETECTORS[detector])


def engine(run, **kw):
    dtype, detector = run
    return SlamEngine(small_cfg(dtype, detector), device="cpu", **kw)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def textured(rng):
    img = np.zeros((H, W), np.uint8)
    for _ in range(50):
        y, x = rng.integers(5, H - 5), rng.integers(5, W - 5)
        img[y - 2:y + 2, x - 2:x + 2] = rng.integers(80, 255)
    return img


def assert_finite(eng):
    x = eng.state.x.detach().cpu().numpy()
    P = eng.state.P.detach().cpu().numpy()
    assert np.isfinite(x).all()
    assert np.isfinite(P).all()
    # the covariance stays symmetric PSD-ish (diag nonnegative)
    assert (np.diag(P) >= -1e-6).all()


DEGENERATE = {
    "black": lambda rng: np.zeros((H, W), np.uint8),
    "white": lambda rng: np.full((H, W), 255, np.uint8),
    "noise": lambda rng: rng.integers(0, 255, (H, W), dtype=np.uint8),
    "gradient": lambda rng: np.tile(
        np.linspace(0, 255, W, dtype=np.uint8), (H, 1)),
    "checker_cut": lambda rng: np.kron(
        (np.indices((12, 16)).sum(0) % 2) * 255,
        np.ones((8, 8))).astype(np.uint8),
}
# (dtype, detector) pairs; the STAR cases keep the ids they had when STAR
# was the only detector of the port
RUNS = [pytest.param((dtype, det), id=dtype if det == "STAR"
                     else f"{dtype}-{det}")
        for det in ("STAR", "FAST") for dtype in ("float32", "float64")]


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("kind", sorted(DEGENERATE))
def test_degenerate_frames_keep_state_finite(kind, run, rng):
    eng = engine(run)
    eng.init(textured(rng))
    eng.step(textured(rng))
    bad = DEGENERATE[kind](rng)
    for _ in range(3):
        eng.step(bad)
        assert_finite(eng)
    # the engine keeps accepting frames afterwards
    eng.step(textured(rng))
    assert_finite(eng)


@pytest.mark.parametrize("run", RUNS)
def test_degenerate_bootstrap_then_recover(run, rng):
    """INIT on a featureless frame does not corrupt the filter; a textured
    scene afterwards repopulates the empty map through ordinary map
    management, and matches recover above the loss threshold."""
    eng = engine(run, relocalize_after=2, lost_matches_threshold=4)
    eng.init(np.zeros((H, W), np.uint8))
    assert_finite(eng)
    tex = textured(rng)
    for _ in range(4):
        eng.step(tex)
        assert_finite(eng)
    assert eng.records[-1]["n_active"] > 0
    assert eng.records[-1]["total_matches"] >= 4


@pytest.mark.parametrize("run", RUNS)
def test_random_noise_run_stays_finite(run, rng):
    """20 frames of pure sensor noise: matches come and go at random, the
    filter stays finite throughout (gates + masked algebra)."""
    eng = engine(run, relocalize_after=3)
    eng.init(rng.integers(0, 255, (H, W), dtype=np.uint8))
    for _ in range(20):
        eng.step(rng.integers(0, 255, (H, W), dtype=np.uint8))
        assert_finite(eng)
