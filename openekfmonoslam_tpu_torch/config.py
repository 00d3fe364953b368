"""Typed configuration with a loader for the reference's OpenCV-YML files.

The PyTorch port's own copy of ``openekfmonoslam_tpu/config.py``: the same
dataclasses, defaults and YML loader, so a reference config file (e.g. the
s3 ``config.yml``) loads unchanged into either package.  The port imports
nothing of the JAX package, so it keeps this copy, and takes the float
descriptors' width from its own ``vision/floatdesc.py``.  The JAX
package's TPU-only
switches (the six ``*_kernel`` flags and ``matmul_precision``) have no
counterpart: the port's kernel wrappers launch their CUDA kernel for every
CUDA tensor and run the plain version for CPU tensors, and its matmuls are
true fp32.

The reference configures itself from OpenCV ``FileStorage`` YML files whose
top-level ``RunConfiguration`` section selects one named profile per
subsystem (ConfigurationManager.cpp:74-111).  All values are strings that
the C++ readers parse with per-key defaults (ExtendedKalmanFilterConfiguration
.cpp:104-140).
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CameraCalibration:
    """Pinhole + 2-term radial distortion calibration.

    Field meanings follow CameraCalibration.h:45-61 of the reference: the
    distortion polynomial operates on *metric* sensor coordinates obtained by
    scaling pixel offsets with the pixel pitch (dx, dy) in mm.
    """

    pixels_x: int = 640
    pixels_y: int = 480
    fx: float = 525.060143149240389
    fy: float = 524.245488213640215
    k1: float = -7.613e-3
    k2: float = 9.388e-4
    cx: float = 308.649343121753361
    cy: float = 236.536005491807288
    dx: float = 0.007021618750000
    dy: float = 0.007027222916667
    pixel_error_x: float = 1.0
    pixel_error_y: float = 1.0
    angular_vision_x: float = 62.720770890650357  # degrees, half-FOV gate
    angular_vision_y: float = 49.163954709609868


@dataclass(frozen=True)
class EKFParams:
    """Filter parameters (ExtendedKalmanFilterParameters.h:44-75)."""

    init_inv_depth_rho: float = 1.0
    init_linear_accel_sd: float = 0.001
    init_angular_accel_sd: float = 0.004
    linear_accel_sd: float = 0.0007
    angular_accel_sd: float = 0.002
    inverse_depth_rho_sd: float = 1.0
    max_map_size: int = 240            # bound on covariance rows (EKF.cpp:584)
    max_map_features_count: int = 0    # 0 = unbounded (EKF.cpp:583)
    always_remove_unseen_map_features: bool = True
    map_management_frequency: int = 1
    detect_new_features_image_areas_divide_times: int = 2
    detect_new_features_image_mask_ellipse_size: float = 10.0
    matching_comp_coef_second_best_vs_first: float = 1.0
    min_matches_per_image: int = 60
    good_feature_matching_percent: float = 0.5
    ransac_threshold_predict_distance: float = 1.0
    ransac_all_inliers_probability: float = 0.99
    ransac_chi2_threshold: float = 5.9915
    inverse_depth_linearity_index_threshold: float = 0.1
    reserve_features_depth: int = 1024       # parsed, unused (slot model)
    reserve_features_inv_depth: int = 1024


@dataclass(frozen=True)
class DetectorConfig:
    """Corner detector settings (FeatureDetectorFactory.cpp profiles).

    Every reference detector type has a native TPU implementation:
    FAST (vision/fast.py), STAR/CenSurE (vision/star.py), ORB multi-scale
    oriented FAST (vision/orb.py), SIFT -> DoG and SURF -> DoH scale-space
    blobs (vision/dog.py), plus HARRIS / SHI_TOMASI (vision/harris.py) that
    the reference only uses implicitly (ORB's Harris ranking).  Detector
    choice affects which corners exist; parity is measured by trajectory
    ATE, not per-keypoint equality (SURVEY.md section 7.3).
    """

    kind: str = "FAST"
    threshold: float = 20.0          # FAST arc test threshold
    nonmax_radius: int = 2
    # STAR (FeatureDetectorFactory.cpp:135-158 parameter set)
    star_max_size: int = 16
    star_response_threshold: float = 30.0
    star_line_threshold: float = 10.0
    # SIFT (FeatureDetectorFactory.cpp:101-124)
    sift_sigma: float = 1.6
    sift_octave_layers: int = 3
    sift_contrast_threshold: float = 0.04
    sift_edge_threshold: float = 10.0
    sift_octaves: int = 2
    # SURF (FeatureDetectorFactory.cpp:59-82); cv absolute hessian
    # thresholds don't transfer to the native DoH response -- a relative
    # quality cut is used instead
    surf_quality: float = 0.05
    # ORB (cv::ORB() defaults; scale ladder in the response map)
    orb_n_levels: int = 4
    # HARRIS / SHI_TOMASI
    harris_k: float = 0.04
    quality: float = 0.01            # relative score cut for blob/corner maps


@dataclass(frozen=True)
class DescriptorConfig:
    """Descriptor settings (DescriptorExtractorFactory.cpp profiles).

    BRIEF-256: 256 smoothed-pixel comparisons on a 33x33 patch, packed into
    8 uint32 words, matched with Hamming distance (Matching.cpp:74-90).
    ORB: the same point pairs steered to each keypoint's intensity-centroid
    orientation (vision/orb.py).  SURF/SIFT: 64-d float gradient descriptor
    matched with L2 (vision/floatdesc.py), the reference's float-descriptor
    matching path (Matching.cpp:47-72).
    """

    kind: str = "BRIEF"
    n_bits: int = 256
    patch_size: int = 33
    blur_sigma: float = 2.0
    pattern_seed: int = 7
    orientation_radius: int = 7      # ORB intensity-centroid window
    float_radius: int = 10           # SURF patch half-size
    patch_radius: int = 7            # PATCH (NCC) appearance half-size

    @property
    def is_binary(self) -> bool:
        return self.kind.upper() in ("BRIEF", "ORB")

    @property
    def width(self) -> int:
        """Per-descriptor storage width (uint32 words or float32 lanes)."""
        if self.is_binary:
            return self.n_bits // 32
        if self.kind.upper() == "PATCH":
            return (2 * self.patch_radius + 1) ** 2
        from openekfmonoslam_tpu_torch.vision import floatdesc
        return floatdesc.DESC_DIM


@dataclass(frozen=True)
class SlamConfig:
    """Full engine configuration = reference profiles + TPU-build knobs."""

    camera: CameraCalibration = field(default_factory=CameraCalibration)
    ekf: EKFParams = field(default_factory=EKFParams)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    descriptor: DescriptorConfig = field(default_factory=DescriptorConfig)

    # --- TPU-build-only knobs (no reference counterpart) ---
    max_features: int = 96       # feature slots (static shape)
    # Candidate corners kept per frame.  256 = ~4x the s3 match budget;
    # the descriptor-plane gathers (~10 ns/element, 8 plane lookups) and
    # the approx_top_k selection scale linearly with this, ~30 us/frame
    # between 512 and 256, with identical tracking health on the bundled
    # runs (golden + drift-checked).
    max_keypoints: int = 256
    dtype: str = "float32"       # filter dtype ("float64" for golden tests)
    # The reference rasterizes ellipses with half-axes 2*sqrt(eig*chi2_95)
    # (EKFMath.cpp:292-293 + Draw.cpp:55), i.e. the 95% ellipse scaled 2x in
    # linear size.  gate_scale matches that acceptance region; set 1.0 for a
    # true 95% gate.
    gate_scale: float = 2.0
    chi2_95_2: float = 5.9915
    # Upper bound on RANSAC hypotheses actually evaluated (reference caps at
    # 1000, 1PointRansac.cpp:116, but never exceeds the match count).
    max_hypotheses: int = 96
    # Replay the reference's sequential adaptive hypothesis-visit bound
    # (1PointRansac.cpp:171-177) for bit-parity runs; the default argmax
    # over all hypotheses picks the same-or-better winner with no
    # sequential scan (see filter/ransac.py).
    ransac_parity_visit: bool = False
    # H P / H P H^T assembly layout (filter/measure.hp_products):
    # "blocks" = block-sparse strips (single-chip default, fewest FLOPs);
    # "dense" = dense-H matmuls whose contractions partition cleanly when
    # P is sharded (the strip reshape replicates P rows under GSPMD --
    # measured 38.6 MB/step of the 1-D per-device budget at N=1664).
    # parallel/sharding.py's step constructors select "dense"
    # automatically.
    hp_layout: str = "blocks"
    # Bug-compatible mode: reproduce the reference's transcription quirks
    # *inside the jitted engine* -- the jacobian[1]/[2] slip and the
    # unrotated drho column in the H chain (MeasurementPrediction.cpp:
    # 371-394, :553-580), the hand-chained one-shot distortion Jacobian
    # (:308-337), the DELTA=1e-12 update deadband (Update.cpp:133-203),
    # and the insertion-order RANSAC visit / conversion scan.  Off =
    # correct math (the default).  With this + ransac_parity_visit the
    # engine tracks the bug-compatible reference oracle to machine
    # precision (tests/test_oracle_parity.py).
    reference_quirks: bool = False
    seed: int = 0
    # Guided-matching backend: "descriptor" = keypoint detection + gated
    # 2-NN descriptor matching (the reference's Matching.cpp pipeline);
    # "ncc" = detection-free patch correlation over the gate region
    # (Davison active search, the BASELINE north-star matcher; requires
    # descriptor kind "PATCH").
    matcher: str = "descriptor"
    ncc_search_radius: int = 10      # candidate-center half-window (px)
    ncc_min_corr: float = 0.8        # acceptance threshold on NCC
    # Predict template appearance by the camera-motion-induced plane
    # homography before correlating (Davison active search warp); cuts
    # out-of-plane (z) drift of the NCC matcher.
    ncc_warp: bool = True
    # Lazy template refresh threshold: re-store the patch only when the
    # best NCC drops below this (refreshing every frame integrates
    # sub-pixel template drift into the trajectory; with the warp
    # predicting appearance, templates stay valid longer).  Round-4
    # 240-frame sweep: 0.80 -> z 2.30%, 0.85 -> 2.26%, 0.90 -> 1.78%,
    # 0.95 -> 2.13% of travel; 0.90 keeps templates fresher under the
    # appearance change the warp cannot model while still avoiding
    # every-frame refresh drift.
    ncc_refresh_below: float = 0.9
    # Quadratic subpixel refinement of matched measurements on the raw
    # corner-score map (the reference feeds integer keypoint positions to
    # the filter; set False for that behavior).
    subpixel_matches: bool = True

    # Pad the state vector / covariance to a multiple of this: 13 + 6F is
    # always odd, so without padding P can neither tile the MXU well nor be
    # block-row sharded evenly over a device mesh.  Padding dims are
    # permanently dead (zero P rows/cols, never active).
    pad_state_to: int = 128

    @property
    def state_dim(self) -> int:
        """Logical dims: 13 camera + 6 per feature slot."""
        return 13 + 6 * self.max_features

    @property
    def padded_state_dim(self) -> int:
        p = max(self.pad_state_to, 1)
        return ((self.state_dim + p - 1) // p) * p


# ---------------------------------------------------------------------------
# Reference-YML loader
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _parse_scalar(v: str) -> Any:
    v = v.strip().strip('"')
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if _NUM_RE.match(v):
        f = float(v)
        if f.is_integer() and ("." not in v and "e" not in low):
            return int(f)
        return f
    return v


def parse_opencv_yml(path: str) -> dict:
    """Parse an OpenCV FileStorage YML file into nested dicts.

    Handles the ``%YAML:1.0`` directive and the 2-space-indented
    ``key: "value"`` structure used by every config file in the reference
    (e.g. experiments/s3/config.yml, samples/EKF/config.yml).
    """
    root: dict = {}
    # stack of (indent, dict)
    stack: list[tuple[int, dict]] = [(-1, root)]
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith(("%", "#", "---")):
                continue
            indent = len(line) - len(line.lstrip())
            key, _, value = line.strip().partition(":")
            value = value.strip()
            while stack and indent <= stack[-1][0]:
                stack.pop()
            parent = stack[-1][1]
            if value == "":
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = _parse_scalar(value)
    return root


_EKF_KEYMAP = {
    "InitInvDepthRho": "init_inv_depth_rho",
    "InitLinearAccelSD": "init_linear_accel_sd",
    "InitAngularAccelSD": "init_angular_accel_sd",
    "LinearAccelSD": "linear_accel_sd",
    "AngularAccelSD": "angular_accel_sd",
    "InverseDepthRhoSD": "inverse_depth_rho_sd",
    "MaxMapSize": "max_map_size",
    "MaxMapFeaturesCount": "max_map_features_count",
    "AlwaysRemoveUnseenMapFeatures": "always_remove_unseen_map_features",
    "MapManagementFrequency": "map_management_frequency",
    "DetectNewFeaturesImageAreasDivideTimes":
        "detect_new_features_image_areas_divide_times",
    "DetectNewFeaturesImageMaskEllipseSize":
        "detect_new_features_image_mask_ellipse_size",
    "MatchingCompCoefSecondBestVSFirst":
        "matching_comp_coef_second_best_vs_first",
    "MinMatchesPerImage": "min_matches_per_image",
    "GoodFeatureMatchingPercent": "good_feature_matching_percent",
    "RansacThresholdPredictDistance": "ransac_threshold_predict_distance",
    "RansacAllInliersProbability": "ransac_all_inliers_probability",
    "RansacChi2Threshold": "ransac_chi2_threshold",
    "InverseDepthLinearityIndexThreshold":
        "inverse_depth_linearity_index_threshold",
    "ReserveFeaturesDepth": "reserve_features_depth",
    "ReserveFeaturesInvDepth": "reserve_features_inv_depth",
}

_CAM_KEYMAP = {
    "PixelsX": "pixels_x", "PixelsY": "pixels_y",
    "FX": "fx", "FY": "fy", "K1": "k1", "K2": "k2",
    "CX": "cx", "CY": "cy", "DX": "dx", "DY": "dy",
    "PixelErrorX": "pixel_error_x", "PixelErrorY": "pixel_error_y",
    "AngularVisionX": "angular_vision_x", "AngularVisionY": "angular_vision_y",
}


def _map_section(section: dict, keymap: dict, cls, current=None) -> Any:
    kwargs = dict(dataclasses.asdict(current)) if current is not None else {}
    for yml_key, value in section.items():
        py_key = keymap.get(yml_key)
        if py_key is not None:
            kwargs[py_key] = value
    return cls(**kwargs)


def load_config(path: str, **overrides) -> SlamConfig:
    """Load a reference-format config file into a :class:`SlamConfig`.

    Mirrors ConfigurationManager::loadConfigurationFromFile
    (ConfigurationManager.cpp:74-111): the RunConfiguration section names one
    profile per subsystem.  ``overrides`` sets TPU-build-only knobs
    (max_features, dtype, ...).
    """
    doc = parse_opencv_yml(path)
    run = doc.get("RunConfiguration", {})

    cfg = SlamConfig()

    ekf_profile = run.get("ExtendedKalmanFilter")
    if ekf_profile and ekf_profile in doc.get("ExtendedKalmanFilter", {}):
        cfg = dataclasses.replace(
            cfg,
            ekf=_map_section(doc["ExtendedKalmanFilter"][ekf_profile],
                             _EKF_KEYMAP, EKFParams, cfg.ekf),
        )

    cam_profile = run.get("CameraCalibration")
    if cam_profile and cam_profile in doc.get("CameraCalibration", {}):
        cfg = dataclasses.replace(
            cfg,
            camera=_map_section(doc["CameraCalibration"][cam_profile],
                                _CAM_KEYMAP, CameraCalibration, cfg.camera),
        )

    det_profile = run.get("FeatureDetector")
    if det_profile and det_profile in doc.get("FeatureDetector", {}):
        section = doc["FeatureDetector"][det_profile]
        kind = str(section.get("Type", "FAST")).upper()
        det = DetectorConfig(kind=kind)
        kw: dict = {}
        # per-kind parameter mapping (FeatureDetectorFactory.cpp:51-165);
        # the reference profiles carry Type + optional per-kind keys
        if kind == "FAST":
            kw["threshold"] = float(section.get("Threshold", 10))
        elif kind == "STAR":
            kw["star_max_size"] = int(section.get("MaxSize", 16))
            kw["star_response_threshold"] = float(
                section.get("ResponseThreshold", 30))
            kw["star_line_threshold"] = float(
                section.get("LineThresholdProjected", 10))
            kw["nonmax_radius"] = max(
                1, int(section.get("SuppressNonmaxSize", 5)) // 2)
        elif kind == "SIFT":
            kw["sift_octave_layers"] = int(section.get("OctaveLayers", 3))
            kw["sift_contrast_threshold"] = float(
                section.get("ContrastThreshold", 0.04))
            kw["sift_edge_threshold"] = float(
                section.get("EdgeThreshold", 10))
            kw["sift_sigma"] = float(section.get("Sigma", 1.6))
        # SURF's absolute HessianThreshold doesn't transfer (see
        # DetectorConfig); ORB uses cv defaults -- nothing to map.
        cfg = dataclasses.replace(cfg, detector=dataclasses.replace(det, **kw))

    desc_profile = run.get("DescriptorExtractor")
    if desc_profile and desc_profile in doc.get("DescriptorExtractor", {}):
        section = doc["DescriptorExtractor"][desc_profile]
        kind = str(section.get("Type", "BRIEF")).upper()
        if kind == "SIFT":
            kind = "SURF"  # both take the float gradient-descriptor path
        n_bits = 8 * int(section.get("BytesLength", 32))  # BRIEF bytes key
        cfg = dataclasses.replace(
            cfg, descriptor=DescriptorConfig(kind=kind, n_bits=n_bits))

    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def auto_max_features(ekf: EKFParams) -> int:
    """Pick a slot count that can hold the reference's working set.

    The map holds roughly the visible features (unseen ones are culled when
    AlwaysRemoveUnseenMapFeatures is set, EKF.cpp:582-586) which tracks
    MinMatchesPerImage, plus headroom for the MaxMapSize covariance bound.
    """
    by_map_size = (ekf.max_map_size - 13) // 6 if ekf.max_map_size else 0
    want = max(ekf.min_matches_per_image + 36, by_map_size + 8)
    return int(math.ceil(want / 8) * 8)
