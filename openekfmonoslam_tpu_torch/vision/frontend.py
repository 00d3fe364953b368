"""Vision front end: the configured detector and descriptor (port of
vision/frontend.py).

Contract used by engine/step.py:
    aux   = frontend.precompute(gray)        # once per frame
    score = aux["score_nms"]                 # (H, W) NMS'd corner scores
    kps   = fast.detect_keypoints(score, mask, K)   # caller-side selection
    desc  = frontend.describe(aux, kps.yx)   # (K, W) int32 | (K, 64) f32
    dist  = frontend.distance(map_desc, kp_desc)    # (F, K)

Detectors: FAST (the default), STAR, ORB (pyramid FAST ranked by
Harris), SIFT (DoG), SURF (DoH), HARRIS and SHI_TOMASI (also SHITOMASI,
GFTT).  Descriptors: BRIEF (binary words from dense bit-planes), ORB
(steered BRIEF), SURF / SIFT (64 floats, squared L2 distance) and PATCH
(zero-mean unit-norm appearance patches, the NCC matcher's templates,
vision/ncc.py).  The descriptor's storage (width, dtype) follows
``DescriptorConfig`` so that ``SlamState`` preallocates its slots.

On the GPU a frame runs hand-written kernels here: STAR scoring with NMS
(ops/star_kernel.py) on the STAR profile, and the BRIEF bit-planes
(ops/brief_kernel.py) with every detector that pairs with BRIEF.  The
other detectors' score maps and the ORB and SURF descriptors are PyTorch
chains, as they are XLA chains in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.ops import brief_kernel, star_kernel
from openekfmonoslam_tpu_torch.vision import (brief, dog, fast, floatdesc,
                                              harris, ncc, orb)


def check_matcher(config: SlamConfig) -> None:
    """The NCC matcher correlates stored appearance patches: it needs the
    PATCH descriptor (the JAX package's check, same type and text)."""
    if (config.matcher == "ncc"
            and config.descriptor.kind.upper() != "PATCH"):
        raise ValueError(
            "matcher='ncc' requires descriptor kind 'PATCH' (the state "
            f"must hold appearance patches), got {config.descriptor.kind!r}")


class Frontend:
    def __init__(self, config: SlamConfig, device):
        det = config.detector
        desc = config.descriptor
        self.config = config
        self.det_kind = det.kind.upper()
        self.desc_kind = desc.kind.upper()
        self.is_binary = desc.is_binary
        check_matcher(config)
        self.desc_width = desc.width
        self.desc_dtype = torch.int32 if self.is_binary else torch.float32
        # widest sampling window any stage reaches past a keypoint
        self.border = max(desc.patch_size // 2 + 1, desc.orientation_radius,
                          desc.float_radius, desc.patch_radius, 4)
        self.star = star_kernel.StarSettings(
            det.star_max_size, det.star_response_threshold,
            det.star_line_threshold, det.nonmax_radius)
        self.brief_pattern = None
        self.orb_pattern = None
        if self.desc_kind == "BRIEF":
            self.brief_pattern = brief_kernel.BriefPattern.make(
                *brief.make_shared_pattern(desc.n_bits, desc.patch_size,
                                           desc.pattern_seed), device)
        elif self.desc_kind == "ORB":
            self.orb_pattern = torch.as_tensor(
                brief.make_pattern(desc.n_bits, desc.patch_size,
                                   desc.pattern_seed), device=device)
        self._score_fn = self._build_score_fn()

    # -- detection -----------------------------------------------------
    def _build_score_fn(self
                        ) -> Callable[[torch.Tensor], torch.Tensor] | None:
        """The pre-NMS score map of every detector but STAR (whose kernel
        makes both maps)."""
        det = self.config.detector
        kind = self.det_kind
        if kind == "FAST":
            return lambda g: fast.fast_scores(g, det.threshold)
        if kind == "STAR":
            return None
        if kind == "ORB":
            return lambda g: orb.pyramid_fast_scores(g, det.threshold,
                                                     det.orb_n_levels)
        if kind == "SIFT":
            return lambda g: dog.dog_scores(
                g, det.sift_sigma, det.sift_octave_layers,
                det.sift_contrast_threshold, det.sift_edge_threshold,
                det.sift_octaves, det.quality)
        if kind == "SURF":
            return lambda g: dog.doh_scores(g, quality=det.surf_quality)
        if kind == "HARRIS":
            return lambda g: harris.quality_threshold(
                harris.harris_scores(g, det.harris_k), det.quality)
        if kind in ("SHI_TOMASI", "SHITOMASI", "GFTT"):
            return lambda g: harris.quality_threshold(
                harris.shi_tomasi_scores(g), det.quality)
        raise ValueError(f"unknown detector kind {det.kind!r}")

    # -- per-frame precompute -------------------------------------------
    def precompute(self, gray: torch.Tensor) -> dict:
        """Score maps and descriptor support of one (H, W) frame: the
        pre-NMS and NMS'd maps, then BRIEF's bit-planes, or the smoothed
        image (ORB adds its moment maps)."""
        cfg = self.config
        if self._score_fn is None:
            raw, nms = star_kernel.star_scores_fused(gray, self.star)
        else:
            raw = self._score_fn(gray)
            nms = fast.non_max_suppress(raw, cfg.detector.nonmax_radius)
        aux = {"score_raw": raw, "score_nms": nms}
        smoothed = brief.smooth(gray, cfg.descriptor.blur_sigma)
        if self.desc_kind == "BRIEF":
            aux["planes"] = brief_kernel.dense_planes(smoothed,
                                                      self.brief_pattern)
        else:
            aux["smoothed"] = smoothed
            if self.desc_kind == "ORB":
                aux["m10"], aux["m01"] = orb.centroid_moment_maps(
                    smoothed, cfg.descriptor.orientation_radius)
        return aux

    # -- per-keypoint extraction -----------------------------------------
    def describe(self, aux: dict, yx: torch.Tensor) -> torch.Tensor:
        """(K, 2) keypoints -> (K, width) descriptors: int32 words (the
        uint32 bits) for binary kinds, float32 for SURF / SIFT and PATCH."""
        if self.desc_kind == "BRIEF":
            return brief.lookup_descriptors(aux["planes"], yx,
                                            self.brief_pattern.half)
        if self.desc_kind == "ORB":
            ang = orb.angles_at(aux["m10"], aux["m01"], yx)
            return orb.steered_extract(aux["smoothed"], yx, ang,
                                       self.orb_pattern)
        if self.desc_kind == "PATCH":
            return ncc.extract_patches(aux["smoothed"], yx,
                                       self.config.descriptor.patch_radius)
        return floatdesc.surf64(aux["smoothed"], yx,
                                self.config.descriptor.float_radius)

    # -- matching distance -------------------------------------------------
    def distance(self, map_desc: torch.Tensor, kp_desc: torch.Tensor
                 ) -> torch.Tensor:
        """(F, W) x (K, W) -> (F, K): int32 Hamming for binary kinds,
        float32 squared L2 for float ones (the two branches of
        Matching.cpp computeDistance:47-93)."""
        if self.is_binary:
            return brief.hamming_distance(map_desc, kp_desc)
        return floatdesc.l2_distance(map_desc, kp_desc)

    def zero_descriptors(self, n: int, device) -> torch.Tensor:
        return torch.zeros((n, self.desc_width), dtype=self.desc_dtype,
                           device=device)


def make_frontend(config: SlamConfig, device) -> Frontend:
    return Frontend(config, device)
