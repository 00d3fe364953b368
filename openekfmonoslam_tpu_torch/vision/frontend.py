"""Vision front end: the configured detector and descriptor (port of
vision/frontend.py, for the STAR detector with BRIEF descriptors, the s3
profile).

Contract used by engine/step.py:
    aux   = frontend.precompute(gray)        # once per frame
    score = aux["score_nms"]                 # (H, W) NMS'd corner scores
    kps   = fast.detect_keypoints(score, mask, K)   # caller-side selection
    desc  = frontend.describe(aux, kps.yx)   # (K, W) int32 words
    dist  = frontend.distance(map_desc, kp_desc)    # (F, K)

On the GPU a frame runs two kinds of hand-written kernel here: STAR
scoring with NMS (ops/star_kernel.py) and the BRIEF bit-planes
(ops/brief_kernel.py).
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.ops import brief_kernel, star_kernel
from openekfmonoslam_tpu_torch.vision import brief

_LATER = ("is not ported yet: the port has the STAR detector with BRIEF "
          "descriptors; the other front-end profiles and the NCC matcher are "
          "ROADMAP.md Queue 1 items 14 and 15")


class Frontend:
    def __init__(self, config: SlamConfig, device):
        det = config.detector
        desc = config.descriptor
        self.config = config
        self.det_kind = det.kind.upper()
        self.desc_kind = desc.kind.upper()
        if self.det_kind != "STAR":
            raise NotImplementedError(f"detector {det.kind!r} {_LATER}")
        if self.desc_kind != "BRIEF":
            raise NotImplementedError(f"descriptor {desc.kind!r} {_LATER}")
        if config.matcher != "descriptor":
            raise NotImplementedError(f"matcher {config.matcher!r} {_LATER}")
        self.desc_width = desc.width
        # widest sampling window any stage reaches past a keypoint
        self.border = max(desc.patch_size // 2 + 1, desc.orientation_radius,
                          desc.float_radius, desc.patch_radius, 4)
        self.star = star_kernel.StarSettings(
            det.star_max_size, det.star_response_threshold,
            det.star_line_threshold, det.nonmax_radius)
        self.pattern = brief_kernel.BriefPattern.make(
            *brief.make_shared_pattern(desc.n_bits, desc.patch_size,
                                       desc.pattern_seed), device)

    def precompute(self, gray: torch.Tensor) -> dict:
        """Score maps and BRIEF planes of one (H, W) frame."""
        raw, nms = star_kernel.star_scores_fused(gray, self.star)
        smoothed = brief.smooth(gray, self.config.descriptor.blur_sigma)
        return {"score_raw": raw, "score_nms": nms,
                "planes": brief_kernel.dense_planes(smoothed, self.pattern)}

    def describe(self, aux: dict, yx: torch.Tensor) -> torch.Tensor:
        """(K, 2) keypoints -> (K, W) int32 descriptor words."""
        return brief.lookup_descriptors(aux["planes"], yx, self.pattern.half)

    def distance(self, map_desc: torch.Tensor, kp_desc: torch.Tensor
                 ) -> torch.Tensor:
        """(F, W) x (K, W) -> (F, K) Hamming distances."""
        return brief.hamming_distance(map_desc, kp_desc)

    def zero_descriptors(self, n: int, device) -> torch.Tensor:
        return torch.zeros((n, self.desc_width), dtype=torch.int32,
                           device=device)


def make_frontend(config: SlamConfig, device) -> Frontend:
    return Frontend(config, device)
