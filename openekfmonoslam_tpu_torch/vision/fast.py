"""Keypoint selection from a score map (port of vision/fast.py, minus the
FAST-9 score of the FAST profile, which is not ported yet).

``non_max_suppress`` keeps local maxima; ``detect_keypoints`` takes the
top K of a masked score map in a fixed order (score descending, ties to
the lower flat index, as the JAX package's exact top-k on the CPU);
``subpixel_refine`` fits parabolas through the pre-NMS map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as nnf


class Keypoints(NamedTuple):
    yx: torch.Tensor      # (K, 2) int32 row, col
    score: torch.Tensor   # (K,) float32
    valid: torch.Tensor   # (K,) bool


def non_max_suppress(score: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Keep only local maxima in a (2r+1)^2 window (ties keep all).  Pixels
    outside the image are ignored (-inf padding), not replicated."""
    k = 2 * radius + 1
    pooled = nnf.max_pool2d(score[None, None], k, stride=1,
                            padding=radius)[0, 0]
    keep = (score >= pooled) & (score > 0)
    return torch.where(keep, score, torch.zeros_like(score))


def subpixel_refine(score_raw: torch.Tensor, xy: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Quadratic subpixel refinement of keypoint positions ``xy`` (K, 2)
    pixel (x, y) on the pre-NMS map: 1-D parabolas through the 3-point
    neighbourhoods, each offset clipped to +-0.5."""
    h, w = score_raw.shape
    ix = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 1, w - 2)
    iy = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 1, h - 2)
    flat = score_raw.reshape(-1)

    def at(dy, dx):
        return flat[(iy + dy) * w + ix + dx]

    c0 = at(0, 0)

    def para(m, p):
        denom = m - 2.0 * c0 + p
        safe = torch.where(torch.abs(denom) > 1e-9, denom,
                           torch.ones_like(denom))
        off = torch.where(torch.abs(denom) > 1e-9, 0.5 * (m - p) / safe,
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    dx = para(at(0, -1), at(0, 1))
    dy = para(at(-1, 0), at(1, 0))
    shift = torch.stack([dx, dy], dim=-1).to(xy.dtype)
    return xy + shift * valid[:, None].to(xy.dtype)


def detect_keypoints(score_nms: torch.Tensor, pixel_mask: torch.Tensor,
                     max_keypoints: int) -> Keypoints:
    """Top-K corners from an NMS'd (non-negative) score map restricted to
    ``pixel_mask``, in score order with ties to the lower flat index.

    The order is pinned by a unique int64 key per pixel: the score's
    float32 bits (monotone in the score for non-negative floats) above the
    reversed flat index."""
    h, w = score_nms.shape
    masked = torch.where(pixel_mask, score_nms, torch.zeros_like(score_nms))
    flat = masked.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    shift = max(n - 1, 1).bit_length()
    idx = torch.arange(n, device=flat.device, dtype=torch.int64)
    key = (flat.view(torch.int32).to(torch.int64) << shift) | (n - 1 - idx)
    top_key = torch.topk(key, max_keypoints, sorted=True).values
    top_idx = (n - 1) - (top_key & ((1 << shift) - 1))
    top_scores = flat[top_idx]
    yx = torch.stack([top_idx // w, top_idx % w], dim=-1).to(torch.int32)
    return Keypoints(yx=yx, score=top_scores, valid=top_scores > 0)
