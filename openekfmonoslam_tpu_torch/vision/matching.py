"""Active-search guided matching with analytic ellipse gating (port of
vision/matching.py).

Reference: Matching.cpp.  The per-pixel "inside any gate ellipse" mask
routes the detection budget; each prediction then takes its gated 2-NN
descriptor match with a ratio test.  The gate is the Mahalanobis test
d^T S^-1 d <= gate_scale^2 * chi2_95(2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.vision import brief

# the gated-out distance: an integer one for Hamming distances, a float
# one for squared L2 (the JAX module's sentinels)
BIG_DISTANCE = 1 << 20
BIG_FLOAT_DISTANCE = 1e30


class Matches(NamedTuple):
    z: torch.Tensor          # (F, 2) matched pixel (x, y); 0 where unmatched
    matched: torch.Tensor    # (F,) bool
    desc: torch.Tensor       # (F, W) matched keypoint descriptor
    distance: torch.Tensor   # (F,) Hamming (int32) or squared L2 (float)
    refreshed: torch.Tensor  # (F,) bool: desc holds a new template


def _inv_2x2(S: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = S[..., 0, 0], S[..., 0, 1]
    c, d = S[..., 1, 0], S[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20),
                      det)
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def ellipse_union_mask(shape: tuple, centers: torch.Tensor, S: torch.Tensor,
                       visible: torch.Tensor, gate: float,
                       block: int = 4) -> torch.Tensor:
    """(H, W) bool: pixels inside any visible prediction's gate ellipse.

    Evaluated on a ``block``-downsampled grid: a block is marked when its
    centre passes the gate inflated by the worst-case centre-to-pixel
    Mahalanobis slack ||p - c|| / sqrt(lambda_min(S)), so the block mask
    is a superset of the exact pixel region.  ``block=1`` gives the exact
    pixel mask."""
    h, w = shape
    dtype, dev = S.dtype, S.device
    Sinv = _inv_2x2(S)
    hb = (h + block - 1) // block
    wb = (w + block - 1) // block
    ctr = (block - 1) * 0.5
    xs = torch.arange(wb, dtype=dtype, device=dev) * block + ctr
    ys = torch.arange(hb, dtype=dtype, device=dev) * block + ctr
    dx = xs[None, None, :] - centers[:, 0][:, None, None]      # (F, 1, Wb)
    dy = ys[None, :, None] - centers[:, 1][:, None, None]      # (F, Hb, 1)
    a = Sinv[:, 0, 0][:, None, None]
    b = Sinv[:, 0, 1][:, None, None]
    c = Sinv[:, 1, 1][:, None, None]
    md = a * dx * dx + 2.0 * b * dx * dy + c * dy * dy         # (F, Hb, Wb)
    if block == 1:
        return torch.any((md <= gate) & visible[:, None, None], dim=0)
    tr2 = 0.5 * (S[:, 0, 0] + S[:, 1, 1])
    disc = torch.sqrt(torch.clamp(
        tr2 * tr2 - (S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]),
        min=0.0))
    lam_min = torch.clamp(tr2 - disc, min=1e-12)
    max_off = math.sqrt(2.0) * (block - 1) * 0.5
    thresh = (torch.sqrt(torch.full((), gate, dtype=dtype, device=dev))
              + max_off / torch.sqrt(lam_min))
    ok = torch.sqrt(torch.clamp(md, min=0.0)) <= thresh[:, None, None]
    inside = torch.any(ok & visible[:, None, None], dim=0)
    full = inside[:, None, :, None].expand(hb, block, wb, block)
    return full.reshape(hb * block, wb * block)[:h, :w]


def match_predictions(pred_uv: torch.Tensor, pred_S: torch.Tensor,
                      visible: torch.Tensor, map_desc: torch.Tensor,
                      kp_xy: torch.Tensor, kp_valid: torch.Tensor,
                      kp_desc: torch.Tensor, gate: float,
                      ratio_coef: float,
                      distance_fn=brief.hamming_distance) -> Matches:
    """Gated 2-NN descriptor matching (matchPredictedFeatures,
    Matching.cpp:181-264); ties break to the lowest keypoint index."""
    dtype = pred_uv.dtype
    dx = kp_xy[None, :, 0] - pred_uv[:, None, 0]               # (F, K)
    dy = kp_xy[None, :, 1] - pred_uv[:, None, 1]
    Sinv = _inv_2x2(pred_S)
    md = (Sinv[:, 0, 0][:, None] * dx * dx
          + 2.0 * Sinv[:, 0, 1][:, None] * dx * dy
          + Sinv[:, 1, 1][:, None] * dy * dy)
    gated = (md <= gate) & kp_valid[None, :] & visible[:, None]

    dist = distance_fn(map_desc, kp_desc)                      # (F, K)
    big_value = (BIG_FLOAT_DISTANCE if dist.dtype.is_floating_point
                 else BIG_DISTANCE)
    big = torch.full_like(dist, big_value)
    dist_g = torch.where(gated, dist, big)

    # 2-NN as two masked argmin passes
    d1 = torch.amin(dist_g, dim=1)
    best_idx = torch.argmin(dist_g, dim=1)
    k_iota = torch.arange(dist_g.shape[1], device=dist_g.device)
    dist_g2 = torch.where(k_iota[None, :] == best_idx[:, None], big, dist_g)
    d2 = torch.amin(dist_g2, dim=1)

    n_cand = torch.sum(gated, dim=1)
    # ratio test (Matching.cpp:169-175): a single candidate is accepted
    # outright; otherwise best <= second * coef
    accept = (n_cand == 1) | ((n_cand >= 2)
                              & (d1.to(dtype) <= d2.to(dtype) * ratio_coef))
    matched = visible & (n_cand > 0) & accept

    best_xy = kp_xy[best_idx].to(dtype)
    z = torch.where(matched[:, None], best_xy, torch.zeros_like(best_xy))
    best_desc = kp_desc[best_idx]
    desc = torch.where(matched[:, None], best_desc,
                       torch.zeros_like(best_desc))
    return Matches(z=z, matched=matched, desc=desc,
                   distance=torch.where(matched, d1,
                                        torch.full_like(d1, big_value)),
                   refreshed=matched)
