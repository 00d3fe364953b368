"""FAST-9/16 corner scores and keypoint selection from a score map (port
of vision/fast.py).

``fast_scores`` is the segment test of the FAST profile: the 16-pixel
Bresenham ring of radius 3 around every pixel (wrapping round the image,
as ``jnp.roll`` does; the 3 px border mask hides the wrap), the brighter
and darker comparisons packed into 16-bit masks, the 9-contiguous test on
the doubled masks, and the excess score summed over the qualifying ring
pixels in ring order, so the score is the JAX module's bit for bit.
``non_max_suppress`` keeps local maxima; ``detect_keypoints`` takes the
top K of a masked score map in a fixed order (score descending, ties to
the lower flat index, as the JAX package's exact top-k on the CPU);
``subpixel_refine`` fits parabolas through the pre-NMS map.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as nnf

from openekfmonoslam_tpu_torch.ops import batched


# Bresenham circle radius 3, clockwise from 12 o'clock: (dy, dx)
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9


class Keypoints(NamedTuple):
    yx: torch.Tensor      # (K, 2) int32 row, col
    score: torch.Tensor   # (K,) float32
    valid: torch.Tensor   # (K,) bool


def _contiguous_arc(mask16: torch.Tensor) -> torch.Tensor:
    """True where a 16-bit circular mask holds >= ARC_LEN consecutive 1s:
    the mask doubled into 32 bits (int64 here), ANDed with 8 shifted
    copies; a surviving low bit marks a run start."""
    d = mask16 | (mask16 << 16)
    r = d
    for s in range(1, ARC_LEN):
        r = r & (d >> s)
    return (r & 0xFFFF) != 0


def fast_scores(gray: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9 corner score (0 where not a corner), float32: the
    sum over qualifying ring pixels of |I(ring) - I(p)| - t, in ring order,
    where a ring pixel qualifies when it is brighter than I(p) + t or
    darker than I(p) - t; 0 within 3 px of the border."""
    img = gray.to(torch.float32)
    h, w = img.shape
    t = float(np.float32(threshold))
    # ring k of pixel (y, x) is img[(y + dy) % h, (x + dx) % w]
    wrapped = nnf.pad(img[None, None], (3, 3, 3, 3), mode="circular")[0, 0]
    rings = torch.stack([wrapped[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                         for dy, dx in RING_OFFSETS])        # (16, H, W)
    brighter = rings > img + t
    darker = rings < img - t
    weights = (1 << torch.arange(16, device=img.device,
                                 dtype=torch.int64))[:, None, None]
    corner = (_contiguous_arc(torch.sum(brighter * weights, dim=0))
              | _contiguous_arc(torch.sum(darker * weights, dim=0)))
    terms = torch.where(brighter | darker, torch.abs(rings - img) - t,
                        torch.zeros_like(rings))
    excess = torch.zeros_like(img)
    for k in range(len(RING_OFFSETS)):
        excess = excess + terms[k]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(corner & inside, excess, torch.zeros_like(img))


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


def float32_bits(x: torch.Tensor) -> torch.Tensor:
    """``x.view(torch.int32)`` as int64, by exact float64 arithmetic: a
    normal |x| in [2^e, 2^(e + 1)) has the bits (e + 127) 2^23 + (|x| 2^-e
    - 1) 2^23, a subnormal one |x| 2^149; less 2^31 when the sign bit is
    set.  For finite x.  The batched step takes this form under
    ``torch.func.vmap``, which in PyTorch before 2.13 has no batching rule
    for a dtype view."""
    a = torch.abs(x).to(torch.float64)
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    e = e - (torch.exp2(e) > a).to(e.dtype) + (torch.exp2(e + 1) <= a).to(
        e.dtype)
    bits = torch.where(a < 2.0 ** -126, a * 2.0 ** 149,
                       (e + 127) * 2.0 ** 23
                       + (a / torch.exp2(e) - 1) * 2.0 ** 23).to(torch.int64)
    return torch.where(torch.signbit(x), bits - 2 ** 31, bits)


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
    bits = (float32_bits(flat) if batched.any_batched(flat)
            else flat.view(torch.int32).to(torch.int64))
    key = (bits << shift) | (n - 1 - idx)
    top_key = torch.topk(key, max_keypoints, sorted=True).values
    top_idx = (n - 1) - (top_key & ((1 << shift) - 1))
    top_scores = flat[top_idx]
    yx = torch.stack([top_idx // w, top_idx % w], dim=-1).to(torch.int32)
    return Keypoints(yx=yx, score=top_scores, valid=top_scores > 0)
