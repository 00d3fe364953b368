"""ORB: oriented FAST scoring and rotation-steered BRIEF descriptors (port
of vision/orb.py).

ORB is multi-scale FAST corners ranked by the Harris response, each given
an orientation by its intensity centroid and described by BRIEF point-pair
tests rotated ("steered") to that orientation.  As in the JAX module:
  * the scale ladder lives in the detection response only: FAST scores per
    dyadic pyramid level, max-merged into one level-0 map;
  * the intensity centroid uses a square window (separable weighted sums);
  * steering rotates the pattern offsets per keypoint, with no angle
    quantisation.

Rounding follows the JAX module under ``jit`` on the CPU: the weighted
moment sums contract each product into the running sum
(``harris.fma32``), and from the third pyramid level down the Harris box
sums contract their middle product too (XLA fuses those levels' gradient
products into the box sums; ``harris.structure_tensor``'s ``contract``).
``angles_at`` and the sine and cosine of ``steered_extract`` are taken in
float64 and rounded to float32, so the card and the CPU agree; XLA's
float32 ``atan2`` is within an ulp of it.
"""

from __future__ import annotations

import numpy as np
import torch

from openekfmonoslam_tpu_torch.vision import fast as fast_mod
from openekfmonoslam_tpu_torch.vision.dog import _downsample2, _upsample_to
from openekfmonoslam_tpu_torch.vision.harris import _shift, harris_scores


def _weighted(terms) -> torch.Tensor:
    """sum_i w_i v_i over (weight, view) pairs, rounded as XLA's fused
    chain: the first product contracted into its sum with the rounded
    second, each later one into the running sum (a product by 0 or +-1 is
    exact, so it rounds the same either way)."""
    (w0, v0), *rest = terms
    if not rest:
        return w0 * v0
    (w1, v1), *rest = rest
    out = (w0 * v0.double() + (w1 * v1).double()).float()
    for w, v in rest:
        out = (out.double() + w * v.double()).float()
    return out


def centroid_moment_maps(smoothed: torch.Tensor, radius: int = 7
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense first-moment maps (m10, m01) over a (2r+1)^2 window:
    m10(p) = sum_{dy,dx} dx I(p + (dy, dx)), m01 likewise with dy;
    separable: an unweighted sum along one axis and an offset-weighted sum
    along the other."""
    img = smoothed.to(torch.float32)
    offsets = range(-radius, radius + 1)
    shifted = [_shift(img, d, 0) for d in offsets]
    col = shifted[0]
    for s in shifted[1:]:
        col = col + s
    colw = _weighted([(float(d), s) for d, s in zip(offsets, shifted)])
    m10 = _weighted([(float(d), _shift(col, 0, d)) for d in offsets])
    m01 = _shift(colw, 0, -radius)
    for d in offsets[1:]:
        m01 = m01 + _shift(colw, 0, d)
    return m10, m01


def _at(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    w = img.shape[1]
    return img.reshape(-1)[yx[:, 0].to(torch.int64) * w
                           + yx[:, 1].to(torch.int64)]


def angles_at(m10: torch.Tensor, m01: torch.Tensor, yx: torch.Tensor
              ) -> torch.Tensor:
    """(K,) orientation atan2(m01, m10) at keypoint pixels, float32."""
    return torch.atan2(_at(m01, yx).double(),
                       _at(m10, yx).double()).float()


def steered_extract(smoothed: torch.Tensor, yx: torch.Tensor,
                    angle: torch.Tensor, pattern: torch.Tensor
                    ) -> torch.Tensor:
    """Rotation-steered BRIEF: (K, n_bits / 32) int32 words (the uint32
    bits).  ``pattern`` is the (n_bits, 4) int32 (dy1, dx1, dy2, dx2)
    table of ``brief.make_pattern``; each keypoint's offsets are rotated by
    its angle and rounded to the nearest pixel (half to even) before
    sampling."""
    h, w = smoothed.shape
    a = angle.to(torch.float32).double()
    c = torch.cos(a).float()[:, None]                        # (K, 1)
    s = torch.sin(a).float()[:, None]
    p = pattern.to(torch.float32)

    def rot(dy, dx):
        # s dx + c dy and c dx - s dy, each with its first product
        # contracted into the sum
        ry = torch.round((s.double() * dx.double()
                          + (c * dy).double()).float())
        rx = torch.round((c.double() * dx.double()
                          - (s * dy).double()).float())
        return ry.to(torch.int64), rx.to(torch.int64)

    ry1, rx1 = rot(p[None, :, 0], p[None, :, 1])             # (K, B)
    ry2, rx2 = rot(p[None, :, 2], p[None, :, 3])
    y = yx[:, 0:1].to(torch.int64)
    x = yx[:, 1:2].to(torch.int64)
    flat = smoothed.reshape(-1)
    v1 = flat[torch.clamp(y + ry1, 0, h - 1) * w
              + torch.clamp(x + rx1, 0, w - 1)]
    v2 = flat[torch.clamp(y + ry2, 0, h - 1) * w
              + torch.clamp(x + rx2, 0, w - 1)]
    bits = (v1 < v2).to(torch.int64)                         # (K, B)
    k, b = bits.shape
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, device=bits.device))
    words = torch.sum(bits.reshape(k, b // 32, 32) * weights, dim=-1)
    # the uint32 word's bits as an int32
    return (words - ((words >> 31) << 32)).to(torch.int32)


def pyramid_fast_scores(gray: torch.Tensor, threshold: float,
                        n_levels: int = 4, harris_rank: bool = True,
                        level_attenuation: float = 0.25) -> torch.Tensor:
    """Multi-scale FAST score map, max-merged at level 0.

    Each dyadic level contributes its FAST-qualifying pixels, scored by
    the Harris response there when ``harris_rank`` (ORB ranks by Harris),
    else by the FAST excess; level-l scores are nearest-upsampled
    (centre-aligned).  ``level_attenuation`` down-weights each coarser
    level, so a corner reports at the finest scale where it qualifies."""
    h, w = gray.shape
    img = gray.to(torch.float32)
    merged = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    for lvl in range(n_levels):
        score = fast_mod.fast_scores(img, threshold)
        if harris_rank:
            h_lvl = harris_scores(img, contract=lvl >= 3)
            score = torch.where(score > 0, h_lvl, zero)
        lw = float(np.float32(level_attenuation ** lvl))
        merged = torch.maximum(merged,
                               lw * _upsample_to(score, h, w, 2 ** lvl))
        if lvl + 1 < n_levels:
            img = _downsample2(img)
    return merged
