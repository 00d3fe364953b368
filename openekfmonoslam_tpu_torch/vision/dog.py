"""Scale-space blob detection: DoG (SIFT-analog) and DoH (SURF-analog)
(port of vision/dog.py).

  * ``dog_scores``: difference-of-Gaussians extrema over a per-octave
    scale stack with contrast and edge-ratio rejection (SIFT's detection
    stage: nOctaveLayers, contrastThreshold, edgeThreshold, sigma);
  * ``doh_scores``: scale-normalised determinant-of-Hessian responses from
    box-smoothed second differences (SURF's detection measure).

Everything is whole-image shift-and-add work over a fixed ladder of
scales.  The maps are the JAX module's bit for bit under ``jit`` on the
CPU, which fixes the rounding of each chain:
  * a division by a constant is a multiplication by its float32
    reciprocal (``/ 255`` and the box area);
  * a Gaussian tap chain is ``brief.fused_taps``;
  * a product consumed by an add or subtract is contracted into it
    (``harris.fma32``) where XLA's fused loop does so;
  * a 2x2 mean sums its four pixels in row-major order, as XLA's
    reduction does, then scales by 1/4.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from openekfmonoslam_tpu_torch.vision.brief import fused_taps
from openekfmonoslam_tpu_torch.vision.harris import (_box_sum, _f32, _shift,
                                                    fma32)


# the float32 reciprocal XLA multiplies by for the modules' ``/ 255``
INV_255 = _f32(1.0 / 255.0)


def _gauss_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(img: torch.Tensor, sigma: float, source=None) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, vertical pass first.
    ``source``, a (src, scale) pair with img = src * scale (float32), gives
    the vertical pass's middle tap XLA's folded constant."""
    if sigma <= 0:
        return img
    kernel = [float(k) for k in _gauss_kernel(sigma)]
    r = len(kernel) // 2
    h, w = img.shape
    pad_v = nnf.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = fused_taps(pad_v, lambda p, i: p[i:i + h, :], kernel, source)
    pad_h = nnf.pad(out[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    return fused_taps(pad_h, lambda p, i: p[:, i:i + w], kernel)


def _downsample2(img: torch.Tensor, scale: float | None = None
                 ) -> torch.Tensor:
    """2x2 block means (odd last row and column dropped): the block's
    pixels summed in row-major order, as XLA's reduction does, then scaled
    by 1/4.  With ``scale`` the means are of img * scale, each product
    contracted into the running sum as XLA's fused reduction does."""
    h, w = img.shape
    b = img[: h - h % 2, : w - w % 2]
    parts = (b[0::2, 0::2], b[0::2, 1::2], b[1::2, 0::2], b[1::2, 1::2])
    if scale is None:
        s = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    else:
        s = parts[0] * scale
        for p in parts[1:]:
            s = (p.double() * scale + s.double()).float()
    return s * 0.25


def _upsample_to(img: torch.Tensor, h: int, w: int, factor: int
                 ) -> torch.Tensor:
    """Nearest-upsample a level map to level-0 shape (h, w), centre-aligned:
    each block is shifted by (factor - 1) // 2 so that it lies over its
    receptive field; zero-padded or cropped to (h, w)."""
    if factor > 1:
        img = torch.repeat_interleave(
            torch.repeat_interleave(img, factor, dim=0), factor, dim=1)
        s = (factor - 1) // 2
        if s:
            img = nnf.pad(img, (s, 0, s, 0))
    img = nnf.pad(img, (0, max(0, w - img.shape[1]),
                        0, max(0, h - img.shape[0])))
    return img[:h, :w]


def _octave_dog(base: torch.Tensor, sigma: float, n_layers: int,
                contrast_cut: float, edge_threshold: float,
                source=None) -> torch.Tensor:
    """Extremum score map for one octave (base image resolution); ``source``
    as for ``blur``."""
    k = 2.0 ** (1.0 / n_layers)
    # incremental blurs: level i has absolute sigma = sigma * k^i
    levels = [blur(base, sigma, source)]
    for i in range(1, n_layers + 3):
        prev_s = sigma * k ** (i - 1)
        inc = prev_s * np.sqrt(k * k - 1.0)
        levels.append(blur(levels[-1], float(inc)))
    dogs = [levels[i + 1] - levels[i] for i in range(n_layers + 2)]

    er = _f32((edge_threshold + 1.0) ** 2 / edge_threshold)
    cut = _f32(contrast_cut)
    score = torch.zeros_like(base)
    for i in range(1, n_layers + 1):
        d = dogs[i]
        # 26-neighbourhood extremum (3x3 in-plane on all 3 DoG layers); the
        # centre is part of its own neighbourhood
        stack = torch.stack([_shift(layer, dy, dx)
                             for layer in (dogs[i - 1], d, dogs[i + 1])
                             for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
        is_ext = (d >= torch.amax(stack, dim=0)) | (d <= torch.amin(stack,
                                                                    dim=0))
        # edge rejection: spatial Hessian ratio (SIFT tr^2/det test)
        dxx = fma32(torch.full_like(d, -2.0), d,
                    _shift(d, 0, 1) + _shift(d, 0, -1))
        dyy = fma32(torch.full_like(d, -2.0), d,
                    _shift(d, 1, 0) + _shift(d, -1, 0))
        dxy = 0.25 * (_shift(d, 1, 1) + _shift(d, -1, -1)
                      - _shift(d, 1, -1) - _shift(d, -1, 1))
        det = fma32(dxx, dyy, -(dxy * dxy))
        tr = dxx + dyy
        not_edge = (det > 0) & (tr * tr < er * det)
        ok = is_ext & not_edge & (torch.abs(d) >= cut)
        score = torch.maximum(score, torch.where(ok, torch.abs(d),
                                                 torch.zeros_like(d)))
    return score


def _quality_cut(score: torch.Tensor, quality: float) -> torch.Tensor:
    if quality > 0:
        keep = score >= _f32(quality) * torch.amax(score)
        score = torch.where(keep, score, torch.zeros_like(score))
    return score


def dog_scores(gray: torch.Tensor, sigma: float = 1.6, n_layers: int = 3,
               contrast_threshold: float = 0.04,
               edge_threshold: float = 10.0, n_octaves: int = 2,
               quality: float = 0.0) -> torch.Tensor:
    """SIFT-analog detection score map at full resolution.

    ``contrast_threshold`` follows SIFT's [0,1]-intensity convention; the
    prefilter cut is 0.5 * t / n_layers as in the original."""
    src = gray.to(torch.float32)
    img = src * INV_255
    cut = 0.5 * contrast_threshold / n_layers
    h, w = img.shape
    base = img
    score = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for o in range(n_octaves):
        s = _octave_dog(base, sigma, n_layers, cut, edge_threshold,
                        (src, INV_255) if o == 0 else None)
        score = torch.maximum(score, _upsample_to(s, h, w, 2 ** o))
        base = (_downsample2(src, INV_255) if o == 0
                else _downsample2(base))
    return _quality_cut(score, quality)


def _scaled_box_sum(src: torch.Tensor, scale: float, s: int
                    ) -> torch.Tensor:
    """``harris._box_sum(src * scale, s)`` rounded as XLA's fused loops on
    the CPU round it inside ``doh_scores``: the vertical pass adds the
    rounded image in offset order, except that at s = 2 and 4 its middle
    tap is the product src * scale contracted into the running sum; the
    horizontal pass adds in offset order."""
    if s not in (2, 4):
        return _box_sum(src * scale, s)
    img = src * scale
    acc = _shift(img, -s, 0)
    for d in range(-s + 1, s + 1):
        if d == 0:
            acc = (src.double() * scale + acc.double()).float()
        else:
            acc = acc + _shift(img, d, 0)
    out = _shift(acc, 0, -s)
    for d in range(-s + 1, s + 1):
        out = out + _shift(acc, 0, d)
    return out


def doh_scores(gray: torch.Tensor, sizes=(2, 4, 8),
               quality: float = 0.05) -> torch.Tensor:
    """SURF-analog: scale-normalised determinant-of-Hessian score map.

    Second differences at spacing s on a box-smoothed image approximate
    SURF's box-filter Hessian; the 0.9 factor on Dxy is the SURF paper's
    box-approximation correction.  Responses are normalised by s^2 per
    derivative (s^4 for the determinant) so scales compete fairly; the cut
    is relative (``quality`` of the frame's max).

    Rounding, as XLA's fused loops on the CPU: the smoothed image ``sm``
    = box * c (c the area's float32 reciprocal) is rounded where it is
    shifted in x and diagonally; the vertical neighbours of Dyy are
    box * c products, the upper one contracted into their sum; 2 sm is
    one rounded product box * 2c shared by Dxx and Dyy; the determinant
    contracts Dxx Dyy.  At the frame shapes the engine runs (even sizes)
    the map is the JAX module's bit for bit; at odd sizes XLA's edge
    branches can stop a contraction within 2s px of the edge, inside
    every front end's border, and the last bit there can differ."""
    src = gray.to(torch.float32)
    score = torch.zeros_like(src)
    e_scale = _f32(np.float32(0.9) * np.float32(0.25))
    for s in sizes:
        c = _f32(1.0 / float((2 * s + 1) ** 2))
        box = _scaled_box_sum(src, INV_255, s)
        sm = box * c
        two = box * (2.0 * c)
        dxx = (_shift(sm, 0, s) + _shift(sm, 0, -s)) - two
        up = _shift(box, s, 0)
        dyy = fma32(up, torch.full_like(up, c), _shift(box, -s, 0) * c) - two
        e = (_shift(sm, s, s) + _shift(sm, -s, -s)
             - _shift(sm, s, -s) - _shift(sm, -s, s)) * e_scale
        det = fma32(dxx, dyy, -(e * e)) * _f32(1e6 / float(s) ** 4)
        score = torch.maximum(score, torch.clamp(det, min=0.0))
    return _quality_cut(score, quality)
