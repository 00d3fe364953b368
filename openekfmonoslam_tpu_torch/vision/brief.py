"""BRIEF-256 binary descriptors from a shared point pool (port of
vision/brief.py, the shared-pattern dense path).

Descriptors are 256 bits in 8 words.  PyTorch has no uint32, so a word is
kept as the int32 with the same bits (as ``SlamState.descriptors`` holds
them); ``hamming_distance`` counts bits on the unsigned value.

``dense_descriptors_shared`` is the plain version of the CUDA kernel in
ops/brief_kernel.py.  ``smooth`` is computed in float64 and rounded once
to float32 per tap, which is the fused multiply-add chain XLA compiles the
JAX module's shift-and-add loop to: the smoothed image, and so every bit,
is the same in both packages.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

# int32 bit patterns of 1 << j (j = 31 is the sign bit)
_BITS = [int(np.array(1 << j, np.uint32).view(np.int32)) for j in range(32)]


def make_pattern(n_bits: int = 256, patch_size: int = 33, seed: int = 7
                 ) -> np.ndarray:
    """(n_bits, 4) int32 (dy1, dx1, dy2, dx2) offsets of classic BRIEF GII
    sampling (both points i.i.d. N(0, (S/5)^2), clipped to the patch): the
    ORB profile's pattern, the same draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    sigma = patch_size / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    return np.clip(np.round(pts), -half, half).astype(np.int32)


def make_shared_pattern(n_bits: int = 256, patch_size: int = 33,
                        seed: int = 7, n_points: int = 64
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Shared-point BRIEF pattern: (points (P, 2) dy, dx; pairs (n_bits, 2)
    indices into points), both int32.  The same draws, in the same order,
    as the JAX package's generator, so the tables are identical."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    sigma = patch_size / 5.0
    pts = set()
    while len(pts) < n_points:
        p = np.clip(np.round(rng.normal(0.0, sigma, size=2)), -half, half)
        pts.add((int(p[0]), int(p[1])))
    points = np.asarray(sorted(pts), dtype=np.int32)
    pairs = set()
    while len(pairs) < n_bits:
        i, j = rng.integers(0, n_points, size=2)
        if i != j and (i, j) not in pairs and (j, i) not in pairs:
            pairs.add((int(i), int(j)))
    return points, np.asarray(sorted(pairs), dtype=np.int32)


def gaussian_kernel(sigma: float, radius: int = 4) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def fused_taps(padded: torch.Tensor, view, kernel, center=None
               ) -> torch.Tensor:
    """sum_i kernel[i] * view(padded, i), rounded as XLA's fused chain of
    the JAX modules' shift-and-add blurs: fma(k0, v0, round(k1 v1)), then
    out = fma(k_i, v_i, out).  A float32 product is exact in float64 and,
    at these magnitudes, so is the sum, so one rounding to float32 per tap
    gives the fused result.  ``center``, a (source, scale) pair, gives the
    middle tap as source * (k_mid scale) in place of (source scale) *
    k_mid: XLA folds the two constants when the image is a scaled source
    and the middle tap is its unshifted self (vision/dog.py)."""
    mid = len(kernel) // 2

    def tap(i):
        if center is not None and i == mid:
            src, scale = center
            return src.double() * float(np.float32(kernel[i])
                                        * np.float32(scale))
        return kernel[i] * view(padded, i).double()

    # the second tap's product rounds alone: a float32 product unless it
    # is the folded middle tap
    out = (tap(1).float() if center is not None and mid == 1
           else kernel[1] * view(padded, 1))
    out = (tap(0) + out.double()).float()
    for i in range(2, len(kernel)):
        out = (out.double() + tap(i)).float()
    return out


def smooth(gray: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 9-tap Gaussian blur with edge replication, vertical pass
    then horizontal, taps in order (``fused_taps``); float32 out."""
    kernel = [float(k) for k in gaussian_kernel(sigma)]
    r = len(kernel) // 2
    img = gray.to(torch.float32)
    h, w = img.shape
    pad_v = nnf.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    out = fused_taps(pad_v, lambda p, i: p[i:i + h, :], kernel)
    pad_h = nnf.pad(out[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    return fused_taps(pad_h, lambda p, i: p[:, i:i + w], kernel)


def pattern_half(points) -> int:
    """Interior crop of the dense planes: the largest point offset."""
    return int(np.abs(np.asarray(points)).max())


def dense_descriptors_shared(smoothed: torch.Tensor, points, pairs
                             ) -> tuple:
    """W8-tuple of (ih, iw) int32 bit-planes over the interior
    (ih, iw) = (h - 2 half, w - 2 half): bit j of word w8 at (y, x) is
    view(i1) < view(i2) for pair 32 w8 + j, view(p) the smoothed image
    shifted by points[p] around (y + half, x + half)."""
    points = np.asarray(points)
    pairs = np.asarray(pairs)
    h, w = smoothed.shape
    half = pattern_half(points)
    ih, iw = h - 2 * half, w - 2 * half
    views = [smoothed[half + int(dy):half + int(dy) + ih,
                      half + int(dx):half + int(dx) + iw]
             for dy, dx in points]
    words = []
    zero = torch.zeros((ih, iw), dtype=torch.int32, device=smoothed.device)
    for wstart in range(0, pairs.shape[0], 32):
        acc = zero
        for j in range(32):
            i1, i2 = int(pairs[wstart + j, 0]), int(pairs[wstart + j, 1])
            acc = acc | torch.where(views[i1] < views[i2],
                                    torch.full_like(zero, _BITS[j]), zero)
        words.append(acc)
    return tuple(words)


def lookup_descriptors(planes, yx: torch.Tensor, margin: int = 0
                       ) -> torch.Tensor:
    """W8-tuple of interior planes + (K, 2) keypoints -> (K, W8) packed
    descriptors; ``margin`` is the planes' interior crop."""
    ih, iw = planes[0].shape
    y = torch.clamp(yx[:, 0].to(torch.int64) - margin, 0, ih - 1)
    x = torch.clamp(yx[:, 1].to(torch.int64) - margin, 0, iw - 1)
    flat = y * iw + x
    return torch.stack([p.reshape(-1)[flat] for p in planes], dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word read as uint32 (SWAR count on the
    zero-extended int64 value, so every shift is a logical one)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(F, W) x (K, W) packed descriptors -> (F, K) int32 Hamming
    distances (the reference's popcount loop, Matching.cpp:74-90)."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :])
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)
