"""STAR (CenSurE) center-surround detector (port of vision/star.py).

Box center-surround responses at a ladder of scales from one integral
image, their scale maximum, a structure-tensor line test on that map and a
response threshold.  ``star_scores`` is the plain version of the CUDA
kernel in ops/star_kernel.py, which takes over from the integral image on
the GPU.

Two choices pin the arithmetic, so that the kernel, this chain and the JAX
package agree bit for bit wherever their inputs do:
  * the integral image is ``cumsum`` over rows, then over columns, of the
    mean-centred edge-padded frame, in float32.  Its summation order is
    the library's; on frames whose centred values sum exactly in float32
    (integers below 2**24, as when the padded mean is an integer) every
    order gives the same image;
  * a box mean multiplies by the float32 reciprocal of the box area (XLA
    rewrites the JAX module's division by a constant into that), and a
    response, inner mean minus outer mean, rounds as XLA's CPU code does
    (``fused_term``): one of the two products is fused into the
    subtraction, with a single rounding, when it has one use in the
    chain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from openekfmonoslam_tpu_torch.vision.harris import _box_sum, _f32, _shift

# CenSurE scale ladder (filter half-sizes), as in OpenCV's StarDetector.
SCALE_LADDER = (1, 2, 3, 4, 6, 8, 11, 16, 22, 32, 45, 64, 90, 128)

# structure-tensor window radius of the line test
LINE_WINDOW = 2


def star_sizes(max_size: int) -> tuple:
    """Filter half-sizes evaluated for a given config maxSize (>=1)."""
    sizes = tuple(s for s in SCALE_LADDER if s <= max_size)
    return sizes if sizes else (1,)


def integral_pad(max_size: int) -> int:
    """Edge padding of the integral image: the widest outer box."""
    return 2 * max(star_sizes(max_size)) + 1


def _integral(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-padded, mean-centred integral image with a zero top row and
    left column: (H + 2 pad + 1, W + 2 pad + 1) float32.

    The mean is the float64 sum over the pixel count, rounded to float32:
    the sum of integer grey levels is exact in float64 in any order, so
    the mean does not depend on how a reduction is blocked (a float32 mean
    moves by an ulp under ``torch.func.vmap``, and the whole integral image
    with it)."""
    p = nnf.pad(img.to(torch.float32)[None, None], (pad,) * 4,
                mode="replicate")[0, 0]
    p = p - (torch.sum(p, dtype=torch.float64) / p.numel()).to(torch.float32)
    ii = torch.cumsum(torch.cumsum(p, dim=0), dim=1)
    return nnf.pad(ii, (1, 0, 1, 0))


def inv_area(n: int) -> float:
    """Reciprocal of the (2n+1)^2 box area (rounded to float32 where used)."""
    return 1.0 / float((2 * n + 1) ** 2)


def star_responses(gray: torch.Tensor, max_size: int = 16
                   ) -> tuple[torch.Tensor, tuple]:
    """(response (S, H, W) signed float32, sizes): mean of the inner box
    (half-size n) minus mean of the outer box (half-size 2n)."""
    h, w = gray.shape
    pad = integral_pad(max_size)
    return responses_from_integral(_integral(gray, pad), h, w,
                                   max_size), star_sizes(max_size)


def _box_sum_from_integral(ii: torch.Tensor, pad: int, h: int, w: int,
                           n: int) -> torch.Tensor:
    """(H, W) sum over the centered (2n+1)^2 box, from the integral image:
    rows [y-n, y+n] are ii[y+pad+n+1] - ii[y+pad-n]."""
    top = pad - n
    bot = pad + n + 1
    return (ii[bot:bot + h, bot:bot + w]
            - ii[top:top + h, bot:bot + w]
            - ii[bot:bot + h, top:top + w]
            + ii[top:top + h, top:top + w])


FUSE_NONE, FUSE_INNER, FUSE_OUTER = 0, 1, 2


def fused_term(n: int, sizes: tuple) -> int:
    """Which product of response n = inner mean - outer mean is fused into
    the subtraction (LLVM's multiply-add contraction under XLA): a box
    mean used once (by one response) is fused, the inner one first; a
    mean shared by two responses (box b is the inner box of b and the
    outer box of b / 2) is rounded on its own."""
    def uses(b):
        return (b in sizes) + (b % 2 == 0 and b // 2 in sizes)

    if uses(n) == 1:
        return FUSE_INNER
    if uses(2 * n) == 1:
        return FUSE_OUTER
    return FUSE_NONE


def responses_from_integral(ii: torch.Tensor, h: int, w: int,
                            max_size: int) -> torch.Tensor:
    """(S, H, W) responses, each rounded as ``fused_term`` says.  A fused
    product is computed in float64, where the float32 product is exact and
    so is the difference at these magnitudes, and rounded once."""
    pad = integral_pad(max_size)
    sizes = star_sizes(max_size)
    out = []
    for n in sizes:
        s_in = _box_sum_from_integral(ii, pad, h, w, n)
        s_out = _box_sum_from_integral(ii, pad, h, w, 2 * n)
        r_in, r_out = inv_area(n), inv_area(2 * n)
        mode = fused_term(n, sizes)
        if mode == FUSE_INNER:
            r = s_in.double() * _f32(r_in) - (s_out * r_out).double()
        elif mode == FUSE_OUTER:
            r = (s_in * r_in).double() - s_out.double() * _f32(r_out)
        else:
            r = s_in * r_in - s_out * r_out
        out.append(r.float())
    return torch.stack(out)


def scores_from_integral(ii: torch.Tensor, h: int, w: int,
                         max_size: int = 16,
                         response_threshold: float = 30.0,
                         line_threshold_projected: float = 10.0
                         ) -> torch.Tensor:
    """``star_scores`` from an integral image made by ``_integral``."""
    resp = responses_from_integral(ii, h, w, max_size)
    best = torch.amax(torch.abs(resp), dim=0)

    # one line/edge test on the merged response map: structure tensor over
    # a 5x5 window, keep tr^2 / det < threshold
    rx = 0.5 * (_shift(best, 0, 1) - _shift(best, 0, -1))
    ry = 0.5 * (_shift(best, 1, 0) - _shift(best, -1, 0))
    sxx = _box_sum(rx * rx, LINE_WINDOW)
    syy = _box_sum(ry * ry, LINE_WINDOW)
    sxy = _box_sum(rx * ry, LINE_WINDOW)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    not_line = (det > 0) & (tr * tr < line_threshold_projected * det)

    zero = torch.zeros_like(best)
    best = torch.where(not_line, best, zero)
    return torch.where(best >= response_threshold, best, zero)


def star_scores(gray: torch.Tensor, max_size: int = 16,
                response_threshold: float = 30.0,
                line_threshold_projected: float = 10.0) -> torch.Tensor:
    """Per-pixel STAR score map (0 where suppressed): the scale-space
    maximum of |response|, line-suppressed, then thresholded.  Spatial NMS
    is left to the caller (fast.non_max_suppress)."""
    h, w = gray.shape
    ii = _integral(gray, integral_pad(max_size))
    return scores_from_integral(ii, h, w, max_size, response_threshold,
                                line_threshold_projected)
