"""Harris / Shi-Tomasi corner scoring from one structure-tensor pass (port
of vision/harris.py): central-difference gradients, elementwise products
and a separable box sum over edge-replicated shifts.

The scores round as the JAX module's do under ``jit`` on the CPU, where
XLA contracts a product into the add or subtract that consumes it (one
rounding, ``fma32``): Harris is fma(-(k tr), tr, fma(Sxx, Syy, -Sxy^2)),
Shi-Tomasi's radicand fma(d, d, Sxy^2) with d = (Sxx - Syy) / 2.  Which
product XLA contracts depends on the consumer: these are the front end's
forms (the score feeding ``quality_threshold``); a program that returns
the Shi-Tomasi map itself contracts Sxy^2 instead.  ``sqrt32`` is the
correctly rounded float32 square root (XLA's ``vsqrtps``); PyTorch's
vectorised CPU ``sqrt`` is not always, so it is taken in float64 and
rounded once.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """a * b + c with one rounding to float32, for float32 operands, on any
    device: the product is exact in float64, and the float64 sum rounded
    to float32 is the fused value unless the exact sum lies within 2^-53
    of a float32 halfway point (double rounding; never met in the tests,
    which hold every map bit for bit)."""
    return (a.double() * b.double() + c.double()).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device."""
    return torch.sqrt(x.double()).float()


def _clamped(n: int, d: int, device) -> torch.Tensor:
    return torch.clamp(torch.arange(n, device=device) + d, 0, n - 1)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-padded static shift: out[y, x] = img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape
    out = img
    if dy:
        out = torch.index_select(out, 0, _clamped(h, dy, img.device))
    if dx:
        out = torch.index_select(out, 1, _clamped(w, dx, img.device))
    return out


def _box_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable (2r+1)^2 box sum via shift-and-add (edge padded): rows
    first, then columns, each in ascending offset order from zero (the
    JAX module's summation order)."""
    acc = torch.zeros_like(img)
    for d in range(-radius, radius + 1):
        acc = acc + _shift(img, d, 0)
    out = torch.zeros_like(img)
    for d in range(-radius, radius + 1):
        out = out + _shift(acc, 0, d)
    return out


def gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference image gradients (Ix, Iy), float32."""
    img = gray.to(torch.float32)
    ix = 0.5 * (_shift(img, 0, 1) - _shift(img, 0, -1))
    iy = 0.5 * (_shift(img, 1, 0) - _shift(img, -1, 0))
    return ix, iy


def _product_box_sum(a: torch.Tensor, b: torch.Tensor, radius: int,
                     contract: bool) -> torch.Tensor:
    """``_box_sum(a * b, radius)``; with ``contract`` the vertical pass's
    middle tap is the product a * b contracted into the running sum."""
    if not contract:
        return _box_sum(a * b, radius)
    p = a * b
    acc = _shift(p, -radius, 0)
    for d in range(-radius + 1, radius + 1):
        acc = fma32(a, b, acc) if d == 0 else acc + _shift(p, d, 0)
    out = _shift(acc, 0, -radius)
    for d in range(-radius + 1, radius + 1):
        out = out + _shift(acc, 0, d)
    return out


def structure_tensor(gray: torch.Tensor, window_radius: int = 2,
                     contract: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Windowed second-moment matrix entries (Sxx, Syy, Sxy).  With
    ``contract`` each box sum's vertical pass takes its middle product
    contracted into the running sum, as XLA fuses it on ORB's pyramid
    levels from the third down (``orb.pyramid_fast_scores``)."""
    ix, iy = gradients(gray)
    sxx = _product_box_sum(ix, ix, window_radius, contract)
    syy = _product_box_sum(iy, iy, window_radius, contract)
    sxy = _product_box_sum(ix, iy, window_radius, contract)
    return sxx, syy, sxy


def harris_scores(gray: torch.Tensor, k: float = 0.04,
                  window_radius: int = 2, contract: bool = False
                  ) -> torch.Tensor:
    """Per-pixel Harris response det(M) - k * trace(M)^2 (>= 0 clamped);
    ``contract`` as for ``structure_tensor``."""
    sxx, syy, sxy = structure_tensor(gray, window_radius, contract)
    det = fma32(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    return torch.clamp(fma32(-(k * tr), tr, det), min=0.0)


def shi_tomasi_scores(gray: torch.Tensor, window_radius: int = 2
                      ) -> torch.Tensor:
    """Per-pixel minimum eigenvalue of the structure tensor (GFTT score)."""
    sxx, syy, sxy = structure_tensor(gray, window_radius)
    half_tr = 0.5 * (sxx + syy)
    half_diff = 0.5 * (sxx - syy)
    rad = sqrt32(fma32(half_diff, half_diff, sxy * sxy))
    return torch.clamp(half_tr - rad, min=0.0)


def quality_threshold(score: torch.Tensor, quality: float) -> torch.Tensor:
    """GFTT semantics: zero scores below quality * max(score)."""
    cut = quality * torch.amax(score)
    return torch.where(score >= cut, score, torch.zeros_like(score))
