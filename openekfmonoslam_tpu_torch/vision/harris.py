"""Edge-replicated shifts and box sums (port of vision/harris.py, the part
STAR's line test uses).

The Harris and Shi-Tomasi scores of the JAX module belong to the other
detector profiles and are not ported yet.
"""

from __future__ import annotations

import torch


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
