"""Float gradient descriptors (SURF-analog) and the squared L2 matching
distance (port of vision/floatdesc.py).

The SURF-64 layout: a (2R)x(2R) patch of image gradients around each
keypoint, split into a 4x4 grid of cells, each cell summarised by
(sum dx, sum |dx|, sum dy, sum |dy|) of Gaussian-weighted gradients, the
64 values L2-normalised.  Upright (no dominant-orientation rotation), as
in the JAX module.  Dense gradient maps once a frame, then a (K, patch^2)
gather per component.

The sums are float32 reductions whose order is the library's, so the
descriptors agree with the JAX module's to about 1e-6 relative, not bit
for bit.  ``l2_distance`` is one float32 matrix product; the runtime
keeps TF32 off, so it is a true float32 product on the card too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openekfmonoslam_tpu_torch.vision.harris import gradients

DESC_DIM = 64
_CELLS = 4  # 4x4 grid


def _patch_offsets(radius: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Patch sample offsets (dy, dx) and Gaussian weights, cell-ordered:
    arrays of shape (cells^2 * cell_px,) that reshape to (cells^2,
    cell_px) grouped by cell."""
    side = 2 * radius
    cell = side // _CELLS
    dys, dxs, ws = [], [], []
    sigma = 3.3 * radius / 10.0  # SURF's 3.3s weighting at s = R/10
    for cy in range(_CELLS):
        for cx in range(_CELLS):
            for iy in range(cell):
                for ix in range(cell):
                    dy = cy * cell + iy - radius
                    dx = cx * cell + ix - radius
                    dys.append(dy)
                    dxs.append(dx)
                    ws.append(np.exp(-0.5 * (dy * dy + dx * dx)
                                     / (sigma * sigma)))
    return (np.asarray(dys, np.int32), np.asarray(dxs, np.int32),
            np.asarray(ws, np.float32))


@functools.lru_cache(maxsize=None)
def _patch_tensors(radius: int, device: torch.device):
    """``_patch_offsets`` on ``device``, uploaded once (a copy to the card
    a frame would wait for the host)."""
    dys, dxs, ws = _patch_offsets(radius)
    return (torch.as_tensor(dys, dtype=torch.int64, device=device),
            torch.as_tensor(dxs, dtype=torch.int64, device=device),
            torch.as_tensor(ws, device=device))


def surf64(smoothed: torch.Tensor, yx: torch.Tensor, radius: int = 10
           ) -> torch.Tensor:
    """(K, 64) float32 SURF-layout descriptors at integer keypoints."""
    h, w = smoothed.shape
    gx, gy = gradients(smoothed)
    dys, dxs, ws = _patch_tensors(radius, smoothed.device)
    y = torch.clamp(yx[:, 0:1].to(torch.int64) + dys[None, :], 0, h - 1)
    x = torch.clamp(yx[:, 1:2].to(torch.int64) + dxs[None, :], 0, w - 1)
    idx = y * w + x                                        # (K, P)
    pgx = gx.reshape(-1)[idx] * ws[None, :]
    pgy = gy.reshape(-1)[idx] * ws[None, :]
    k = yx.shape[0]
    cell_px = pgx.shape[1] // (_CELLS * _CELLS)
    pgx = pgx.reshape(k, _CELLS * _CELLS, cell_px)
    pgy = pgy.reshape(k, _CELLS * _CELLS, cell_px)
    feats = torch.stack([
        torch.sum(pgx, dim=-1), torch.sum(torch.abs(pgx), dim=-1),
        torch.sum(pgy, dim=-1), torch.sum(torch.abs(pgy), dim=-1),
    ], dim=-1)                                             # (K, 16, 4)
    d = feats.reshape(k, DESC_DIM)
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)
    return (d / norm).to(torch.float32)


def l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(F, D) x (K, D) -> (F, K) squared L2 distance (one matrix product)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    cross = a @ b.T
    na = torch.sum(a * a, dim=-1)
    nb = torch.sum(b * b, dim=-1)
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * cross, min=0.0)
