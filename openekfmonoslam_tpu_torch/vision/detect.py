"""Zone-balanced new-feature selection (port of vision/detect.py).

Reference: DetectNewImageFeatures.cpp.  Candidates away from the
prediction ellipses are grouped into a 2^d x 2^d grid of zones and picked
one at a time from the least-populated zone (predictions plus picks so
far), strongest corner first, each pick making the candidates within the
exclusion radius unavailable.  Ties between zones go to the lower zone id.

The JAX package runs the picks as a ``while_loop`` that stops after
``min(needed, max_new)`` picks or when no candidate is left.  Here the
caller passes that count, read on the host, as ``n_iter``: a pick with no
candidate left changes nothing, so ``n_iter`` masked picks give the while
loop's result with no further host read.  The batched step
(parallel/batch_runner.py) passes the largest count of its streams as
``n_iter`` and each stream's own count as the device tensor ``limit``:
picks past a stream's limit change nothing either.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NewFeatures(NamedTuple):
    uv: torch.Tensor        # (C, 2) picked pixels (x, y), float32
    valid: torch.Tensor     # (C,) bool
    kp_index: torch.Tensor  # (C,) int64 index into the keypoint arrays


def select_zone_balanced(kp_xy: torch.Tensor, kp_score: torch.Tensor,
                         kp_avail: torch.Tensor, pred_uv: torch.Tensor,
                         pred_visible: torch.Tensor, n_iter: int,
                         exclusion_radius: float, zones_in_a_row: int,
                         image_w: int, image_h: int, max_new: int,
                         limit: torch.Tensor | None = None) -> NewFeatures:
    """Pick up to ``n_iter`` (<= max_new) keypoints, zone-balanced, and no
    more than ``limit`` (a 0-dim integer tensor) when it is given.

    ``kp_xy`` (K, 2) float32 pixels; ``kp_avail`` should already exclude
    keypoints inside prediction ellipses."""
    dev = kp_xy.device
    n_zones = zones_in_a_row * zones_in_a_row
    zone_w = image_w // zones_in_a_row
    zone_h = image_h // zones_in_a_row

    def zone_of(xy):
        zx = torch.clamp(xy[..., 0].to(torch.int32) // zone_w, 0,
                         zones_in_a_row - 1)
        zy = torch.clamp(xy[..., 1].to(torch.int32) // zone_h, 0,
                         zones_in_a_row - 1)
        return (zy * zones_in_a_row + zx).to(torch.int64)

    kp_zone = zone_of(kp_xy)
    zone_ids = torch.arange(n_zones, device=dev)
    in_zone = kp_zone[:, None] == zone_ids[None, :]               # (K, Z)
    pop = torch.sum((zone_of(pred_uv)[:, None] == zone_ids[None, :])
                    & pred_visible[:, None], dim=0, dtype=torch.int32)
    r2 = torch.full((), exclusion_radius, dtype=torch.float32,
                    device=dev) ** 2
    big = torch.full_like(pop, 1 << 20)
    neg_inf = torch.full_like(kp_score, float("-inf"))

    avail = kp_avail
    picked = torch.full((max_new,), -1, dtype=torch.int64, device=dev)
    n_picked = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(max_new, device=dev)
    for _ in range(min(n_iter, max_new)):
        zone_has = torch.any(in_zone & avail[:, None], dim=0)
        zone_sel = torch.argmin(torch.where(zone_has, pop, big))  # lowest id
        cand_ok = avail & (kp_zone == zone_sel)
        kp_sel = torch.argmax(torch.where(cand_ok, kp_score, neg_inf))
        do = torch.any(cand_ok)
        if limit is not None:
            do = do & (n_picked < limit)

        # suppress everything inside the exclusion radius of the pick
        sel_xy = torch.index_select(kp_xy, 0, kp_sel.reshape(1))
        dist2 = torch.sum((kp_xy - sel_xy) ** 2, dim=-1)
        avail = avail & ~(do & (dist2 <= r2))

        pop = pop + ((zone_ids == zone_sel) & do).to(torch.int32)
        picked = torch.where((slots == n_picked) & do, kp_sel, picked)
        n_picked = n_picked + do.to(torch.int64)

    valid = picked >= 0
    idx = torch.clamp(picked, min=0)
    xy = kp_xy[idx].to(torch.float32)
    uv = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    return NewFeatures(uv=uv, valid=valid, kp_index=idx)
