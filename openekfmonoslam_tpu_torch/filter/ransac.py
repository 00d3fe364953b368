"""Batched 1-point RANSAC and high-innovation outlier rescue (port of
filter/ransac.py).

Reference: 1PointRansac.cpp + rescueOutliers (EKF.cpp:68-119).  Every
matched slot is one hypothesis: a state-only 1-point Kalman update
(Update.cpp:269-275), then every slot is re-predicted and the matches
within the pixel threshold counted.  All hypotheses are evaluated at once
as a (hypotheses x slots) batch and the winner is the argmax of the
support (ties to the lowest slot).

The parity mode replays the reference's sequential loop exactly: its
adaptive visit bound (``parity_visit``, ``_adaptive_visit_scan``), its
insertion-order visit (``visit_key``) and the DELTA deadband of its
state-only updates (``deadband``).  The visit scan is vectorized and reads
nothing back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.measure import Prediction
from openekfmonoslam_tpu_torch.filter.state import SlamState
from openekfmonoslam_tpu_torch.ops import ransac_kernel
from openekfmonoslam_tpu_torch.ops.ransac_kernel import solve2x2 as _solve2x2
from openekfmonoslam_tpu_torch.spans import span

INT32_MAX = torch.iinfo(torch.int32).max


class RansacResult(NamedTuple):
    inliers: torch.Tensor       # (F,) bool: low-innovation inlier set
    outliers: torch.Tensor      # (F,) bool: matched but not inlier
    best_support: torch.Tensor  # () int32
    hypotheses_visited: torch.Tensor  # () int32 (diagnostic)


def _batched_state_only_updates(state: SlamState, pred: Prediction,
                                z: torch.Tensor, matched: torch.Tensor,
                                pixel_error: float,
                                deadband: bool = False) -> torch.Tensor:
    """(F, N) hypothesized state vectors, one state-only 1-point update
    per matched slot (``ransac_kernel.hypotheses_plain``)."""
    return ransac_kernel.hypotheses_plain(state.x, pred.HP, pred.S, z,
                                          pred.uv, matched, pixel_error,
                                          deadband)


def _support_counts(states_x: torch.Tensor, state: SlamState,
                    camera: Camera, z: torch.Tensor, matched: torch.Tensor,
                    threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(support (F,), good (F, F)) of the hypotheses ``states_x``
    (``ransac_kernel.count_plain``)."""
    return ransac_kernel.count_plain(states_x, camera, z, matched,
                                     state.active, state.is_xyz, threshold)


def _adaptive_visit_scan(support: torch.Tensor, matched: torch.Tensor,
                         all_inliers_probability: float,
                         max_hypotheses: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's sequential hypothesis loop (1PointRansac.cpp:
    125-186) over precomputed support counts, as (best_index,
    best_support, visited_count), 0-dim int32 tensors on the device.

    Hypothesis k is the k-th match; it is visited while k <
    numberOfHipotesis, and a visited one with strictly greater support
    leads and sets numberOfHipotesis = log(1 - p) / log(e), e its outlier
    ratio, computed in float64 as the C++ does.  Vectorized exactly: the
    bound before hypothesis i follows from the running maximum of the
    matched supports before i (the leaders are its strict increases), so
    the first unvisited hypothesis is the first match whose rank reaches
    that bound, every match before it is visited, and the winner is the
    first visited index of the maximum support."""
    F = support.shape[0]
    dev = support.device
    sup = support.to(torch.int32)
    m32 = matched.to(torch.int32)
    n_matches = torch.sum(m32)
    rank = torch.cumsum(m32, 0, dtype=torch.int32) - 1
    ms = torch.where(matched, sup, torch.zeros_like(sup))
    lead = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cummax(ms, 0).values[:-1]])
    log1mp = math.log(1.0 - all_inliers_probability)
    e = 1.0 - lead.to(torch.float64) / torch.clamp(n_matches, min=1)
    # floor() cast as the C++ static_cast<int>; clamped at e ~ 0 and 1
    bound = torch.where(
        e <= 0.0, torch.zeros_like(lead),
        torch.where(e >= 1.0, torch.full_like(lead, max_hypotheses),
                    (log1mp / torch.log(torch.clamp(e, min=1e-30))
                     ).to(torch.int32)))
    idx = torch.arange(F, device=dev)
    stop = torch.where(matched & (rank >= bound), idx, torch.full_like(idx, F))
    visited = matched & (idx < torch.min(stop))
    vs = torch.where(visited, sup, torch.zeros_like(sup))
    best_s = torch.max(vs)
    best_i = torch.where(best_s > 0, torch.argmax(vs),
                         torch.zeros_like(best_s)).to(torch.int32)
    return best_i, best_s, torch.sum(visited, dtype=torch.int32)


def ransac(state: SlamState, pred: Prediction, z: torch.Tensor,
           matched: torch.Tensor, camera: Camera, threshold: float,
           all_inliers_probability: float, pixel_error: float,
           max_hypotheses: int = 1000, parity_visit: bool = False,
           visit_key: torch.Tensor | None = None,
           deadband: bool = False) -> RansacResult:
    """1-point RANSAC over all matched slots (1PointRansac.cpp:101-234):
    argmax of the support over every hypothesis, ties to the lowest index
    (the reference's strict ``>``).

    ``parity_visit`` replays the reference's adaptive visit bound
    (``_adaptive_visit_scan``); ``visit_key`` visits the hypotheses in
    the order of that per-slot key (``state.birth``: the reference's
    insertion order); ``deadband`` applies the DELTA deadband inside the
    state-only updates.  The hypotheses and their support are one kernel
    launch on the card (ops/ransac_kernel.py), the plain chain's two steps
    on the CPU.  The winner is picked on the device with ``index_select``:
    indexing by a 0-dim tensor would read it back."""
    if pred.HP.device.type == "cpu":
        with span("ransac.hypotheses"):
            states_x = _batched_state_only_updates(
                state, pred, z, matched, pixel_error, deadband=deadband)
        with span("ransac.support"):
            support, good = _support_counts(states_x, state, camera, z,
                                            matched, threshold)
    else:
        with span("ransac.support"):
            support, good = ransac_kernel.support(
                camera, state.x, pred.HP, pred.S, z, pred.uv, matched,
                state.active, state.is_xyz, pixel_error, threshold,
                deadband)
    with span("ransac.pick"):
        perm = None
        if visit_key is not None:
            # matched slots in key order (stable); unmatched ones sink to the
            # end and are mask-skipped anyway
            key = torch.where(matched, visit_key.to(torch.int32),
                              torch.full_like(support, INT32_MAX))
            perm = torch.sort(key, stable=True).indices
            support = torch.index_select(support, 0, perm)
            matched_v = torch.index_select(matched, 0, perm)
        else:
            matched_v = matched
        if parity_visit:
            best_v, best_s, visited = _adaptive_visit_scan(
                support, matched_v, all_inliers_probability, max_hypotheses)
        else:
            masked_support = torch.where(matched_v, support,
                                         torch.full_like(support, -1))
            best_v = torch.argmax(masked_support)
            best_s = torch.clamp(torch.max(masked_support), min=0)
            visited = torch.sum(matched.to(torch.int32))
        best_i = best_v.reshape(1)
        if perm is not None:
            best_i = torch.index_select(perm, 0, best_i)
        best_good = torch.index_select(good, 0, best_i)[0]
        inliers = best_good & matched & (best_s > 0)
        return RansacResult(inliers=inliers, outliers=matched & ~inliers,
                            best_support=best_s, hypotheses_visited=visited)


def rescue_outliers(pred_new: Prediction, z: torch.Tensor,
                    outliers: torch.Tensor, chi2_threshold: float
                    ) -> torch.Tensor:
    """High-innovation rescue (rescueOutliers, EKF.cpp:68-119): outliers
    whose re-predicted innovation passes d^T S^-1 d < chi2_threshold."""
    d = z - pred_new.uv
    md = torch.sum(d * _solve2x2(pred_new.S, d), dim=-1)
    return outliers & pred_new.visible & (md < chi2_threshold)
