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

from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.measure import (
    Prediction, measure_one, point_in_camera_frame)
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM, SlamState
from openekfmonoslam_tpu_torch.filter.update import deadbanded
from openekfmonoslam_tpu_torch.spans import span

INT32_MAX = torch.iinfo(torch.int32).max


def _solve2x2(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 solve: (..., 2, 2) x (..., 2) -> (..., 2)."""
    a, c = S[..., 0, 0], S[..., 0, 1]
    d, e = S[..., 1, 0], S[..., 1, 1]
    det = a * e - c * d
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20),
                      det)
    x0 = (e * b[..., 0] - c * b[..., 1]) / det
    x1 = (a * b[..., 1] - d * b[..., 0]) / det
    return torch.stack([x0, x1], dim=-1)


class RansacResult(NamedTuple):
    inliers: torch.Tensor       # (F,) bool: low-innovation inlier set
    outliers: torch.Tensor      # (F,) bool: matched but not inlier
    best_support: torch.Tensor  # () int32
    hypotheses_visited: torch.Tensor  # () int32 (diagnostic)


def _batched_state_only_updates(state: SlamState, pred: Prediction,
                                z: torch.Tensor, matched: torch.Tensor,
                                pixel_error: float,
                                deadband: bool = False) -> torch.Tensor:
    """(F, N) hypothesized state vectors: one state-only 1-point update
    per matched slot, K_i dz_i = (H_i P)^T S_i^-1 dz_i with the rows of
    the shared H P (P is symmetric).  ``deadband``: updateOnlyState runs
    through the reference's deadbanded stateUpdate (Update.cpp:133-203)."""
    dtype = state.P.dtype
    F = pred.uv.shape[0]
    HPr = pred.HP.reshape(F, 2, -1)
    S = pred.S + (pixel_error - 1.0) * torch.eye(
        2, dtype=dtype, device=pred.S.device)[None]
    dz = z - pred.uv
    if deadband:
        dz = deadbanded(dz)
    sol = _solve2x2(S, dz)
    dx = torch.einsum("fin,fi->fn", HPr, sol)
    if deadband:
        dx = deadbanded(dx)
    dx = dx * matched[:, None].to(dtype)
    return state.x[None, :] + dx


def _support_counts(states_x: torch.Tensor, state: SlamState,
                    camera: Camera, z: torch.Tensor, matched: torch.Tensor,
                    threshold: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(support (F,), good (F, F)): per hypothesis, the matched slots
    re-predicted within ``threshold`` pixels (matchesBelowAThreshold,
    1PointRansac.cpp:48-84)."""
    F = state.n_features
    cam7 = states_x[:, None, :7]                               # (H, 1, 7)
    feats = states_x[:, CAM_DIM:CAM_DIM + F * FEAT_DIM].reshape(
        -1, F, FEAT_DIM)                                       # (H, F, 6)
    is_xyz = state.is_xyz[None, :]
    uv = measure_one(camera, cam7, feats, is_xyz)
    p_cam = point_in_camera_frame(cam7, feats, is_xyz)
    vis = (cam_mod.in_front_and_in_fov(camera, p_cam)
           & cam_mod.in_image(camera, uv))
    dist = torch.linalg.vector_norm(z[None] - uv, dim=-1)
    good = matched[None] & state.active[None] & vis & (dist < threshold)
    return torch.sum(good.to(torch.int32), dim=1), good


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
    state-only updates.  The winner is picked on the device with
    ``index_select``: indexing by a 0-dim tensor would read it back."""
    with span("ransac.hypotheses"):
        states_x = _batched_state_only_updates(state, pred, z, matched,
                                               pixel_error, deadband=deadband)
    with span("ransac.support"):
        support, good = _support_counts(states_x, state, camera, z, matched,
                                        threshold)
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
