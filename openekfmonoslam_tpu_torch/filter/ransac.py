"""Batched 1-point RANSAC and high-innovation outlier rescue (port of
filter/ransac.py).

Reference: 1PointRansac.cpp + rescueOutliers (EKF.cpp:68-119).  Every
matched slot is one hypothesis: a state-only 1-point Kalman update
(Update.cpp:269-275), then every slot is re-predicted and the matches
within the pixel threshold counted.  All hypotheses are evaluated at once
as a (hypotheses x slots) batch and the winner is the argmax of the
support (ties to the lowest slot).  The reference's sequential adaptive
visit bound (``ransac_parity_visit``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.measure import (
    Prediction, measure_one, point_in_camera_frame)
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM, SlamState


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
                                pixel_error: float) -> torch.Tensor:
    """(F, N) hypothesized state vectors: one state-only 1-point update
    per matched slot, K_i dz_i = (H_i P)^T S_i^-1 dz_i with the rows of
    the shared H P (P is symmetric)."""
    dtype = state.P.dtype
    F = pred.uv.shape[0]
    HPr = pred.HP.reshape(F, 2, -1)
    S = pred.S + (pixel_error - 1.0) * torch.eye(
        2, dtype=dtype, device=pred.S.device)[None]
    sol = _solve2x2(S, z - pred.uv)
    dx = torch.einsum("fin,fi->fn", HPr, sol)
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


def ransac(state: SlamState, pred: Prediction, z: torch.Tensor,
           matched: torch.Tensor, camera: Camera, threshold: float,
           all_inliers_probability: float, pixel_error: float,
           max_hypotheses: int = 1000, parity_visit: bool = False,
           visit_key: torch.Tensor | None = None,
           deadband: bool = False) -> RansacResult:
    """1-point RANSAC over all matched slots (1PointRansac.cpp:101-234):
    argmax of the support over every hypothesis, ties to the lowest index
    (the reference's strict ``>``)."""
    if parity_visit or visit_key is not None or deadband:
        raise NotImplementedError(
            "the reference-parity RANSAC visit order and deadband are not "
            "ported")
    states_x = _batched_state_only_updates(state, pred, z, matched,
                                           pixel_error)
    support, good = _support_counts(states_x, state, camera, z, matched,
                                    threshold)
    masked_support = torch.where(matched, support,
                                 torch.full_like(support, -1))
    # the winner is picked on the device: index_select with the 0-dim
    # argmax, since indexing by a 0-dim tensor reads it back to the host
    best_i = torch.argmax(masked_support)
    best_s = torch.clamp(torch.max(masked_support), min=0)
    visited = torch.sum(matched.to(torch.int32))
    best_good = torch.index_select(good, 0, best_i.reshape(1))[0]
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
