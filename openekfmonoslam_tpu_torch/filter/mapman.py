"""Map management: counters, culling, and inverse-depth -> XYZ conversion
(port of filter/mapman.py).

Reference: MapManagement.cpp + EKF.cpp:572-612.  Per frame: counters and
inlier descriptor refresh (:74-113); removal of features whose inlier
ratio fell below GoodFeatureMatchingPercent (:279-307); removal of unseen
features under map pressure (EKF.cpp:582-586); conversion of at most one
inverse-depth feature to XYZ when its linearity index is below threshold
(:311-523).  Removal is a masked zeroing of P rows/columns; conversion is
computed every frame and selected on the device (the JAX package's
``lax.cond``), so it needs no host sync.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.filter import shardable
from openekfmonoslam_tpu_torch.filter.state import (
    CAM_DIM,
    FEAT_DIM,
    SlamState,
    dim_active_mask,
    select_state,
    zero_inactive,
)


def update_counters(state: SlamState, predicted: torch.Tensor,
                    inlier: torch.Tensor, inlier_desc: torch.Tensor,
                    refreshed: torch.Tensor | None = None) -> SlamState:
    """Counters + descriptor refresh (updateMapFeatures,
    MapManagement.cpp:74-113).  ``refreshed`` marks slots whose template
    was re-stored this frame; their capture pose moves to the camera."""
    new = state._replace(
        times_predicted=state.times_predicted + predicted.to(torch.int32),
        times_matched=state.times_matched + inlier.to(torch.int32),
        descriptors=torch.where(inlier[:, None],
                                inlier_desc.to(state.descriptors.dtype),
                                state.descriptors),
    )
    if refreshed is not None:
        take = (inlier & refreshed)[:, None]
        pose_now = state.x[:7].to(torch.float32)[None, :].expand_as(
            state.patch_pose)
        new = new._replace(
            patch_pose=torch.where(take, pose_now, state.patch_pose))
    return new


def remove_features(state: SlamState, remove: torch.Tensor) -> SlamState:
    """Deactivate slots: zero their P rows/cols and state dims (the
    reference's row/column deletion, MapManagement.cpp:168-259)."""
    new_active = state.active & ~remove
    st = state._replace(active=new_active)
    dim_mask = dim_active_mask(st)
    x = torch.where(dim_mask, st.x, torch.zeros_like(st.x))
    x = torch.cat([st.x[:CAM_DIM], x[CAM_DIM:]])
    return st._replace(x=x, P=zero_inactive(st.P, dim_mask),
                       is_xyz=st.is_xyz & new_active)


def bad_feature_mask(state: SlamState, good_percent: float) -> torch.Tensor:
    """Features whose inlier ratio fell below threshold (removeBadMapFeatures,
    MapManagement.cpp:279-307); never-predicted features are kept."""
    predicted = state.times_predicted
    ratio = (state.times_matched.to(torch.float32)
             / torch.clamp(predicted, min=1))
    return state.active & (predicted > 0) & (ratio < good_percent)


def linearity_index(state: SlamState) -> torch.Tensor:
    """Civera linearity index per slot (computeLinearityIndex,
    MapManagement.cpp:311-339); +inf for inactive or XYZ slots.

    L = 4 (sigma_rho / rho^2) cos(alpha) / d_cam."""
    F = state.n_features
    feats = state.features
    rho = feats[:, 5]
    rho_dim = CAM_DIM + FEAT_DIM * torch.arange(F, device=rho.device) + 5
    sigma_rho = torch.sqrt(torch.abs(state.P[rho_dim, rho_dim]))
    rho_safe = torch.where(torch.abs(rho) < 1e-12,
                           torch.full_like(rho, 1e-12), rho)
    sigma_d = sigma_rho / (rho_safe * rho_safe)

    m = quat.directional_vector(feats[:, 3], feats[:, 4])      # (F, 3)
    xyz = feats[:, 0:3] + m / rho_safe[:, None]
    to_cam = xyz - state.r[None, :]
    to_anchor = xyz - feats[:, 0:3]
    d_cam = torch.linalg.vector_norm(to_cam, dim=-1)
    d_anchor = torch.linalg.vector_norm(to_anchor, dim=-1)
    denom = torch.clamp(d_cam * d_anchor, min=1e-20)
    cos_alpha = torch.sum(to_cam * to_anchor, dim=-1) / denom
    li = 4.0 * sigma_d * cos_alpha / torch.clamp(d_cam, min=1e-20)
    eligible = state.active & ~state.is_xyz
    return torch.where(eligible, li, torch.full_like(li, float("inf")))


def conversion_candidate(state: SlamState, threshold: float,
                         order_key: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(eligible, slot): whether any slot is below the threshold, and the
    first such slot in slot order."""
    if order_key is not None:
        raise NotImplementedError(
            "the insertion-order conversion scan is not ported")
    below = linearity_index(state) < threshold
    return torch.any(below), torch.argmax(below.to(torch.int32))


def convert_one_to_xyz(state: SlamState, threshold: float,
                       enable=True,
                       order_key: torch.Tensor | None = None) -> SlamState:
    """Convert the first eligible slot with linearity index below
    threshold (MapManagement.cpp:494-523: at most one per frame); the
    conversion is computed and selected on ``do & enable``."""
    do, slot = conversion_candidate(state, threshold, order_key)
    return select_state(do & enable, _convert_slot(state, slot), state)


def _convert_slot(state: SlamState, slot: torch.Tensor) -> SlamState:
    """Collapse ``slot``'s 6-dim inverse-depth block to 3 XYZ dims through
    J = [I | dm/dtheta / rho | dm/dphi / rho | -m / rho^2] (convertToDepth,
    MapManagement.cpp:343-385) and retire its last 3 dims."""
    P = state.P
    dtype, dev = P.dtype, P.device
    # ``slot`` is a 0-dim tensor on the device: select with it, never index
    # by it (that would read it back to the host)
    f = torch.index_select(state.features, 0, slot.reshape(1))[0]
    theta, phi, rho = f[3], f[4], f[5]
    rho_safe = torch.where(torch.abs(rho) < 1e-12,
                           torch.full_like(rho, 1e-12), rho)
    m = quat.directional_vector(theta, phi)
    xyz = f[0:3] + m / rho_safe

    cp, sp = torch.cos(phi), torch.sin(phi)
    ct, st_ = torch.cos(theta), torch.sin(theta)
    dm_dtheta = torch.stack([cp * ct, torch.zeros_like(cp), -cp * st_])
    dm_dphi = torch.stack([-sp * st_, -cp, -sp * ct])
    J = torch.cat([
        torch.eye(3, dtype=dtype, device=dev),
        (dm_dtheta / rho_safe)[:, None],
        (dm_dphi / rho_safe)[:, None],
        (-m / (rho_safe * rho_safe))[:, None],
    ], dim=1)                                                 # (3, 6)

    N = P.shape[0]
    off = CAM_DIM + FEAT_DIM * slot.to(torch.long)
    idx = off + torch.arange(FEAT_DIM, device=dev)
    rows6 = shardable.select_rows(P, off, FEAT_DIM)           # (6, N)
    cols6 = P[:, idx]                                         # (N, 6)
    P66 = rows6[:, idx]

    zeros3 = torch.zeros((FEAT_DIM - 3, N), dtype=dtype, device=dev)
    new_rows = torch.cat([J @ rows6, zeros3], dim=0)
    new_cols = torch.cat([cols6 @ J.T, zeros3.T], dim=1)
    new_block = torch.zeros((FEAT_DIM, FEAT_DIM), dtype=dtype, device=dev)
    new_block[0:3, 0:3] = J @ P66 @ J.T

    P_new = shardable.place_rows(P, new_rows, off)
    P_new = shardable.place_cols(P_new, new_cols, off)
    P_new = shardable.place_block(P_new, new_block, off, off)

    x_new = state.x.clone()
    x_new[idx] = torch.cat([xyz, torch.zeros((3,), dtype=dtype, device=dev)])
    is_xyz = state.is_xyz | (torch.arange(state.n_features, device=dev)
                             == slot)
    return state._replace(x=x_new, P=P_new, is_xyz=is_xyz)


def map_pressure(state: SlamState, needed: torch.Tensor,
                 always_remove_unseen: bool, max_map_features: int,
                 max_map_size: int) -> torch.Tensor:
    """Unseen-removal trigger (EKF.cpp:582-584)."""
    live_dims = torch.sum(dim_active_mask(state).to(torch.int32))
    n_feat = torch.sum(state.active.to(torch.int32))
    cond = torch.full((), bool(always_remove_unseen), device=needed.device)
    if max_map_features > 0:
        cond = cond | (n_feat + needed > max_map_features)
    if max_map_size > 0:
        cond = cond | (live_dims + needed * 6 > max_map_size)
    return (needed > 0) & cond
