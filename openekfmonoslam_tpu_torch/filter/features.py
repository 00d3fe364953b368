"""Feature lifecycle: inverse-depth initialization into free slots (port of
filter/features.py).

Reference: AddMapFeature.cpp.  A new landmark is initialized from a
detected pixel: undistort, back-project to a unit-depth camera ray, rotate
to world, convert to (theta, phi) with rho = InitInvDepthRho (:293-350);
the covariance grows by a 6-dim block built from J1 = d(feature)/d(r, q)
and J2 = d(feature)/d(u, v, rho) with noise diag(pixelErrorX^2,
pixelErrorY^2, rhoSD^2) (:109-289).  The per-candidate chain and its
Jacobians are one kernel on the GPU (ops/init_kernel.py).

Where the JAX package branches with ``lax.cond`` (add only if a candidate
landed, free colliding slots only if one collides), the port always
computes the masked addition: with no candidate every write is a no-op, and
no branch costs a device-to-host sync.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter import mapman
from openekfmonoslam_tpu_torch.filter.state import (
    CAM_DIM, FEAT_DIM, SlamState, select_state)
from openekfmonoslam_tpu_torch.ops import init_kernel


def init_feature(camera: Camera, cam7: torch.Tensor, uv_rho: torch.Tensor
                 ) -> torch.Tensor:
    """(r, q, pixel, rho) -> inverse-depth 6-vector
    (addFeatureToStateAndCovariance, AddMapFeature.cpp:293-332).

    Intermediates keep a length-1 axis instead of going 0-dim: PyTorch's
    forward-mode tangents of a 0-dim tensor combined with a Python float
    come out float64, which would break ``init_plain``'s float32
    Jacobians."""
    r, q = cam7[0:3], cam7[None, 3:7]
    uv_undist = cam_mod.undistort(camera, uv_rho[None, 0:2])
    ray_cam = cam_mod.back_project(camera, uv_undist)          # (1, 3)
    ray_w = (quat.to_rotation_matrix(q) @ ray_cam[..., None])[0, :, 0]
    gx, gy, gz = ray_w[0:1], ray_w[1:2], ray_w[2:3]
    theta = torch.atan2(gx, gz)
    phi = torch.atan2(-gy, torch.sqrt(gx ** 2 + gz ** 2))
    return torch.cat([r, theta, phi, uv_rho[2:3]])


def assign_slots(active: torch.Tensor, cand_valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Valid candidates fill the free slots in increasing slot order.
    Returns (slots int32, ok); candidates that do not fit get slot F."""
    F = active.shape[0]
    dev = active.device
    order = torch.argsort(active.to(torch.int32), stable=True)  # free first
    n_free = torch.sum(~active)
    free_slots = torch.where(torch.arange(F, device=dev) < n_free, order,
                             torch.full_like(order, F))
    ranks = torch.cumsum(cand_valid.to(torch.int32), dim=0) - 1
    ok = cand_valid & (ranks < n_free)
    slots = torch.where(ok, free_slots[torch.clamp(ranks, 0, F - 1)],
                        torch.full_like(ranks, F))
    return slots.to(torch.int32), ok


def add_features(state: SlamState, camera: Camera, config: SlamConfig,
                 cand_uv: torch.Tensor, cand_desc: torch.Tensor,
                 cand_valid: torch.Tensor) -> SlamState:
    """Add up to C candidate measurements into free slots, batched (the
    closed form of the sequential AddMapFeature.cpp:354-367 loop)."""
    slots, ok = assign_slots(state.active, cand_valid)
    return _add_features_impl(state, camera, config, cand_uv, cand_desc,
                              slots, ok)


def add_features_at(state: SlamState, camera: Camera, config: SlamConfig,
                    cand_uv: torch.Tensor, cand_desc: torch.Tensor,
                    slots: torch.Tensor, ok: torch.Tensor) -> SlamState:
    """add_features with explicit slot placement (replay path): occupied
    targets are freed first (the oracle's collision rule)."""
    F = state.n_features
    target = torch.where(ok, slots.to(torch.long),
                         torch.full_like(slots, F, dtype=torch.long))
    # index_fill_ takes the value as a kernel argument (an assignment of a
    # Python scalar through an index tensor copies it to the device first)
    colliding = torch.zeros((F + 1,), dtype=torch.bool,
                            device=ok.device).index_fill_(0, target, True)
    remove = colliding[:F] & state.active
    state = select_state(torch.any(remove),
                         mapman.remove_features(state, remove), state)
    return _add_features_impl(state, camera, config, cand_uv, cand_desc,
                              target.to(torch.int32), ok)


def _scatter_rows(base: torch.Tensor, idx: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``base`` with rows ``idx`` <- ``values``; index len(base) is
    dropped (the JAX out-of-range scatter rule)."""
    ext = torch.cat([base, base[:1]], dim=0)
    ext[idx.to(torch.long)] = values
    return ext[:-1]


def _add_features_impl(state: SlamState, camera: Camera, config: SlamConfig,
                       cand_uv: torch.Tensor, cand_desc: torch.Tensor,
                       slots: torch.Tensor, ok: torch.Tensor) -> SlamState:
    P = state.P
    dtype, dev = P.dtype, P.device
    C = cand_uv.shape[0]
    N = P.shape[0]
    ekf, camcal = config.ekf, config.camera
    cam7 = state.x[:7]

    feats, J1, J2 = init_kernel.init_chain(camera, cam7, cand_uv,
                                           float(ekf.init_inv_depth_rho))
    r_add = (camcal.pixel_error_x ** 2, camcal.pixel_error_y ** 2,
             ekf.inverse_depth_rho_sd ** 2)

    # each new feature's J1 only reads the camera pose strip P[:7, :],
    # which no addition modifies; two new features c, d cross-correlate
    # by J1_c P77 J1_d^T
    p7 = P[:7, :]
    P77 = p7[:, :7]
    rows = torch.einsum("cij,jn->cin", J1, p7)               # (C, 6, N)
    B = torch.einsum("cij,jk->cik", J1, P77)                 # (C, 6, 7)
    cross = torch.einsum("cik,djk->cidj", B, J1)             # (C, 6, C, 6)
    J2r = torch.stack([J2[..., k] * r_add[k] for k in range(3)], dim=-1)
    noise = torch.einsum("cik,cjk->cij", J2r, J2)            # (C, 6, 6)

    # invalid candidates point at the extra column N, which is dropped
    dim_idx = (CAM_DIM + FEAT_DIM * slots.to(torch.long)[:, None]
               + torch.arange(FEAT_DIM, device=dev)[None, :])  # (C, 6)
    dim_idx = torch.where(ok[:, None], dim_idx, torch.full_like(dim_idx, N))
    cross = cross * ok.to(dtype)[None, None, :, None]
    rows = torch.cat([rows, torch.zeros((C, FEAT_DIM, 1), dtype=dtype,
                                        device=dev)], dim=-1)
    rows[:, :, dim_idx.reshape(-1)] = cross.reshape(C, FEAT_DIM,
                                                   C * FEAT_DIM)
    diag = torch.einsum("cik,cjk->cij", B, J1) + noise       # (C, 6, 6)
    rows[torch.arange(C, device=dev)[:, None, None],
         torch.arange(FEAT_DIM, device=dev)[None, :, None],
         dim_idx[:, None, :]] = diag
    rows = rows[..., :N]

    # each state dim looks up which candidate row writes it (K = none)
    flat_idx = dim_idx.reshape(-1)
    K = C * FEAT_DIM
    idx_map = torch.full((N + 1,), K, dtype=torch.long, device=dev)
    idx_map[flat_idx] = torch.arange(K, device=dev)
    idx_map = idx_map[:N]
    wrote = idx_map < K
    A_ext = torch.cat([rows.reshape(K, N),
                       torch.zeros((1, N), dtype=dtype, device=dev)], dim=0)
    G = A_ext[idx_map]                                       # (N, N)
    Pn = torch.where(wrote[:, None], G, P)
    P_new = torch.where(wrote[None, :], G.T, Pn)

    x_new = _scatter_rows(state.x, flat_idx, feats.reshape(-1).to(dtype))
    zeros_c = torch.zeros((C,), dtype=torch.int32, device=dev)
    pose_rows = cam7.to(torch.float32)[None, :].expand(C, 7)
    # candidate order within the frame preserves the reference's sequential
    # addition order; frame*(C+1)+i is globally monotonic
    births = (state.frame * (C + 1)
              + torch.arange(C, dtype=torch.int32, device=dev))
    return state._replace(
        x=x_new,
        P=P_new,
        active=_scatter_rows(state.active, slots,
                             torch.ones((C,), dtype=torch.bool, device=dev)),
        is_xyz=_scatter_rows(state.is_xyz, slots,
                             torch.zeros((C,), dtype=torch.bool, device=dev)),
        times_predicted=_scatter_rows(state.times_predicted, slots, zeros_c),
        times_matched=_scatter_rows(state.times_matched, slots, zeros_c),
        descriptors=_scatter_rows(state.descriptors, slots,
                                  cand_desc.to(state.descriptors.dtype)),
        patch_pose=_scatter_rows(state.patch_pose, slots, pose_rows),
        birth=_scatter_rows(state.birth, slots, births.to(torch.int32)),
    )
