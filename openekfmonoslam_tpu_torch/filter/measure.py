"""Measurement prediction: h(x), Jacobians H, and innovation covariances
(port of filter/measure.py).

Reference: MeasurementPrediction.cpp.  For every slot: the predicted
distorted pixel, the visibility gate, the 2-row Jacobian
H_i = [dh/d(camera) | dh/d(feature)] and S_i = H_i P H_i^T + I.  The
per-slot chain, with its masks, is one kernel on the GPU
(ops/measure_kernel.py); the shared H P / H P H^T products stay PyTorch
matmuls (true fp32: the port turns TF32 off where the path starts,
engine/step.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM, SlamState
from openekfmonoslam_tpu_torch.ops import measure_kernel


class Prediction(NamedTuple):
    """Per-slot measurement predictions (all shapes lead with F slots)."""

    uv: torch.Tensor        # (F, 2) predicted distorted pixel
    visible: torch.Tensor   # (F,) bool: active & in front & in image
    Hc: torch.Tensor        # (F, 2, 13) dh/d(camera state); cols 7:13 zero
    Hf: torch.Tensor        # (F, 2, 6) dh/d(feature slot params)
    S: torch.Tensor         # (F, 2, 2) innovation covariance (R_i = I)
    HP: torch.Tensor        # (2F, N) = H P with the visibility-masked H
    Sfull: torch.Tensor     # (2F, 2F) = H P H^T (no measurement noise)


def point_in_camera_frame(cam7: torch.Tensor, feat: torch.Tensor,
                          is_xyz: torch.Tensor) -> torch.Tensor:
    """World feature -> camera-frame point, batched: ``cam7`` (..., 7),
    ``feat`` (..., 6), ``is_xyz`` (...,) broadcast together.

    Inverse-depth: R(q)^T (rho (anchor - r) + m(theta, phi)); XYZ:
    R(q)^T (p - r) (MeasurementPrediction.cpp:127-156)."""
    r, q = cam7[..., 0:3], cam7[..., 3:7]
    Rcw = quat.to_rotation_matrix(q).transpose(-1, -2)
    m = quat.directional_vector(feat[..., 3], feat[..., 4])
    p_inv = feat[..., 5:6] * (feat[..., 0:3] - r) + m
    p_xyz = feat[..., 0:3] - r
    a = torch.where(is_xyz[..., None], p_xyz, p_inv)
    return (Rcw @ a[..., None])[..., 0]


def measure_one(camera: Camera, cam7: torch.Tensor, feat: torch.Tensor,
                is_xyz: torch.Tensor) -> torch.Tensor:
    """h: (camera pose, feature) -> predicted distorted pixel (..., 2),
    with the camera-frame z clamped away from zero."""
    p_cam = point_in_camera_frame(cam7, feat, is_xyz)
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.ones_like(z), z)
    p_safe = torch.cat([p_cam[..., :2], z_safe[..., None]], dim=-1)
    return cam_mod.distort(camera, cam_mod.project(camera, p_safe))


def predict_measurements(state: SlamState, camera: Camera,
                         quirks: bool = False,
                         hp_layout: str = "blocks") -> Prediction:
    """h + H + S for every slot (predictCameraMeasurements,
    MeasurementPrediction.cpp:705-719).  ``quirks`` selects the
    reference's bug-compatible H chain (the parity mode)."""
    dtype = state.P.dtype
    uv, Hc, Hf, visible = measure_kernel.measure(
        camera, state.x[:7], state.features, state.is_xyz, state.active,
        quirks=quirks)
    HP, Sfull = hp_products(state.P, Hc, Hf, layout=hp_layout)
    S = diag_blocks_2x2(Sfull) + torch.eye(2, dtype=dtype,
                                           device=Sfull.device)[None]
    return Prediction(uv=uv, visible=visible, Hc=Hc, Hf=Hf, S=S, HP=HP,
                      Sfull=Sfull)


def hp_products(P: torch.Tensor, Hc: torch.Tensor, Hf: torch.Tensor,
                layout: str = "blocks") -> tuple[torch.Tensor, torch.Tensor]:
    """(H P (2F, N), H P H^T (2F, 2F)) from the block-sparse H.

    ``blocks``: H P from the camera strip and the per-slot strips of P;
    ``dense``: the dense (2F, N) H and two plain matmuls."""
    F = Hc.shape[0]
    end = CAM_DIM + F * FEAT_DIM
    N = P.shape[0]
    if layout == "dense":
        H = dense_H(Hc, Hf, N)
        HP = H @ P
        return HP, HP @ H.T
    if layout != "blocks":
        raise ValueError(f"unknown hp_layout {layout!r}")
    Pc = P[:CAM_DIM, :]
    Pf = P[CAM_DIM:end, :].reshape(F, FEAT_DIM, N)
    HP = (torch.einsum("fic,cn->fin", Hc[:, :, :CAM_DIM], Pc)
          + torch.einsum("fid,fdn->fin", Hf, Pf)).reshape(2 * F, N)
    S = HP[:, :CAM_DIM] @ Hc[:, :, :CAM_DIM].reshape(2 * F, CAM_DIM).T
    HPf = HP[:, CAM_DIM:end].reshape(2 * F, F, FEAT_DIM)
    S = S + torch.einsum("ajd,jid->aji", HPf, Hf).reshape(2 * F, 2 * F)
    return HP, S


def diag_blocks_2x2(Sfull: torch.Tensor) -> torch.Tensor:
    """(2F, 2F) -> (F, 2, 2) diagonal blocks."""
    F = Sfull.shape[0] // 2
    return Sfull.reshape(F, 2, F, 2).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def innovation_covariances(P: torch.Tensor, Hc: torch.Tensor,
                           Hf: torch.Tensor) -> torch.Tensor:
    """S_i = H_i P H_i^T + I per slot (makeMeasurementCovariance,
    MeasurementPrediction.cpp:595-658)."""
    _, Sfull = hp_products(P, Hc, Hf)
    return diag_blocks_2x2(Sfull) + torch.eye(2, dtype=P.dtype,
                                              device=P.device)[None]


def dense_H(Hc: torch.Tensor, Hf: torch.Tensor, n_total: int = 0
            ) -> torch.Tensor:
    """The sparse per-slot Jacobians as dense H (2F, max(N, 13 + 6F)):
    row block i has Hc_i in the camera columns and Hf_i in slot i's
    (joinJacobians, Update.cpp:222-232, without the compaction)."""
    F = Hc.shape[0]
    idx = torch.arange(F, device=Hc.device)
    feat_block = torch.zeros((F, 2, F, FEAT_DIM), dtype=Hc.dtype,
                             device=Hc.device)
    feat_block[idx, :, idx, :] = Hf
    parts = [Hc, feat_block.reshape(F, 2, F * FEAT_DIM)]
    logical = CAM_DIM + F * FEAT_DIM
    if n_total and n_total > logical:
        parts.append(torch.zeros((F, 2, n_total - logical), dtype=Hc.dtype,
                                 device=Hc.device))
    return torch.cat(parts, dim=-1).reshape(2 * F, max(n_total, logical))
