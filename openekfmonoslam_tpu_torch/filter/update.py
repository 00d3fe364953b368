"""Joint EKF update over a masked set of matches (port of filter/update.py).

Reference: Update.cpp.  K = P H^T (H P H^T + R)^-1 with R = pixelError I
(Update.cpp:92-109), x += K (z - h), P <- (I - K H) P, then symmetrize P
and renormalize the quaternion with a Jacobian-corrected covariance
(Update.cpp:282-318).  The update runs over all slots with a use-mask;
masked slots contribute zero rows and identity S rows, which makes the
masked update equal to the compacted one.

On the GPU the whole chain is the CUDA joint-update kernel
(ops/update_kernel.py); on the CPU its wrapper runs the chain below.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.filter import shardable
from openekfmonoslam_tpu_torch.filter.measure import Prediction, dense_H
from openekfmonoslam_tpu_torch.filter.state import SlamState
from openekfmonoslam_tpu_torch.ops import sinv, update_kernel

# The reference's increment/residual deadband (Update.cpp:133-134)
DELTA = 1.0e-12


def masked_innovation(pred: Prediction, z: torch.Tensor, use: torch.Tensor,
                      n_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual vector (2F,) and masked dense H (2F, N)."""
    m = use[:, None].to(pred.uv.dtype)
    res = ((z - pred.uv) * m).reshape(-1)
    H = dense_H(pred.Hc * m[:, :, None], pred.Hf * m[:, :, None], n_total)
    return res, H


def kalman_xp(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
              Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
              use: torch.Tensor, pixel_error: float,
              update_covariance: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, P) after the Kalman step, from the shared H P / H P H^T.

    Masking rows of H commutes with the products, so the masked versions
    are row/column-masked views; S^-1 is formed explicitly (the reference
    inverts S, Update.cpp:108) and applied as one matmul."""
    dtype = P.dtype
    m = use[:, None].to(dtype)
    res = ((z - uv) * m).reshape(-1)
    use2 = use[:, None].expand(-1, 2).reshape(-1)      # (2F,) row mask
    u2 = use2.to(dtype)
    HP = HP * u2[:, None]
    S = Sfull * (u2[:, None] * u2[None, :])
    # R = pixelError on used rows; identity rows keep S SPD elsewhere
    r_diag = torch.where(use2, torch.full_like(u2, pixel_error),
                         torch.ones_like(u2))
    S = S + torch.diag(r_diag)
    KT = sinv.spd_inverse(S) @ HP                      # (2F, N)
    x = x + KT.T @ res
    if update_covariance:
        P = P - KT.T @ HP                              # (I - K H) P
    return x, P


def finalize_xp(P: torch.Tensor, x: torch.Tensor, applied: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetrize P, renormalize q and push its Jacobian through P's
    quaternion rows and columns, all gated by ``applied`` (a 0-dim bool
    tensor: the reference runs this only when a match was used,
    Update.cpp:292)."""
    Ps = 0.5 * (P + P.T)
    q = x[3:7]
    Jq = quat.normalize_jacobian(q)
    Pn = shardable.place_rows(Ps, Jq @ Ps[3:7, :], 3)
    Pn = shardable.place_cols(Pn, Pn[:, 3:7] @ Jq.T, 3)
    xn = torch.cat([x[:3], q / torch.linalg.vector_norm(q), x[7:]])
    return torch.where(applied, xn, x), torch.where(applied, Pn, P)


def kalman_update(state: SlamState, pred: Prediction, z: torch.Tensor,
                  use: torch.Tensor, pixel_error: float,
                  update_covariance: bool = True,
                  deadband: bool = False) -> SlamState:
    """One joint update step (updateStateAndCovariance, Update.cpp:237-265).
    With no slot used, x and P pass through unchanged."""
    if deadband:
        raise NotImplementedError("the reference DELTA deadband is not ported")
    x, P = kalman_xp(state.P, state.x, pred.HP, pred.Sfull, pred.uv, z, use,
                     pixel_error, update_covariance)
    return state._replace(x=x, P=P)


def finalize_update(state: SlamState, applied: torch.Tensor) -> SlamState:
    """Post-update numerics (Update.cpp:296-318), gated by ``applied``."""
    x, P = finalize_xp(state.P, state.x, applied)
    return state._replace(x=x, P=P)


def update(state: SlamState, pred: Prediction, z: torch.Tensor,
           use: torch.Tensor, pixel_error: float,
           deadband: bool = False) -> SlamState:
    """Full joint update + numerics (update, Update.cpp:282-318): one
    CUDA kernel chain on the GPU, kalman_update + finalize_update on the
    CPU."""
    if deadband:
        raise NotImplementedError("the reference DELTA deadband is not ported")
    x, P = update_kernel.joint_update(state.P, state.x, pred.HP, pred.Sfull,
                                      pred.uv, z, use, float(pixel_error))
    return state._replace(x=x, P=P)
