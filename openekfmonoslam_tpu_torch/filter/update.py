"""Joint EKF update over a masked set of matches (port of filter/update.py).

Reference: Update.cpp.  K = P H^T (H P H^T + R)^-1 with R = pixelError I
(Update.cpp:92-109), x += K (z - h), P <- (I - K H) P, then symmetrize P
and renormalize the quaternion with a Jacobian-corrected covariance
(Update.cpp:282-318).  The update runs over all slots with a use-mask;
masked slots contribute zero rows and identity S rows, which makes the
masked update equal to the compacted one.

``update`` routes as the JAX package does (filter/update.py:139-149): the
fused CUDA joint-update kernel (ops/update_kernel.py) where
``update_kernel_applicable`` holds (the s3 map, N = 640) and the DELTA
deadband is off, and otherwise the chain below (every update of the parity
mode, whatever the shape), ``kalman_xp`` + ``finalize_xp``, whose S^-1 is
``ops/sinv.spd_inverse`` (the S-inverse kernels on the card up to
2F = 512; the large map, N = 1024 and 2F = 336, takes it).  The chain's
products K^T = S^-1 (H P) and P - K^T^T (H P) stay torch.matmul in true
fp32, as the JAX package leaves them to XLA.
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


def deadbanded(v: torch.Tensor) -> torch.Tensor:
    """``v`` with the components of magnitude <= DELTA zeroed: the
    reference's stateUpdate skips those residuals and increments
    (Update.cpp:133-203)."""
    return torch.where(torch.abs(v) > DELTA, v, torch.zeros_like(v))


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
              update_covariance: bool = True, inverse=None,
              deadband: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, P) after the Kalman step, from the shared H P / H P H^T
    (``kalman_gain``, then P - K^T^T (H P) with the masked H P)."""
    x, KT, HP = kalman_gain(x, HP, Sfull, uv, z, use, pixel_error, inverse,
                            deadband)
    if update_covariance:
        P = P - KT.T @ HP                              # (I - K H) P
    return x, P


def kalman_gain(x: torch.Tensor, HP: torch.Tensor, Sfull: torch.Tensor,
                uv: torch.Tensor, z: torch.Tensor, use: torch.Tensor,
                pixel_error: float, inverse=None, deadband: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x', K^T = S^-1 (H P) (2F, N), the use-masked H P (2F, N)).

    Masking rows of H commutes with the products, so the masked versions
    are row/column-masked views; S^-1 is formed explicitly (the reference
    inverts S, Update.cpp:108) and applied as one matmul.  ``inverse``
    (S -> S^-1) defaults to ``sinv.spd_inverse`` with the floor
    lambda_min(S) >= min(pixelError, 1) that R guarantees.  ``deadband``
    applies ``deadbanded`` to the residual and to the increment."""
    dtype = HP.dtype
    m = use[:, None].to(dtype)
    res = ((z - uv) * m).reshape(-1)
    if deadband:
        res = deadbanded(res)
    use2 = use[:, None].expand(-1, 2).reshape(-1)      # (2F,) row mask
    u2 = use2.to(dtype)
    HP = HP * u2[:, None]
    S = Sfull * (u2[:, None] * u2[None, :])
    # R = pixel_error on used rows; identity rows keep S SPD elsewhere
    r_diag = torch.where(use2, torch.full_like(u2, pixel_error),
                         torch.ones_like(u2))
    S = S + torch.diag(r_diag)
    if inverse is None:
        Sinv = sinv.spd_inverse(S, lam_floor=min(float(pixel_error), 1.0))
    else:
        Sinv = inverse(S)
    KT = Sinv @ HP                                     # (2F, N)
    dx = KT.T @ res
    if deadband:
        dx = deadbanded(dx)
    return x + dx, KT, HP


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


def update_chain(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                 Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                 use: torch.Tensor, pixel_error: float,
                 deadband: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P') by ``kalman_xp`` + ``finalize_xp``, the route of every
    update the fused kernel does not take."""
    xk, Pk = kalman_xp(P, x, HP, Sfull, uv, z, use, pixel_error,
                       deadband=deadband)
    return finalize_xp(Pk, xk, torch.any(use))


def kalman_update(state: SlamState, pred: Prediction, z: torch.Tensor,
                  use: torch.Tensor, pixel_error: float,
                  update_covariance: bool = True,
                  deadband: bool = False) -> SlamState:
    """One joint update step (updateStateAndCovariance, Update.cpp:237-265).
    With no slot used, x and P pass through unchanged."""
    x, P = kalman_xp(state.P, state.x, pred.HP, pred.Sfull, pred.uv, z, use,
                     pixel_error, update_covariance, deadband=deadband)
    return state._replace(x=x, P=P)


def finalize_update(state: SlamState, applied: torch.Tensor) -> SlamState:
    """Post-update numerics (Update.cpp:296-318), gated by ``applied``."""
    x, P = finalize_xp(state.P, state.x, applied)
    return state._replace(x=x, P=P)


def update(state: SlamState, pred: Prediction, z: torch.Tensor,
           use: torch.Tensor, pixel_error: float,
           deadband: bool = False) -> SlamState:
    """Full joint update + numerics (update, Update.cpp:282-318): the fused
    CUDA kernel where it applies and ``deadband`` is off, ``update_chain``
    otherwise (with the deadband, always, as JAX at filter/update.py:139)."""
    args = (state.P, state.x, pred.HP, pred.Sfull, pred.uv, z, use,
            float(pixel_error))
    if not deadband and update_kernel.update_kernel_applicable(state.P,
                                                               pred.HP):
        x, P = update_kernel.joint_update(*args)
    else:
        x, P = update_chain(*args, deadband=deadband)
    return state._replace(x=x, P=P)
