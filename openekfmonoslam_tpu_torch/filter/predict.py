"""EKF predict: constant-velocity motion model + covariance propagation
(port of filter/predict.py).

Reference: StateAndCovariancePrediction.cpp.  The motion model is

    r' = r + v dt,  q' = q (x) quat(w dt),  v' = v,  w' = w

with dt = 1 frame.  The covariance propagates as P <- F P F^T + G Q G^T
where only the 13x13 camera block and the 13xN cross strips change.  The
whole phase is one kernel on the GPU (ops/predict_kernel.py); on the CPU
the wrapper runs the same chain in plain PyTorch.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, SlamState
from openekfmonoslam_tpu_torch.ops import predict_kernel


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a product of a few elements, as explicit products
    summed in order of the inner index.  Elementwise ops round the same
    under ``torch.func.vmap`` as in a loop over streams; a tiny matmul does
    not (PyTorch's CPU ``bmm`` and ``mm`` take different small-matrix
    kernels), and the batched step must equal the single-stream one."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return acc


def motion_model(cam13: torch.Tensor, dt: float) -> torch.Tensor:
    """13-dim camera state transition (predictState, StateAndCovariancePrediction.cpp:43-65)."""
    r, q, v, w = cam13[0:3], cam13[3:7], cam13[7:10], cam13[10:13]
    q_new = quat.multiply(q, quat.from_axis_angle(w * dt))
    return torch.cat([r + v * dt, q_new, v, w])


def motion_jacobian(cam13: torch.Tensor, dt: float) -> torch.Tensor:
    """Analytic F = d(motion_model)/d(cam13), (13, 13), with the exact
    small-angle limits (StateAndCovariancePrediction.cpp:100-189).

      dq'/dq = R(q2)   (right-multiplication matrix of q2 = quat(w dt))
      dq'/dw = L(q) dq2/d(w dt) dt
    """
    dtype, dev = cam13.dtype, cam13.device
    q = cam13[3:7]
    v_ = cam13[10:13] * dt
    n2 = v_ @ v_
    n = torch.sqrt(n2)
    half = 0.5 * n
    c = torch.cos(half)
    small = n < 1e-6
    one = torch.ones_like(n)
    n_safe = torch.where(small, one, n)
    s = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / n_safe)
    g = torch.where(small, -1.0 / 24.0 + n2 / 960.0,
                    (0.5 * c - s) / torch.where(small, one, n2))

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dq2 = torch.cat([(-0.5 * s * v_)[None, :],
                     s * eye3 + g * torch.outer(v_, v_)], dim=0)   # (4, 3)

    qw, qx, qy, qz = q.unbind()
    L = torch.stack([torch.stack([qw, -qx, -qy, -qz]),
                     torch.stack([qx, qw, -qz, qy]),
                     torch.stack([qy, qz, qw, -qx]),
                     torch.stack([qz, -qy, qx, qw])])
    dq_dw = small_matmul(L, dq2) * dt                          # (4, 3)

    aw, ax, ay, az = torch.cat([c[None], s * v_]).unbind()     # quat(w dt)
    Rr = torch.stack([torch.stack([aw, -ax, -ay, -az]),
                      torch.stack([ax, aw, az, -ay]),
                      torch.stack([ay, -az, aw, ax]),
                      torch.stack([az, ay, -ax, aw])])

    # the blocks joined, not written into a zero F: torch.func.vmap cannot
    # write a stream's blocks into an unbatched tensor
    def zeros(r, c):
        return torch.zeros((r, c), dtype=dtype, device=dev)

    return torch.cat([
        torch.cat([eye3, zeros(3, 4), eye3 * dt, zeros(3, 3)], dim=1),
        torch.cat([zeros(4, 3), Rr, zeros(4, 3), dq_dw], dim=1),
        torch.cat([zeros(3, 7), eye3, zeros(3, 3)], dim=1),
        torch.cat([zeros(3, 10), eye3], dim=1)])


def predict(state: SlamState, config: SlamConfig, dt: float = 1.0,
            kernel=None) -> SlamState:
    """One predict step: the state with x[0:13] and P advanced.
    ``kernel`` (P, x, dt, lin, ang) -> (x', P') defaults to
    ``predict_kernel.predict``; the sharded step passes its form on a
    tile of P."""
    lin = (config.ekf.linear_accel_sd * dt) ** 2
    ang = (config.ekf.angular_accel_sd * dt) ** 2
    x, P = (kernel or predict_kernel.predict)(state.P, state.x, dt, lin, ang)
    return state._replace(x=x, P=P)
