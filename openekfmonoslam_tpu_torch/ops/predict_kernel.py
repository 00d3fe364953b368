"""The EKF predict phase as one CUDA kernel (``csrc/predict.cu``).

Replaces the TPU kernel ``_predict_kernel`` / ``predict_pallas``
(openekfmonoslam_tpu/ops/predict_kernel.py:48,154): the 13-dim
constant-velocity motion model, the analytic F, Qc = G diag(q) G^T, and
the covariance strips P'[0:13, :] = F P[0:13, :], P'[:, 0:13] = P[:, 0:13]
F^T, corner F P00 F^T + Qc; every other entry of P passes through.

Bound on the H100: bytes.  The output is out of place (the JAX step
donates nothing, so the caller's P stays valid), so the kernel moves
2 N^2 floats (3.3 MB at N = 640, ~1 us at 3.35 TB/s) and does 26 N
multiply-adds.  The TPU kernel rewrites rows 0:13 in place and reads them
back for the columns; the CUDA grid runs in parallel, so every entry is
computed from the original P and the corner from P00 directly.  Its
blocks split by role: copy blocks move P[13:, 16:] in 16-byte vectors
with no prologue, strip blocks build F and Qc and compute rows and
columns 0:13 (csrc/predict.cu).

``predict`` is the wrapper: a CPU tensor runs ``predict_plain`` (the
filter/predict.py chain), a CUDA tensor launches the kernel or raises.

B streams stacked on a leading axis take one launch (the stream is a
grid index; each stream's bits are its single launch's), which the
batched step (parallel/batch_runner.py) reaches under ``torch.func.vmap``
through the wrapper's custom op (ops/batched.py).
"""

from __future__ import annotations

import functools

import torch

from openekfmonoslam_tpu_torch.filter import shardable
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM
from openekfmonoslam_tpu_torch.ops import batched, cuda_lib

LAUNCHES = cuda_lib.LaunchCounter("predict")


def motion_terms(x: torch.Tensor, dt: float, lin: float, ang: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(camera state x'[0:13], F (13, 13), Qc = G diag(q) G^T (13, 13)) of
    one predict step, in x's dtype."""
    from openekfmonoslam_tpu_torch.filter.predict import (
        motion_jacobian, motion_model)

    dtype, dev = x.dtype, x.device
    cam = x[:CAM_DIM]
    F = motion_jacobian(cam, dt)
    cam_new = motion_model(cam, dt)

    # G (13x6): d(state)/d(noise (v_err, w_err)); the noise enters the
    # dynamics like (v, w), so the quaternion block reuses F's columns
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    G = torch.cat([torch.cat([eye3 * dt, z3], dim=1),
                   torch.cat([torch.zeros((4, 3), dtype=dtype, device=dev),
                              F[3:7, 10:13]], dim=1),
                   torch.cat([eye3, z3], dim=1),
                   torch.cat([z3, eye3], dim=1)])
    # filled on the device: a tensor made from a list copies from the host
    q_diag = torch.cat([torch.full((3,), lin, dtype=dtype, device=dev),
                        torch.full((3,), ang, dtype=dtype, device=dev)])
    return cam_new, F, G @ (q_diag[:, None] * G.T)


def predict_plain(P: torch.Tensor, x: torch.Tensor, dt: float, lin: float,
                  ang: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P') by the chain of filter/predict.py, in P's dtype."""
    cam_new, F, Qc = motion_terms(x, dt, lin, ang)
    top = F @ P[:CAM_DIM, :]
    P = shardable.place_rows(P, top, 0)
    P = shardable.place_cols(P, P[:, :CAM_DIM] @ F.T, 0)
    P = shardable.place_block(P, P[:CAM_DIM, :CAM_DIM] + Qc, 0, 0)
    x = torch.cat([cam_new, x[CAM_DIM:]])
    return x, P


def predict_cuda(P: torch.Tensor, x: torch.Tensor, dt: float, lin: float,
                 ang: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P') from one launch of the CUDA kernel; P (N, N), x (N,), or
    B streams stacked, P (B, N, N), x (B, N), in the same one launch."""
    P, x = P.contiguous(), x.contiguous()
    cuda_lib.check_cuda_inputs("predict", {"P": P, "x": x})
    N = P.shape[-1]
    lead = tuple(P.shape[:-2])
    if (P.shape != lead + (N, N) or x.shape != lead + (N,) or len(lead) > 1
            or N < CAM_DIM):
        raise ValueError(f"predict: bad shapes P {tuple(P.shape)}, "
                         f"x {tuple(x.shape)}")
    P_out = torch.empty_like(P)
    x_out = torch.empty_like(x)
    cuda_lib.library().call(
        "ekf_predict_batched", P.data_ptr(), x.data_ptr(), P_out.data_ptr(),
        x_out.data_ptr(), N, lead[0] if lead else 1, float(dt), float(lin),
        float(ang), cuda_lib.stream_of(P))
    LAUNCHES.hit()
    return x_out, P_out


@functools.cache
def _batched_op():
    def predict_op(P: torch.Tensor, x: torch.Tensor, dt: float, lin: float,
                   ang: float) -> tuple[torch.Tensor, torch.Tensor]:
        return predict_cuda(P, x, dt, lin, ang)

    def rule(info, in_dims, P, x, dt, lin, ang):
        P, x = batched.stacked(info.batch_size, in_dims, P, x)
        return predict_cuda(P, x, dt, lin, ang), (0, 0)

    return batched.custom_op("predict", predict_op, rule)


def predict(P: torch.Tensor, x: torch.Tensor, dt: float, lin: float,
            ang: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The predict phase: plain version on the CPU, the kernel on CUDA
    (one launch for all streams under ``torch.func.vmap``)."""
    if P.device.type == "cpu":
        return predict_plain(P, x, dt, lin, ang)
    if batched.any_batched(P, x):
        return _batched_op()(P, x, dt, lin, ang)
    return predict_cuda(P, x, dt, lin, ang)
