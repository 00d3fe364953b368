"""The joint EKF update as hand-written CUDA kernels (``csrc/update.cu``).

Replaces the TPU kernel ``_update_kernel`` / ``joint_update_pallas``
(openekfmonoslam_tpu/ops/update_kernel.py:73,158) and the Newton-Schulz
inverse it embeds (ns_inverse_into, ops/sinv.py:68): mask the shared
H P / H P H^T rows, add the noise diagonal, invert S, W = S^-1 (H P),
x += W^T res, P' = 1/2 (P + P^T) - 1/2 (D + D^T) with D = (H P)^T W (the
plain chain's downdate and symmetrize; P' comes out exactly symmetric),
then the quaternion renormalization and its Jacobian through P rows and
columns 3:7, all gated by applied = any(use) on the device.

Bound on the H100: fp32 operations, 2 Mu^3 + 2 Mu^2 N + 2 Mu N^2 + 2 Mu N
for Mu used rows of 2F (the downdate counted once), ~0.22 GFLOP at N = 640
with all 2F = 192 rows used (~3.3 us at 67 TFLOP/s); the covariance
traffic is ~3.9 MB (~1.2 us).  Design (csrc/update.cu): a one-block
Gauss-Jordan inverse of S in shared memory (M^2 multiply-adds per used
row, independent of cond(S); the steps of unused rows are identities and
skipped), two tiled fp32 GEMM kernels with 4x4 register tiles for W and
the symmetric downdate (D and D^T as two products, twice the downdate's
need, so that P' is exactly symmetric), and a one-block finalize -- four
launches on one stream, no
host synchronisation.  All products are true fp32 (no TF32, no bf16
split).  No N or 2F cap: S falls back from shared to device memory when
it does not fit.  Outputs are new tensors; P is never written.

``joint_update`` is the wrapper: a CPU tensor runs ``update_plain`` (the
filter/update.py kalman_update + finalize_update chain), a CUDA tensor
launches the kernels or raises.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.ops import cuda_lib

LAUNCHES = cuda_lib.LaunchCounter("update")


def update_plain(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                 Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                 use: torch.Tensor, pixel_error: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P') by the chain of filter/update.py, in P's dtype."""
    from openekfmonoslam_tpu_torch.filter.update import finalize_xp, kalman_xp

    xk, Pk = kalman_xp(P, x, HP, Sfull, uv, z, use, pixel_error)
    return finalize_xp(Pk, xk, torch.any(use))


def joint_update_cuda(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                      Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                      use: torch.Tensor, pixel_error: float
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x', P', S^-1) from the CUDA kernels; P (N, N), x (N,), HP (2F, N),
    Sfull (2F, 2F), uv/z (F, 2), use (F,) bool.  S^-1 is the masked
    S's inverse the gain used (returned for checking)."""
    P, x, HP, Sfull, uv, z, use = (t.contiguous() for t in (P, x, HP, Sfull,
                                                           uv, z, use))
    cuda_lib.check_cuda_inputs("update", {
        "P": P, "x": x, "HP": HP, "Sfull": Sfull, "uv": uv, "z": z,
        "use": use})
    N = P.shape[0]
    F = use.shape[0]
    M = 2 * F
    if (P.shape != (N, N) or x.shape != (N,) or HP.shape != (M, N)
            or Sfull.shape != (M, M) or uv.shape != (F, 2)
            or z.shape != (F, 2) or F < 1):
        raise ValueError("update: bad shapes")
    dev = P.device
    P_out = torch.empty_like(P)
    x_out = torch.empty_like(x)
    Sinv = torch.empty((M, M), dtype=torch.float32, device=dev)
    W = torch.empty((M, N), dtype=torch.float32, device=dev)
    cuda_lib.library().call(
        "ekf_update", P.data_ptr(), x.data_ptr(), HP.data_ptr(),
        Sfull.data_ptr(), uv.data_ptr(), z.data_ptr(), use.data_ptr(),
        P_out.data_ptr(), x_out.data_ptr(), Sinv.data_ptr(), W.data_ptr(),
        N, F, float(pixel_error), cuda_lib.stream_of(P))
    LAUNCHES.hit()
    return x_out, P_out, Sinv


def joint_update(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                 Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                 use: torch.Tensor, pixel_error: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The joint update + finalize: plain version on the CPU, the kernels
    on CUDA.  Returns (x', P')."""
    if P.device.type == "cpu":
        return update_plain(P, x, HP, Sfull, uv, z, use, pixel_error)
    x_out, P_out, _ = joint_update_cuda(P, x, HP, Sfull, uv, z, use,
                                        pixel_error)
    return x_out, P_out
