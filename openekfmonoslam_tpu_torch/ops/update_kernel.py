"""The joint EKF update as hand-written CUDA kernels (``csrc/update.cu``).

Replaces the TPU kernel ``_update_kernel`` / ``joint_update_pallas``
(openekfmonoslam_tpu/ops/update_kernel.py:73,158) and the Newton-Schulz
inverse it embeds (ns_inverse_into, ops/sinv.py:68): mask the shared
H P / H P H^T rows, add the noise diagonal, x += K res, the P downdate and
its symmetrization, then the quaternion renormalization and its Jacobian
through P rows and columns 3:7, all gated by applied = any(use) on the
device.

Design (csrc/update.cu over csrc/spd_core.cuh): the kernels work on the
Mu used rows only, compacted on the device, and in factored form.  One CTA
factors S_u = L L^T by a blocked Cholesky in shared memory; column slabs
across CTAs form V = L^-1 (H P)_u and y = L^-1 res_u, x' = x + V^T y, and
the renormalized q with its Jacobian Jq; a SYRK over the upper-triangle
tiles writes P' = 1/2 (P + P^T) - V^T V into both triangles from the same
numbers (exactly symmetric) and pushes Jq through rows and columns 3:7 in
its epilogue.  Three launches on one stream, no host synchronisation; S^-1
is never formed.  All products are true fp32 (no TF32, no bf16 split).  No
N or 2F cap: L and the solve's slabs fall back from shared to device
memory when they do not fit.  Outputs are new tensors; P is never written.

Bound on the H100: fp32 operations, Mu^3 / 6 + Mu^2 N / 2 + Mu N^2 / 2 +
Mu N multiply-adds for Mu used rows of 2F (about 0.07 GFLOP at N = 640
and Mu = 132, 1.0 us at 67 TFLOP/s); the sequential panels of the
factorization and the block rows of the solve, not the bound, set its
time.

``joint_update`` is the wrapper: a CPU tensor runs ``update_plain`` (the
filter/update.py kalman_update + finalize_update chain), a CUDA tensor
launches the kernels or raises.  ``tests/test_torch_spd_core.py`` follows
the kernels' factored steps in PyTorch.  ``filter/update.update`` takes
this kernel only where ``update_kernel_applicable`` holds, as the JAX
package does; elsewhere it runs the chain with the S-inverse kernel
(ops/sinv.py).

B streams stacked on a leading axis take the same three launches (the
stream is a grid index, one factor CTA a stream; each stream's bits are
its single launch's), which the batched step (parallel/batch_runner.py)
reaches under ``torch.func.vmap`` through the wrapper's custom op
(ops/batched.py).
"""

from __future__ import annotations

import functools

import torch

from openekfmonoslam_tpu_torch.ops import batched, cuda_lib, spd_core

LAUNCHES = cuda_lib.LaunchCounter("update")

# csrc/update.cu: the columns of H P a solve CTA takes (plus the residual
# column), and the shared memory its slab may use before it moves to the
# scratch in device memory
SLAB = 16
SOLVE_SMEM_MAX = 96 * 1024

# The JAX package's routing (ops/update_kernel.py:205-215): its one-launch
# TPU kernel held P, D and D^T in 16 MB of VMEM up to N = 768, 2F = 512,
# on lane-aligned N.  Not limits of the CUDA kernels, which take any size.
_LANE = 128
_MAX_N = 768
_MAX_M = 512


def update_kernel_fits(N: int, M: int) -> bool:
    """The JAX package's shape rule for the fused update: N % 128 == 0,
    N <= 768 and M = 2F <= 512."""
    return N % _LANE == 0 and N <= _MAX_N and M <= _MAX_M


def update_kernel_applicable(P: torch.Tensor, HP: torch.Tensor) -> bool:
    """Whether ``filter/update.update`` takes the fused update: a CUDA
    float32 P whose shapes fit ``update_kernel_fits``."""
    return (P.device.type == "cuda" and P.dtype == torch.float32
            and update_kernel_fits(P.shape[0], HP.shape[0]))


def update_plain(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                 Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                 use: torch.Tensor, pixel_error: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x', P') by the chain of filter/update.py, in P's dtype, with S^-1
    by Cholesky (all PyTorch, on any device)."""
    from openekfmonoslam_tpu_torch.filter.update import finalize_xp, kalman_xp
    from openekfmonoslam_tpu_torch.ops.sinv import cholesky_inverse

    xk, Pk = kalman_xp(P, x, HP, Sfull, uv, z, use, pixel_error,
                       inverse=cholesky_inverse)
    return finalize_xp(Pk, xk, torch.any(use))


def joint_update_cuda(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                      Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                      use: torch.Tensor, pixel_error: float
                      ) -> tuple[torch.Tensor, torch.Tensor, spd_core.Factor]:
    """(x', P', factor) from the CUDA kernels; P (N, N), x (N,), HP (2F, N),
    Sfull (2F, 2F), uv/z (F, 2), use (F,) bool.  The factor of the masked
    S that the update used is returned for checking
    (``spd_core.dense_factor``).  B streams stacked (a leading B axis on
    every operand) take the same three launches, each stream's factor on
    its own CTA; the factor is then returned only for B = 1 (None)."""
    P, x, HP, Sfull, uv, z, use = (t.contiguous() for t in (P, x, HP, Sfull,
                                                           uv, z, use))
    cuda_lib.check_cuda_inputs("update", {
        "P": P, "x": x, "HP": HP, "Sfull": Sfull, "uv": uv, "z": z,
        "use": use})
    lead = tuple(P.shape[:-2])
    N = P.shape[-1]
    F = use.shape[-1]
    M = 2 * F
    if (P.shape != lead + (N, N) or x.shape != lead + (N,)
            or HP.shape != lead + (M, N) or Sfull.shape != lead + (M, M)
            or uv.shape != lead + (F, 2) or z.shape != lead + (F, 2)
            or use.shape != lead + (F,) or len(lead) > 1 or F < 1 or N < 7):
        raise ValueError("update: bad shapes")
    B = lead[0] if lead else 1
    dev = P.device
    P_out = torch.empty_like(P)
    x_out = torch.empty_like(x)
    blocks = -(-M // spd_core.NB)
    slabs = -(-N // SLAB)
    # L, the diagonal blocks' inverses, V, Jq, then the solve's slabs when
    # they do not fit its shared memory
    sizes = [spd_core.tri(M), blocks * spd_core.NB ** 2, M * N, 16,
             slabs * M * (SLAB + 1) if M * (SLAB + 1) * 4 > SOLVE_SMEM_MAX
             else 0]
    # a stream's scratch block, rounded to 16 bytes
    per_stream = -(-sum(sizes) // 4) * 4
    scratch = torch.empty((B * per_stream,), dtype=torch.float32,
                          device=dev)
    ptrs, base = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(base)
        base += 4 * n
    ints = torch.empty((B * (M + 2),), dtype=torch.int32, device=dev)
    cuda_lib.library().call(
        "ekf_update_batched", P.data_ptr(), x.data_ptr(), HP.data_ptr(),
        Sfull.data_ptr(), uv.data_ptr(), z.data_ptr(), use.data_ptr(),
        P_out.data_ptr(), x_out.data_ptr(), *ptrs, ints.data_ptr(),
        ints.data_ptr() + 4 * M, N, F, B, per_stream, float(pixel_error),
        cuda_lib.stream_of(P))
    LAUNCHES.hit()
    factor = (spd_core.Factor(scratch[:sizes[0]], ints[:M], ints[M:])
              if not lead else None)
    return x_out, P_out, factor


@functools.cache
def _batched_op():
    def update_op(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                  Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                  use: torch.Tensor, pixel_error: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        return joint_update_cuda(P, x, HP, Sfull, uv, z, use,
                                 pixel_error)[:2]

    def rule(info, in_dims, P, x, HP, Sfull, uv, z, use, pixel_error):
        args = batched.stacked(info.batch_size, in_dims[:7], P, x, HP, Sfull,
                               uv, z, use)
        return joint_update_cuda(*args, pixel_error)[:2], (0, 0)

    return batched.custom_op("update", update_op, rule)


def joint_update(P: torch.Tensor, x: torch.Tensor, HP: torch.Tensor,
                 Sfull: torch.Tensor, uv: torch.Tensor, z: torch.Tensor,
                 use: torch.Tensor, pixel_error: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The joint update + finalize: plain version on the CPU, the kernels
    on CUDA.  Returns (x', P')."""
    if P.device.type == "cpu":
        return update_plain(P, x, HP, Sfull, uv, z, use, pixel_error)
    if batched.any_batched(P, x, HP, Sfull, uv, z, use):
        return _batched_op()(P, x, HP, Sfull, uv, z, use, float(pixel_error))
    x_out, P_out, _ = joint_update_cuda(P, x, HP, Sfull, uv, z, use,
                                        pixel_error)
    return x_out, P_out
