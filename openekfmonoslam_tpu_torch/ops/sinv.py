"""SPD inverses for the joint update (port of ops/sinv.py).

``sinv_cuda`` launches the hand-written S-inverse kernels
(``csrc/sinv.cu`` over ``csrc/spd_core.cuh``), which replace the TPU kernel
``_sinv_kernel`` / ``sinv_pallas`` (openekfmonoslam_tpu/ops/sinv.py:169,
177).  They compute the same function, S^-1 of an SPD S, by another
method: the rows of S that are exact identity rows (every unused row of
the update's masked S) are left out, the others compacted on the device
and factored by a blocked Cholesky in one CTA; W = L^-1 comes from
triangular solves in column slabs across CTAs, X = W^T W, and one step
X + X (I - S X) whose residual is summed in twice the working precision
(the Newton-Schulz kernel's last polish step) refines it.  A memset and
six launches on one stream, no host synchronisation.  The kernels' plain
version is ``cholesky_inverse``; ``tests/test_torch_spd_core.py`` follows
their steps in PyTorch.

``ns_inverse`` is the port of the JAX package's Newton-Schulz math
(``ns_inverse_into``, with its residual-gated rescue), held against JAX by
the tests; no kernel runs it.

``newton_schulz_inverse`` (the name of the S-inverse wrapper since the
kernel iterated Newton-Schulz) and ``spd_inverse`` are the wrappers: a CPU
tensor runs ``cholesky_inverse``, a CUDA tensor launches the kernels or
raises.  ``spd_inverse`` routes as the JAX package does (ops/sinv.py:
215-225): a CUDA float32 S with M <= 512 takes the kernels, anything else
``cholesky_inverse`` (a library call, as the JAX package leaves it to XLA
outside any Pallas kernel).  On the card that path does not read back to
the host: ``cholesky_ex`` skips the error check that
``torch.linalg.cholesky`` syncs for.

B streams' S stacked on a leading axis take the same memset and six
launches (the stream is a grid index, one factor CTA a stream; each
stream compacts its own mask and its bits are its single launch's), which
the batched step (parallel/batch_runner.py) reaches under
``torch.func.vmap`` through the wrapper's custom op (ops/batched.py): the
update chain of the large map and of the parity mode.

Bound of the kernels on the H100: bytes (S in, S^-1 out); see
csrc/sinv.cu for the count and the design.
"""

from __future__ import annotations

import functools

import torch

from openekfmonoslam_tpu_torch.ops import batched, cuda_lib, spd_core

N_ITERS = 12
F32_POLISH = 2
MAX_RESCUE = 128
# The JAX package's routing (ops/sinv.py:212): its one-block TPU kernel
# held S in 16 MB of VMEM up to M = 512.  Not a limit of the CUDA kernels,
# which take any M.
MAX_KERNEL_M = 512
# csrc/sinv.cu: the identity columns a solve CTA takes, and the shared
# memory its slab may use before it moves to the scratch in device memory
SLAB = 8
SOLVE_SMEM_MAX = 96 * 1024

LAUNCHES = cuda_lib.LaunchCounter("sinv")


def cholesky_inverse(S: torch.Tensor) -> torch.Tensor:
    """S^-1 for SPD S by Cholesky factorization and a solve against I,
    with no host synchronisation on the card."""
    L, _ = torch.linalg.cholesky_ex(S)
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    return torch.cholesky_solve(eye, L)


def ns_inverse(S: torch.Tensor, lam_floor: float = 1.0,
               n_iters: int = N_ITERS, f32_polish: int = F32_POLISH
               ) -> torch.Tensor:
    """Newton-Schulz SPD inverse X <- X (2I - S X) from X0 = c I,
    c = 1.8 / (lam_floor + ||S||_inf), with the residual-gated rescue of
    the TPU kernel: when the first polish step's residual max|SX - I|
    exceeds 0.05, restart from X0 and iterate until it is <= 5e-4.  The
    last f32_polish - 1 steps refine, X <- X + X (I - S X), with the
    residual computed in float64 (the kernel's Dot2 sum: twice float32's
    precision)."""
    return ns_inverse_steps(S, lam_floor, n_iters, f32_polish)[0]


def ns_inverse_steps(S: torch.Tensor, lam_floor: float = 1.0,
                     n_iters: int = N_ITERS, f32_polish: int = F32_POLISH
                     ) -> tuple[torch.Tensor, int]:
    """``ns_inverse`` and the number of rescue steps it took (0: the
    probe passed)."""
    m = S.shape[0]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    c = 1.8 / (lam_floor + torch.max(torch.sum(torch.abs(S), dim=1)))
    X = c * eye
    for _ in range(n_iters - f32_polish):
        X = X @ (2.0 * eye - S @ X)
    T = 2.0 * eye - S @ X
    bad = bool(torch.max(torch.abs(T - eye)) > 0.05)
    X = X @ T
    k = 0
    if bad:
        X = c * eye
        res = 1.0
        while res > 5e-4 and k < MAX_RESCUE:
            T = 2.0 * eye - S @ X
            res = float(torch.max(torch.abs(T - eye)))
            X = X @ T
            k += 1
    wide = torch.float64
    for _ in range(f32_polish - 1):
        R = (eye.to(wide) - S.to(wide) @ X.to(wide)).to(S.dtype)
        X = X + X @ R
    return X, k


def sinv_cuda(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(S^-1, info) from the CUDA kernels; S (M, M) float32 SPD, or B
    streams stacked, (B, M, M), in the same memset and six launches (each
    stream's factor on its own CTA, its bits those of its single launch).
    info counts the non-positive pivots of the factorization (0 for an SPD
    S), (1,) int32, or (B,) for stacked streams; it is returned for
    checking and nothing reads it on the path."""
    S = S.contiguous()
    cuda_lib.check_cuda_inputs("sinv", {"S": S})
    M = S.shape[-1]
    lead = tuple(S.shape[:-2])
    if S.shape != lead + (M, M) or len(lead) > 1 or M < 1:
        raise ValueError(f"sinv: S must be square, got {tuple(S.shape)}")
    B = lead[0] if lead else 1
    dev = S.device
    out = torch.empty_like(S)
    # L, the diagonal blocks' inverses, W = L^-1, X, R, then the solve's
    # slabs when they do not fit its shared memory
    sizes = [spd_core.tri(M), -(-M // spd_core.NB) * spd_core.NB ** 2,
             M * M, M * M, M * M,
             -(-M // SLAB) * M * SLAB if M * SLAB * 4 > SOLVE_SMEM_MAX
             else 0]
    # a stream's scratch block, rounded to 16 bytes
    per_stream = -(-sum(sizes) // 4) * 4
    scratch = torch.empty((B * per_stream,), dtype=torch.float32, device=dev)
    ptrs, base = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(base)
        base += 4 * n
    # idx and pos, B x M each, then (Mu, pivots) a stream
    ints = torch.empty((B * (2 * M + 2),), dtype=torch.int32, device=dev)
    cuda_lib.library().call(
        "ekf_sinv_batched", S.data_ptr(), out.data_ptr(), *ptrs,
        ints.data_ptr(), ints.data_ptr() + 4 * B * M,
        ints.data_ptr() + 8 * B * M, M, B, per_stream,
        cuda_lib.stream_of(S))
    LAUNCHES.hit()
    return out, ints[2 * B * M:].view(B, 2)[:, 1]


@functools.cache
def _batched_op():
    def sinv_op(S: torch.Tensor) -> torch.Tensor:
        return sinv_cuda(S)[0]

    def rule(info, in_dims, S):
        S, = batched.stacked(info.batch_size, in_dims, S)
        return sinv_cuda(S)[0], 0

    return batched.custom_op("sinv", sinv_op, rule)


def newton_schulz_inverse(S: torch.Tensor, lam_floor: float = 1.0
                          ) -> torch.Tensor:
    """S^-1 by the S-inverse kernels on CUDA (one launch set for all
    streams under ``torch.func.vmap``), by their plain version
    ``cholesky_inverse`` on the CPU.  ``lam_floor`` keeps the JAX
    signature; the factorization needs no bound on lambda_min and does not
    read it."""
    if S.device.type == "cpu":
        return cholesky_inverse(S)
    if batched.any_batched(S):
        return _batched_op()(S)
    return sinv_cuda(S)[0]


def spd_inverse(S: torch.Tensor, lam_floor: float = 1.0) -> torch.Tensor:
    """S^-1 for SPD S with lambda_min >= lam_floor: the S-inverse kernels
    for a CUDA float32 S up to MAX_KERNEL_M, Cholesky otherwise (large
    maps, the CPU, float64)."""
    if (S.device.type == "cuda" and S.dtype == torch.float32
            and S.shape[0] <= MAX_KERNEL_M):
        return newton_schulz_inverse(S, lam_floor)
    return cholesky_inverse(S)
