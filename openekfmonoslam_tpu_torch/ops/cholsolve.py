"""The SPD solve X = S^-1 B by blocked Cholesky (port of ops/cholsolve.py).

``chol_solve_cuda`` launches the hand-written CUDA kernels
(``csrc/cholsolve.cu`` over ``csrc/spd_core.cuh``), which replace the TPU
kernel ``_cholsolve_kernel`` / ``chol_solve_pallas``
(openekfmonoslam_tpu/ops/cholsolve.py:102,151): a one-CTA blocked
Cholesky with the TPU kernel's pivot clamp, then both triangular solves
in column slabs across CTAs, two launches.  ``chol_solve_plain`` is its
plain PyTorch version, the TPU kernel's right-looking blocked algorithm
with BS = 64: factor and invert each diagonal block, form the panel below
it, update the trailing matrix, then the two block triangular solves
through the diagonal-block inverses.  Any M and K: the last block is
ragged, not padded.

``solve_spd`` mirrors the JAX wrapper (cholsolve.py:186-207): a CUDA
float32 S launches the kernel, anything else is a Cholesky factorization
and solve (``torch.cholesky_solve``, the counterpart of JAX's
``cho_solve(cho_factor)``).  ``force_kernel=True`` on a CPU tensor runs the
plain version.  As in the JAX package, no engine path calls it: the
update forms S^-1 explicitly (ops/sinv.py).

Bound of the kernel on the H100: operations; see csrc/cholsolve.cu.
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.ops import cuda_lib, spd_core

BS = 64                  # Cholesky block size (the TPU kernel's)
PIVOT_FLOOR = 1e-30      # pivots are clamped here before the rsqrt (:69)
# csrc/cholsolve.cu: the columns of B a solve CTA takes, and the shared
# memory its slab may use before it moves to device memory
SLAB = 8
SOLVE_SMEM_MAX = 96 * 1024

LAUNCHES = cuda_lib.LaunchCounter("cholsolve")


def _factor_block(A: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of a diagonal block, right-looking, with
    the pivot clamp of the TPU kernel."""
    n = A.shape[0]
    A = A.clone()
    L = torch.zeros_like(A)
    idx = torch.arange(n, device=A.device)
    for j in range(n):
        d = torch.rsqrt(torch.clamp(A[j, j], min=PIVOT_FLOOR))
        lcol = torch.where(idx >= j, A[:, j] * d, torch.zeros_like(A[:, j]))
        L[:, j] = lcol
        A[j + 1:, j + 1:] -= torch.outer(lcol[j + 1:], lcol[j + 1:])
    return L


def _invert_lower(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular block by forward substitution:
    W[j, :] = (e_j - L[j, :j] W[:j, :]) / L[j, j]."""
    n = L.shape[0]
    W = torch.zeros_like(L)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    for j in range(n):
        W[j] = (eye[j] - L[j, :j] @ W[:j]) / L[j, j]
    return W


def chol_solve_plain(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = S^-1 B for SPD S (M, M) and B (M, K) by the kernel's blocked
    algorithm, in torch ops."""
    M = S.shape[0]
    A = S.clone()
    L = torch.zeros_like(S)
    Ws = []
    for o in range(0, M, BS):
        e = min(o + BS, M)
        Lkk = _factor_block(A[o:e, o:e])
        Wk = _invert_lower(Lkk)
        Ws.append(Wk)
        L[o:e, o:e] = Lkk
        if e < M:
            panel = A[e:, o:e] @ Wk.T
            L[e:, o:e] = panel
            A[e:, e:] -= panel @ panel.T
    Y = torch.zeros_like(B)
    for k, o in enumerate(range(0, M, BS)):
        e = min(o + BS, M)
        Y[o:e] = Ws[k] @ (B[o:e] - L[o:e, :o] @ Y[:o])
    X = torch.zeros_like(B)
    for k in reversed(range(len(Ws))):
        o = k * BS
        e = min(o + BS, M)
        X[o:e] = Ws[k].T @ (Y[o:e] - L[e:, o:e].T @ X[e:])
    return X


def chol_solve_cuda(S: torch.Tensor, B: torch.Tensor,
                    with_factor: bool = False):
    """X = S^-1 B from the two CUDA launches (the one-CTA factor, then the
    column-slab solve); S (M, M) and B (M, K) float32 on the card, any
    M, K >= 1.  With ``with_factor``, (X, the ``spd_core.Factor`` the
    solve used) for checking."""
    S = S.contiguous()
    B = B.contiguous()
    cuda_lib.check_cuda_inputs("cholsolve", {"S": S, "B": B})
    M = S.shape[0]
    if S.shape != (M, M) or B.dim() != 2 or B.shape[0] != M or M < 1 \
            or B.shape[1] < 1:
        raise ValueError(f"cholsolve: bad shapes S {tuple(S.shape)}, "
                         f"B {tuple(B.shape)}")
    K = B.shape[1]
    X = torch.empty_like(B)
    # L, the diagonal blocks' inverses, then the solve's slabs when they do
    # not fit its shared memory
    Mp = -(-M // spd_core.NB) * spd_core.NB
    sizes = [spd_core.tri(M), Mp * spd_core.NB,
             -(-K // SLAB) * Mp * SLAB if Mp * SLAB * 4 > SOLVE_SMEM_MAX
             else 0]
    scratch = torch.empty((sum(sizes),), dtype=torch.float32,
                          device=S.device)
    ptrs, base = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(base)
        base += 4 * n
    ints = torch.empty((M + 2,), dtype=torch.int32, device=S.device)
    cuda_lib.library().call(
        "ekf_cholsolve", S.data_ptr(), B.data_ptr(), X.data_ptr(), *ptrs,
        ints.data_ptr(), ints.data_ptr() + 4 * M, M, K,
        cuda_lib.stream_of(S))
    LAUNCHES.hit()
    if with_factor:
        return X, spd_core.Factor(scratch[:sizes[0]], ints[:M], ints[M:])
    return X


def solve_spd(S: torch.Tensor, B: torch.Tensor,
              force_kernel: bool | None = None) -> torch.Tensor:
    """S^-1 B: the blocked Cholesky kernel for a CUDA float32 S (its plain
    version for a CPU tensor with ``force_kernel=True``), a library
    Cholesky solve otherwise."""
    use = (force_kernel if force_kernel is not None
           else (S.device.type == "cuda" and S.dtype == torch.float32))
    if not use:
        return torch.cholesky_solve(B, torch.linalg.cholesky(S))
    if S.device.type == "cpu":
        return chol_solve_plain(S, B)
    return chol_solve_cuda(S, B)
