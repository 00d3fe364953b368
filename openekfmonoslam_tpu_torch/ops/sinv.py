"""SPD inverses for the joint update (port of ops/sinv.py, plain versions).

``spd_inverse`` is the Cholesky-against-I inverse the JAX package uses off
the TPU (ops/sinv.py:222-225); the plain joint update (filter/update.py)
runs it.  ``ns_inverse`` is the scaled Newton-Schulz iteration of the TPU
kernels (ns_inverse_into, ops/sinv.py:68) in full precision, kept as the
plain statement of that algorithm.

The standalone TPU kernel ``sinv_pallas`` is not on the ported path (it
runs only where the TPU update kernel does not apply); the CUDA joint
update computes S^-1 inside its own kernel (csrc/update.cu).
"""

from __future__ import annotations

import torch

N_ITERS = 12
F32_POLISH = 2


def spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """S^-1 for SPD S by Cholesky factorization and a solve against I."""
    L = torch.linalg.cholesky(S)
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    return torch.cholesky_solve(eye, L)


def ns_inverse(S: torch.Tensor, lam_floor: float = 1.0,
               n_iters: int = N_ITERS, f32_polish: int = F32_POLISH
               ) -> torch.Tensor:
    """Newton-Schulz SPD inverse X <- X (2I - S X) from X0 = c I,
    c = 1.8 / (lam_floor + ||S||_inf), with the residual-gated rescue of
    the TPU kernel: when the first polish step's residual max|SX - I|
    exceeds 0.05, restart from X0 and iterate until it is <= 5e-4."""
    m = S.shape[0]
    eye = torch.eye(m, dtype=S.dtype, device=S.device)
    c = 1.8 / (lam_floor + torch.max(torch.sum(torch.abs(S), dim=1)))
    X = c * eye
    for _ in range(n_iters - f32_polish):
        X = X @ (2.0 * eye - S @ X)
    T = 2.0 * eye - S @ X
    bad = bool(torch.max(torch.abs(T - eye)) > 0.05)
    X = X @ T
    if bad:
        X = c * eye
        res, k = 1.0, 0
        while res > 5e-4 and k < 128:
            T = 2.0 * eye - S @ X
            res = float(torch.max(torch.abs(T - eye)))
            X = X @ T
            k += 1
    for _ in range(f32_polish - 1):
        X = X @ (2.0 * eye - S @ X)
    return X
