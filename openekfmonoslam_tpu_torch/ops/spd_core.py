"""What the wrappers and their checks share with the compacted, factored
SPD core (``csrc/spd_core.cuh``) that the fused update (``csrc/update.cu``)
and the standalone S-inverse (``csrc/sinv.cu``) are built on: its panel
width ``NB`` and the packed-triangle size ``tri``, which size the
wrappers' scratch, and ``Factor``, what ``ops/update_kernel.
joint_update_cuda`` returns for checking: the packed factor of the used
rows, their indices and the counts, expanded by ``dense_factor`` to the
(M, M) lower-triangular L with L L^T = the masked S.

The kernels' plain versions are ``ops/update_kernel.update_plain`` and
``ops/sinv.cholesky_inverse``; ``tests/test_torch_spd_core.py`` follows
the kernels' factored steps in PyTorch and holds them against the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# csrc/spd_core.cuh: the panel width (one warp's lanes), which sizes the
# wrappers' scratch for the diagonal blocks' inverses
NB = 32


def tri(n: int) -> int:
    """Floats of the packed lower triangle of n rows."""
    return n * (n + 1) // 2


class Factor(NamedTuple):
    """The fused update's factor, from the kernel's scratch: L_packed the
    packed lower triangle of the used rows (row a at tri(a)), idx the used
    rows (the first Mu entries), meta (Mu, non-positive pivots)."""

    L_packed: torch.Tensor
    idx: torch.Tensor
    meta: torch.Tensor


def dense_factor(factor: Factor, M: int) -> torch.Tensor:
    """The (M, M) lower-triangular factor of the masked S in float64: L at
    the used rows and columns, 1 on the diagonal of the unused ones (reads
    the counts back to the host: for checking only)."""
    n = int(factor.meta[0])
    dev = factor.L_packed.device
    out = torch.eye(M, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    rows, cols = torch.tril_indices(n, n, device=dev)
    idx = factor.idx[:n].long()
    out[idx, idx] = 0.0
    out[idx[rows], idx[cols]] = factor.L_packed[:tri(n)].double()
    return out
