"""One kernel launch for B streams under ``torch.func.vmap``.

``parallel/batch_runner.py`` runs the step's phases under
``torch.func.vmap``, so a kernel wrapper is called with functorch
BatchedTensors, which have no storage for ``data_ptr()`` to point at.
Each kernel wrapper therefore has a ``torch.library.custom_op`` whose
vmap rule (``torch.library.register_vmap``) takes the real stacked
tensors, moves each one's stream axis to the front (expanding an operand
that all streams share, such as the camera pose of a shared frame), and
makes ONE launch of the kernel over the B streams (a stream index in its
grid).  The wrappers enter the custom op only for a batched input: the
single-stream path calls its launcher directly, with no dispatch of the
custom op on its host time.  The ops are registered at their first
batched call; importing this module registers nothing.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch._C._functorch import is_batchedtensor


def any_batched(*tensors) -> bool:
    """Whether any of ``tensors`` is a BatchedTensor (we are under vmap)."""
    return any(t is not None and is_batchedtensor(t) for t in tensors)


def stacked(batch_size: int, in_dims, *tensors) -> list[torch.Tensor]:
    """Each tensor with its stream axis first and contiguous: a batched
    one's axis ``in_dims[i]`` moved to 0, an unbatched one (in_dim None)
    expanded to ``batch_size`` copies."""
    out = []
    for t, d in zip(tensors, in_dims):
        if d is None:
            t = t.expand((batch_size,) + tuple(t.shape))
        else:
            t = t.movedim(d, 0)
        out.append(t.contiguous())
    return out


def custom_op(name: str, fn: Callable, rule: Callable):
    """``fn`` as the custom op ``ekf::<name>`` (its schema from its
    annotations), with ``rule`` (info, in_dims, *args) -> (outputs,
    out_dims) as its vmap rule."""
    op = torch.library.custom_op(f"ekf::{name}", fn, mutates_args=())
    torch.library.register_vmap(op, rule)
    return op
