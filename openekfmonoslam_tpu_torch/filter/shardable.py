"""Row/column placement on the covariance P (port of filter/shardable.py).

In the JAX package these helpers express slice writes as predicate
selects so that a row-sharded P is never gathered.  The port uses plain
indexing: a slice write into a copy of P, or, for an offset computed on
the device, ``index_copy`` (which ``torch.func.vmap`` batches where an
index write into a copy does not).  Its sharded step
(parallel/sharding.py) applies them to a rank's tile of P.  ``start`` may be a
Python int or a 0-dim integer tensor (a slot offset computed on the
device), which is indexed without a host sync.
Every helper returns a new tensor; P itself is never written.
"""

from __future__ import annotations

import torch


def _index(start, k: int, device) -> torch.Tensor | slice:
    if isinstance(start, int):
        return slice(start, start + k)
    return start.to(device=device, dtype=torch.long) + torch.arange(
        k, device=device)


def place_rows(P: torch.Tensor, rows: torch.Tensor, start) -> torch.Tensor:
    """P with rows[start : start+k, :] <- ``rows`` (k, N)."""
    idx = _index(start, rows.shape[0], P.device)
    if not isinstance(idx, slice):
        return P.index_copy(0, idx, rows)
    out = P.clone()
    out[idx] = rows
    return out


def place_cols(P: torch.Tensor, cols: torch.Tensor, start) -> torch.Tensor:
    """P with cols[:, start : start+k] <- ``cols`` (N, k)."""
    idx = _index(start, cols.shape[1], P.device)
    if not isinstance(idx, slice):
        return P.index_copy(1, idx, cols)
    out = P.clone()
    out[:, idx] = cols
    return out


def place_block(P: torch.Tensor, blk: torch.Tensor, r0, c0) -> torch.Tensor:
    """P with the (k, k) block at (r0, c0) <- ``blk``."""
    k = blk.shape[0]
    ri = _index(r0, k, P.device)
    ci = _index(c0, k, P.device)
    if isinstance(ri, slice) and isinstance(ci, slice):
        out = P.clone()
        out[ri, ci] = blk
        return out
    # the rows through the block, with the block copied in, copied back
    if isinstance(ri, slice):
        ri = torch.arange(ri.start, ri.stop, device=P.device)
    if isinstance(ci, slice):
        ci = torch.arange(ci.start, ci.stop, device=P.device)
    strip = torch.index_select(P, 0, ri).index_copy(1, ci, blk)
    return P.index_copy(0, ri, strip)


def select_rows(P: torch.Tensor, start, k: int) -> torch.Tensor:
    """Rows [start : start+k] of P as a (k, N) tensor."""
    return P[_index(start, k, P.device)]
