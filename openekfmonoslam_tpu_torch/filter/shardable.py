"""Row/column placement on the covariance P (port of filter/shardable.py).

In the JAX package these helpers express slice writes as predicate
selects so that a row-sharded P is never gathered.  The port keeps one
device and plain indexing, so each helper is a copy of P plus a slice
write.  ``start`` may be a Python int or a 0-dim integer tensor (a slot
offset computed on the device), which is indexed without a host sync.
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
    out = P.clone()
    out[_index(start, rows.shape[0], P.device)] = rows
    return out


def place_cols(P: torch.Tensor, cols: torch.Tensor, start) -> torch.Tensor:
    """P with cols[:, start : start+k] <- ``cols`` (N, k)."""
    out = P.clone()
    out[:, _index(start, cols.shape[1], P.device)] = cols
    return out


def place_block(P: torch.Tensor, blk: torch.Tensor, r0, c0) -> torch.Tensor:
    """P with the (k, k) block at (r0, c0) <- ``blk``."""
    k = blk.shape[0]
    out = P.clone()
    ri = _index(r0, k, P.device)
    ci = _index(c0, k, P.device)
    if isinstance(ri, slice) and isinstance(ci, slice):
        out[ri, ci] = blk
    else:
        ri = torch.arange(P.shape[0], device=P.device)[ri]
        ci = torch.arange(P.shape[1], device=P.device)[ci]
        out[ri[:, None], ci[None, :]] = blk
    return out


def select_rows(P: torch.Tensor, start, k: int) -> torch.Tensor:
    """Rows [start : start+k] of P as a (k, N) tensor."""
    return P[_index(start, k, P.device)]
