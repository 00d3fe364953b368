"""The collectives of the sharded step, counted (port-only; the JAX package
leaves them to GSPMD, and tests/test_sharded_equivalence.py counts them in
the compiled HLO).

The sharded step (parallel/sharding.py) moves data between ranks with one
primitive, a summing ``all_reduce`` over one mesh axis.  Most calls are
masked: each rank writes the entries it owns into zeros, so every other
rank adds exact zeros and the sum places the entries with no rounding.
``Comm`` makes every call and counts it by kind, mesh axis and site, with
its payload bytes, so a run can show what crossed between ranks per step.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist


class Comm:
    """The summing collectives over a mesh's named process groups, each
    call counted under (kind, axis, site)."""

    def __init__(self, groups: dict):
        self.groups = groups            # axis name -> ProcessGroup
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.largest = 0                # most elements in one call

    def all_reduce(self, t: torch.Tensor, axis: str, site: str
                   ) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis``, in a new tensor."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups[axis])
        key = ("all_reduce", axis, site)
        self.calls[key] += 1
        self.bytes[key] += out.numel() * out.element_size()
        self.largest = max(self.largest, out.numel())
        return out

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.largest = 0

    def summary(self) -> dict:
        """{"calls", "bytes"} by "kind/axis/site", their totals, and the
        most elements one call carried."""
        return {"calls": {"/".join(k): v for k, v in self.calls.items()},
                "bytes": {"/".join(k): v for k, v in self.bytes.items()},
                "total_calls": sum(self.calls.values()),
                "total_bytes": sum(self.bytes.values()),
                "largest_elements": self.largest}
