"""What a traced run reads: the profiler's device activity and host ranges,
and the host syncs of PyTorch's sync debug mode, reduced to what the
per-layer readers (metrics/*.py) and the breakdown take.

Device time comes from the profiler's own device records (kernels, copies
and memsets, the ctypes-launched kernels among them), never from the
ranges' device time, which misses the ctypes launches.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
import warnings
from pathlib import Path

import torch

WINDOW = "slambench.window"     # the range around the traced window
FRAME = "slambench.frame"       # the range around each call of the entry
PHASES = ("step.predict", "step.match", "step.ransac", "step.update_li",
          "step.rescue", "step.update_hi", "step.mapman")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Interval:
    name: str
    start: int      # ns
    end: int        # ns
    kind: str = ""
    corr: int = 0   # device: the host op that launched it (its link)


def _kind(e) -> str:
    return e.activity_type() if hasattr(e, "activity_type") else ""


def split_events(events) -> tuple[list, list, dict]:
    """(device activity, host ranges, the start of each host op by its
    correlation id) of the profiler's raw events.  A device record links
    to the host op (an operator, or the innermost ``record_function``
    range) that was open when it was launched, as the profiler's own
    attribution of kernels to operators does."""
    device, host, ops = [], [], {}
    for e in events:
        start = e.start_ns()
        iv = Interval(e.name(), start, start + e.duration_ns(), _kind(e))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if iv.kind in DEVICE_KINDS or (
                    not iv.kind and not e.is_user_annotation()):
                iv.corr = e.linked_correlation_id()
                device.append(iv)
            continue
        if e.linked_correlation_id() == 0 and e.correlation_id() > 0:
            ops[e.correlation_id()] = start
        if iv.kind == "user_annotation" or e.is_user_annotation():
            host.append(iv)
    return device, host, ops


def merged(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals
                   if i.end > lo and i.start < hi)
    out: list[list[int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list: "void ns::sinv_flags<false>(float*)" is "sinv_flags<false>"."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if name.startswith("void "):
        name = name[len("void "):]
    head, _, args = name.partition("<")
    return head.rsplit("::", 1)[-1] + (_ + args if _ else "")


@dataclasses.dataclass
class Trace:
    """One traced window, as the per-layer readers see it."""

    steps: int                   # calls of the entry
    frames: int                  # frames of every stream
    window: tuple[int, int]      # ns
    device: list                 # Interval, inside the window
    host: list                   # Interval, the named host ranges
    syncs: collections.Counter   # host syncs by source line
    used_rows: list              # per step: [(li rows, hi rows)] a stream
    n_state: int
    n_slots: int
    ops: dict = dataclasses.field(default_factory=dict)  # id: start ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device, *self.window)) / 1e9

    def kernels(self, prefixes) -> list:
        return [i for i in self.device if i.kind in ("kernel", "")
                and short_name(i.name).startswith(tuple(prefixes))]

    def launched_in(self, names) -> list:
        """The kernels launched from a host op that began inside a range
        named in ``names`` (ranges of one name do not overlap)."""
        ranges = sorted((i.start, i.end) for i in self.host
                        if i.name in names)
        starts = [r[0] for r in ranges]
        out = []
        for i in self.device:
            t = self.ops.get(i.corr) if i.kind in ("kernel", "") else None
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t < ranges[k][1]:
                out.append(i)
        return out

    def host_s(self, names) -> float:
        return sum(i.end - i.start for i in self.host if i.name in names) \
            / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost host range they fell in."""
        ops = collections.Counter()
        for i in self.device:
            ops[short_name(i.name)] += (i.end - i.start) / 1e9
        busy = merged(self.device, *self.window)
        gaps = collections.Counter()
        ranges = sorted(self.host, key=lambda i: i.end - i.start)
        edges = [self.window[0]] + [t for se in busy for t in se] \
            + [self.window[1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            where = next((i.name for i in ranges
                          if i.start <= mid < i.end), "outside any range")
            gaps[where] += (e - s) / 1e9
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


@contextlib.contextmanager
def sync_counter(sites: collections.Counter):
    """Count the host syncs by source line while the block runs
    (PyTorch's sync debug mode)."""
    def on_warning(message, category, filename, lineno, *rest):
        if "synchronizing CUDA operation" in str(message):
            sites[f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def traced(run_steps, settle, n_state: int, n_slots: int) -> Trace:
    """Run ``run_steps()`` (which returns (steps, frames)) under the
    profiler and the sync counter; ``settle()``, after the window, gives
    the rows each step's updates used."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sites: collections.Counter = collections.Counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with sync_counter(sites), record_function(WINDOW):
            steps, frames = run_steps()
            torch.cuda.synchronize()
    used = settle()
    t = time.perf_counter()
    device, host, ops = split_events(prof.profiler.kineto_results.events())
    win = [i for i in host if i.name == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the traced window's range was seen {len(win)} "
                           "times")
    lo, hi = win[0].start, win[0].end
    host = [i for i in host if i.name != WINDOW]
    device = [i for i in device if i.end > lo and i.start < hi]
    ops = {k: v for k, v in ops.items() if lo <= v < hi}
    linked = sum(i.corr in ops for i in device)
    print(f"trace: {len(device)} device records ({linked} linked to a host "
          f"op of the window), {len(host)} host ranges, read in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return Trace(steps, frames, (lo, hi), device, host, sites, used,
                 n_state, n_slots, ops)
