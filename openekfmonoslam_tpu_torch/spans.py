"""Named spans around the step's phases and their parts.

    from openekfmonoslam_tpu_torch import spans
    with spans.span("step.match"):
        ...

A span costs one flag check while neither ``torch.profiler`` nor the
recorder is on: it builds no ``record_function`` and makes no dispatcher
call.  Under ``torch.profiler`` it is a ``record_function`` range, so a
trace sees it on the clock of the device's activity.  With the recorder on
(``enable()``), each span that closes appends a ``Span(name, depth, frame,
t0_ns, t1_ns)`` to a bounded buffer that ``drain()`` empties: ``depth`` is
the number of spans open around it on its thread, ``frame`` the frame
index of the innermost enclosing span that was given one (``engine.step``
gives ``SlamEngine``'s; -1 outside), and the stamps are
``time.perf_counter_ns()`` moved by the offset to ``time.time_ns()`` taken
at ``enable()``, the profiler's clock (Unix epoch nanoseconds).
``collect()`` hands one thread's spans to a list of its own while a block
runs, the recorder on or not: the engine's and scan mode's phase timing.
The step runs eagerly while its thread collects (``collecting()``), so
that each of its seven phases gives a span.

The names (README.md lists them with what reads each):

    engine.step                    one SlamEngine.step, its frame index
      engine.upload                the frame to the device
      step.replay                  on the card, SlamRuntime.step's captured
                                   prefix (predict .. the conversion) as
                                   one CUDA graph, with its copies in and
                                   out (engine/step_graph.py); step.mapman
                                   then holds read.add and the additions
      step.<phase> x 7             SlamRuntime.step's phases, where it runs
                                   them eagerly
        match.precompute, match.gate, match.detect, match.describe,
        match.nn, match.subpixel   (match.ncc on the NCC route)
        ransac.hypotheses (the CPU's plain chain only), ransac.support
        (on the card the one RANSAC launch), ransac.pick
        mapman.maintain, mapman.convert, read.add, mapman.detect,
        mapman.add
      read.summary                 the record's one packed copy
      engine.record                the record dict, files and sinks
    batch.upload                   the batched step's frames (pageable)

``step_injected`` opens ``step_injected.<phase>`` ranges instead.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 18      # spans the buffer holds; later ones are dropped
# SlamRuntime.step's phases in their order, the reference's seven
# (EKF.cpp:255-618: Prediction .. MapManagement)
PHASES = ("step.predict", "step.match", "step.ransac", "step.update_li",
          "step.rescue", "step.update_hi", "step.mapman")


class Span(NamedTuple):
    name: str
    depth: int      # spans open around it on its thread
    frame: int      # the innermost frame index given, -1 if none
    t0_ns: int      # the profiler's clock (Unix epoch ns)
    t1_ns: int


class _Thread(threading.local):
    depth = 0
    frame = -1
    sink = None     # collect()'s list


_on = False             # the recorder, or a thread's collect(), is on
_recording = False      # the recorder
_collecting = 0         # threads inside collect()
_lock = threading.Lock()
_buffer: list = []
_dropped = 0
_thread = _Thread()
_profiler_enabled = torch._C._autograd._profiler_enabled
_new = tuple.__new__    # a Span without NamedTuple's slower constructor


def _epoch_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), the perf counter read on
    both sides of the wall clock."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


_offset = _epoch_offset()


class _Off:
    """The span of a run with nothing to record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    __slots__ = ("name", "frame", "range", "stamp", "outer_frame", "depth",
                 "t0")

    def __init__(self, name: str, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(
                self.name, None if self.frame is None else str(self.frame))
        self.stamp = _on
        if self.stamp:
            t = _thread
            self.depth = t.depth
            t.depth += 1
            self.outer_frame = t.frame
            if self.frame is not None:
                t.frame = self.frame
            # just outside the profiler's range, as its stamps are taken
            # inside its enter and exit
            self.t0 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__enter__()
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.stamp:
            t1 = time.perf_counter_ns()
            t = _thread
            entry = _new(Span, (self.name, self.depth, t.frame,
                                self.t0 + _offset, t1 + _offset))
            t.depth = self.depth
            t.frame = self.outer_frame
            _keep(entry, t.sink)
        return False


def _keep(entry: Span, sink) -> None:
    global _dropped
    if _recording:
        if len(_buffer) < CAPACITY:
            _buffer.append(entry)
        else:
            _dropped += 1
    if sink is not None:
        sink.append(entry)


def span(name: str, frame: int | None = None):
    """A context manager around a named part of the work; ``frame`` tags
    it and the spans inside it with a frame index."""
    if not _on and not _profiler_enabled():
        return _OFF
    return _Live(name, frame)


def enable() -> None:
    """Turn the recorder on, and take the offset to the profiler's
    clock."""
    global _on, _recording, _offset
    with _lock:
        _offset = _epoch_offset()
        _recording = _on = True


def disable() -> None:
    """Turn the recorder off; what it holds stays for ``drain()``."""
    global _on, _recording
    with _lock:
        _recording = False
        _on = _collecting > 0


def recording() -> bool:
    return _recording


def drain() -> list[Span]:
    """The spans recorded since the last drain, in the order they closed
    (a child before its parent); empties the buffer."""
    global _buffer, _dropped
    with _lock:
        out, _buffer = _buffer, []
        _dropped = 0
    return out


def dropped() -> int:
    """Spans lost to a full buffer since the last drain."""
    return _dropped


def phase_times_us(entries) -> list[list[float]]:
    """Per step, in the order run, the microseconds of its seven
    ``step.<phase>`` spans (PHASES' order) among ``entries``."""
    at = {name: k for k, name in enumerate(PHASES)}
    out: list[list[float]] = []
    for e in entries:
        k = at.get(e.name)
        if k is None:
            continue
        if k == 0:
            out.append([0.0] * len(PHASES))
        out[-1][k] = (e.t1_ns - e.t0_ns) / 1e3
    return out


def collecting() -> bool:
    """True inside ``collect()`` on this thread."""
    return _thread.sink is not None


@contextlib.contextmanager
def collect():
    """Hand this thread's spans that close inside the block to the list it
    yields (beside the recorder's buffer, when that is on)."""
    global _on, _collecting
    t = _thread
    outer = t.sink
    got: list[Span] = []
    with _lock:
        _collecting += 1
        _on = True
    t.sink = got
    try:
        yield got
    finally:
        t.sink = outer
        with _lock:
            _collecting -= 1
            _on = _recording or _collecting > 0
