"""The live step's sync-free prefix as one CUDA graph per input key.

``SlamRuntime.step`` runs everything before the read of (add?, needed) in
``phase_mapman`` without a host sync, on shapes that the configuration
fixes: predict, match, RANSAC, both updates, the rescue, the counters and
culls, and the conversion (``SlamRuntime.prefix``).  On a single-device
CUDA runtime the step captures that prefix once per key (the frame's
shape and dtype, the state's shapes and dtypes) and replays it:

- the first call of a key runs eagerly: it builds the kernels and fills
  the caches, cuBLAS's handles and cuDNN's plans among them;
- the second runs the prefix once on a side stream, so that the stream's
  own handles and workspaces exist before the capture, then captures it
  on that stream and replays the graph;
- every later call replays it.

A replay copies the state and the frame into the graph's static inputs,
launches the graph on the current stream, and copies the state and the
record's fields out into fresh tensors, one grouped copy a dtype each
way.  A caller may keep what it passed in and what a step returned across
later steps: nothing returned is a static buffer or a view of one.  The
prediction, the front end's maps and the gate mask come back as the
graph's own buffers, for ``phase_mapman``'s detection on the frames that
add, which runs before the next replay.

``LaunchCounter.hit()`` counts in Python, which a replay does not run: a
graph keeps the hits its capture made and adds them at each replay, so a
replayed frame counts the launches an eager one does.
"""

from __future__ import annotations

import time

import torch

from openekfmonoslam_tpu_torch.ops import cuda_lib


def step_key(state, gray: torch.Tensor) -> tuple:
    """What a captured prefix is specialised to: the frame's shape and
    dtype and the state's shapes and dtypes."""
    return (tuple(gray.shape), gray.dtype,
            tuple((tuple(t.shape), t.dtype) for t in state))


def _dtype_groups(tensors) -> list[list[int]]:
    """The positions of ``tensors`` grouped by dtype."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def _copy(dst, src, groups) -> None:
    """dst[i] <- src[i], one grouped copy a dtype."""
    for idx in groups:
        torch._foreach_copy_([dst[i] for i in idx], [src[i] for i in idx])


def _kept(prefix) -> list[torch.Tensor]:
    """The prefix's outputs that the caller keeps: the state's fields and
    the record's, in order (the record's camera fields are None)."""
    return [t for t in (*prefix.state, *prefix.record) if t is not None]


def _with_kept(prefix, kept):
    """``prefix`` with its state and record made of ``kept``."""
    it = iter(kept)
    state = type(prefix.state)(*(next(it) for _ in prefix.state))
    record = type(prefix.record)(*(None if v is None else next(it)
                                   for v in prefix.record))
    return prefix._replace(state=state, record=record)


class _Captured:
    """One captured prefix: the graph, its static inputs and outputs, and
    the launches its capture counted."""

    def __init__(self, graph, inputs, outputs, hits):
        self.graph = graph
        self.inputs = inputs
        self.in_groups = _dtype_groups(inputs)
        self.outputs = outputs
        self.kept = _kept(outputs)
        self.out_groups = _dtype_groups(self.kept)
        self.hits = hits

    def replay(self, state, gray):
        _copy(self.inputs, [*state, gray], self.in_groups)
        self.graph.replay()
        for counter, n in self.hits:
            counter.count += n
        fresh = [torch.empty_like(t) for t in self.kept]
        _copy(fresh, self.kept, self.out_groups)
        return _with_kept(self.outputs, fresh)


class StepGraphs:
    """The captured prefixes of one runtime, by key (``step_key``)."""

    def __init__(self):
        self._seen: set = set()
        self._graphs: dict = {}
        self._stream = None
        self.captures: dict = {}     # key: captures made (1 at most)
        self.capture_s: dict = {}    # key: seconds of its capture call

    def mode(self, key) -> str:
        """"replay" for a captured key, "capture" for a key run once,
        "eager" for a new key (noted as run once)."""
        if key in self._graphs:
            return "replay"
        if key in self._seen:
            return "capture"
        self._seen.add(key)
        return "eager"

    def run(self, mode: str, key, prefix, state, gray):
        """``prefix(state, gray)`` by the graph of ``key``, captured first
        where ``mode`` is "capture"."""
        if mode == "capture":
            t0 = time.perf_counter()
            self._graphs[key] = self._capture(prefix, state, gray)
            self.capture_s[key] = time.perf_counter() - t0
            self.captures[key] = self.captures.get(key, 0) + 1
        return self._graphs[key].replay(state, gray)

    def _capture(self, prefix, state, gray) -> _Captured:
        counters = cuda_lib.COUNTERS
        start = [c.count for c in counters]
        inputs = [t.clone() for t in (*state, gray)]
        st, fr = type(state)(*inputs[:-1]), inputs[-1]
        if self._stream is None:
            self._stream = torch.cuda.Stream(gray.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(gray.device))
        with torch.cuda.stream(stream):
            prefix(st, fr)
        torch.cuda.current_stream(gray.device).wait_stream(stream)
        before = [c.count for c in counters]
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls do not break it
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = prefix(st, fr)
        hits = [(c, c.count - b) for c, b in zip(counters, before)
                if c.count != b]
        # the warm-up's launches and the capture's are not a frame's: the
        # replays count the capture's
        for c, n in zip(counters, start):
            c.count = n
        return _Captured(graph, inputs, outputs, hits)
