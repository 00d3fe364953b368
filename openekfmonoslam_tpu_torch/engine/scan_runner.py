"""Sequence runner over frames held on the device (port of
engine/scan_runner.py).

The JAX package uploads a sequence once and runs the step under
``lax.scan``.  Here the frames are uploaded once as a (T, H, W) uint8
tensor and a Python loop calls ``step`` on each; the loop's one host read
a frame is the step's own (engine/step.py ``phase_mapman``).  Each frame's
phases are its ``step.<phase>`` spans (spans.py): the CLI's
``--phase-timing`` collects them.
"""

from __future__ import annotations

import numpy as np
import torch

from openekfmonoslam_tpu_torch.engine.step import SlamRuntime, StepRecord
from openekfmonoslam_tpu_torch.filter.state import SlamState, select_state


def stack_records(records: list[StepRecord]) -> StepRecord:
    """Per-frame records -> one StepRecord with a leading T axis."""
    return StepRecord(*(torch.stack(field) for field in zip(*records)))


def scan_frames(runtime: SlamRuntime, state: SlamState,
                frames: torch.Tensor) -> tuple[SlamState, StepRecord]:
    """Run ``step`` over frames (T, H, W); returns the final state and the
    stacked records (leading axis T)."""
    records = []
    for t in range(frames.shape[0]):
        state, rec = runtime.step(state, frames[t])
        records.append(rec)
    return state, stack_records(records)


def scan_frames_masked(runtime: SlamRuntime, state: SlamState,
                       frames: torch.Tensor, real: torch.Tensor
                       ) -> tuple[SlamState, StepRecord]:
    """scan_frames with a per-frame ``real`` (T,) bool on the device:
    padded frames (real False) run the step but keep the state they were
    given, so the final state is the state after the last real frame."""
    records = []
    for t in range(frames.shape[0]):
        stepped, rec = runtime.step(state, frames[t])
        state = select_state(real[t], stepped, state)
        records.append(rec)
    return state, stack_records(records)


def scan_in_chunks(runtime: SlamRuntime, state: SlamState, frames,
                   chunk: int) -> tuple[SlamState, StepRecord]:
    """``scan_frames`` over ``frames`` (T, H, W), uploading and running
    ``chunk`` frames at a time; returns the final state and the records
    as stacked numpy arrays."""
    parts = []
    for i in range(0, len(frames), max(chunk, 1)):
        state, recs = scan_frames(runtime, state,
                                  runtime._tensor(frames[i:i + chunk]))
        parts.append([f.cpu().numpy() for f in recs])
    return state, StepRecord(*(np.concatenate(f) for f in zip(*parts)))


def run_sequence_on_device(runtime: SlamRuntime, frames, chunk: int = 0):
    """init on frame 0, then step through the rest.  ``frames`` is (T, H,
    W) uint8, numpy or a tensor.  ``chunk`` > 0 uploads and runs the
    frames in chunks of that many (bounds device memory for long
    sequences); 0 uploads them all at once.

    Returns (final_state, StepRecord of stacked numpy arrays)."""
    state = runtime.init_step(runtime.make_initial_state(), frames[0])
    rest = frames[1:]
    return scan_in_chunks(runtime, state, rest,
                          chunk if chunk > 0 else len(rest))
