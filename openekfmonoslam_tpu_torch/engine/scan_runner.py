"""Sequence runner over frames held on the device (port of
engine/scan_runner.py).

The JAX package uploads a sequence once and runs the step under
``lax.scan``.  Here the frames are uploaded once as a (T, H, W) uint8
tensor and a Python loop calls ``step`` on each; the loop's one host read
a frame is the step's own (engine/step.py ``phase_mapman``).
"""

from __future__ import annotations

import time

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


def phase_share_calibration(runtime: SlamRuntime, frames) -> np.ndarray:
    """The 7 reference phases' shares of the step time (EKF.cpp's
    Prediction/Matching/Ransac/UpdateLI/RescueOutliers/UpdateHI/
    MapManagement), from bracketing each phase method between device syncs
    over ``frames`` (T, H, W): init on frame 0, frame 1 unmeasured (first
    calls), frames 2.. measured.  Scan mode attributes its per-frame time
    by these shares."""
    sync = (torch.cuda.synchronize if runtime.device.type == "cuda"
            else (lambda: None))
    rt = runtime
    state = rt.init_step(rt.make_initial_state(), frames[0])
    totals = np.zeros(7)

    def run_frame(st, frame, acc):
        t = [0.0] * 7

        def bracket(i, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            t[i] = time.perf_counter() - t0
            return out

        st, pred = bracket(0, rt.phase_predict, st)
        m, aux, in_ellipse = bracket(1, rt.phase_match, st, pred, frame)
        res = bracket(2, rt.phase_ransac, st, pred, m)
        st = bracket(3, rt.phase_update_li, st, pred, m, res.inliers)
        pred2, rescued = bracket(4, rt.phase_rescue, st, m, res.outliers)
        st = bracket(5, rt.phase_update_hi, st, pred2, m, rescued)
        st, *_ = bracket(6, rt.phase_mapman, st, pred, m,
                         res.inliers | rescued, aux, in_ellipse)
        if acc is not None:
            acc += np.asarray(t)
        return st

    state = run_frame(state, rt._tensor(frames[1]), None)
    for f in frames[2:]:
        state = run_frame(state, rt._tensor(f), totals)
    s = totals.sum()
    return totals / s if s > 0 else np.full(7, 1.0 / 7)


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
