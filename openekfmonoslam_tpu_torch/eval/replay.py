"""Record a live run's injection log and replay it through the filter
(port of eval/replay.py).

A log holds everything the vision front end fed the filter: the bootstrap
detections ``log["init"]`` = [(uv, slot), ...] and per frame
``{"z": (F, 2), "matched": (F,), "new": [(uv, slot), ...]}``.
``record_live_log`` writes it from the live path; the JAX package's
``record_live_log`` writes the same format.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openekfmonoslam_tpu_torch.engine.scan_runner import scan_in_chunks
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
from openekfmonoslam_tpu_torch.filter import features as feat_mod


def record_live_log(runtime: SlamRuntime, frames, chunk: int = 32) -> dict:
    """Run the live engine over ``frames`` (T, H, W) and return
    {"init": [(uv, slot), ...], "frames": [{z, matched, new}, ...],
    "trajectory": (T-1, 13), "records": StepRecord of numpy arrays}.
    ``frames`` may be a uint8 tensor already on the runtime's device."""
    state = runtime.make_initial_state()
    state, uv0, ok0, slot0 = runtime.init_step_recorded(state, frames[0])
    uv0, ok0, slot0 = (a.cpu().numpy() for a in (uv0, ok0, slot0))
    log = {"init": [(uv0[i], int(slot0[i])) for i in range(len(ok0))
                    if ok0[i]],
           "frames": [], "trajectory": None}
    _, recs = scan_in_chunks(runtime, state, frames[1:], chunk)
    for t in range(recs.z.shape[0]):
        new = [(recs.new_uv[t][c], int(recs.new_slot[t][c]))
               for c in range(recs.new_ok.shape[1]) if recs.new_ok[t][c]]
        log["frames"].append({"z": recs.z[t].astype(np.float64),
                              "matched": recs.matched[t].copy(),
                              "new": new})
    log["trajectory"] = recs.x_cam.astype(np.float64)
    log["records"] = recs
    return log


def _additions(entries, C: int):
    """(uv (C, 2), valid (C,), slots (C,)) from [(uv, slot), ...]."""
    uv = np.zeros((C, 2))
    valid = np.zeros((C,), bool)
    slots = np.full((C,), C, np.int32)
    for i, (p, slot) in enumerate(entries[:C]):
        uv[i] = p
        valid[i] = True
        slots[i] = slot
    return uv, valid, slots


class UploadedLog(NamedTuple):
    """An injection log as tensors on the runtime's device."""

    init_uv: torch.Tensor      # (C, 2) bootstrap pixels
    init_valid: torch.Tensor   # (C,) bool
    init_slot: torch.Tensor    # (C,) int32
    z: torch.Tensor            # (T, F, 2)
    matched: torch.Tensor      # (T, F) bool
    new_uv: torch.Tensor       # (T, C, 2)
    new_valid: torch.Tensor    # (T, C) bool
    new_slot: torch.Tensor     # (T, C) int32


def upload_log(runtime: SlamRuntime, log: dict) -> UploadedLog:
    """Copy the whole log to the runtime's device, one array per field."""
    C = runtime.config.max_features
    dev, dtype = runtime.device, runtime.dtype

    def t(a, dt=None):
        return torch.as_tensor(np.array(a), dtype=dt, device=dev)

    uv0, valid0, slots0 = _additions(log["init"], C)
    frames = log["frames"]
    adds = [_additions(fr["new"], C) for fr in frames]
    return UploadedLog(
        init_uv=t(uv0, dtype), init_valid=t(valid0, torch.bool),
        init_slot=t(slots0, torch.int32),
        z=t([fr["z"] for fr in frames], dtype),
        matched=t([fr["matched"] for fr in frames], torch.bool),
        new_uv=t([a[0] for a in adds], dtype),
        new_valid=t([a[1] for a in adds], torch.bool),
        new_slot=t([a[2] for a in adds], torch.int32))


def run_uploaded(runtime: SlamRuntime, log: UploadedLog):
    """Bootstrap and replay an uploaded log; returns (final state, list of
    StepRecords on the device).  Needs no host synchronisation."""
    cfg = runtime.config
    state = runtime.make_initial_state()
    desc = torch.zeros((cfg.max_features,) + tuple(state.descriptors.shape[1:]),
                       dtype=state.descriptors.dtype, device=runtime.device)
    state = feat_mod.add_features_at(state, runtime.camera, cfg, log.init_uv,
                                     desc, log.init_slot, log.init_valid)
    records = []
    for t in range(log.z.shape[0]):
        # adds are replayed INTO the recorder's slot ids so the log's
        # slot-keyed measurements keep addressing the same landmarks
        state, rec = runtime.step_injected(
            state, log.z[t], log.matched[t], new_uv=log.new_uv[t],
            new_desc=desc, new_valid=log.new_valid[t],
            new_slot=log.new_slot[t])
        records.append(rec)
    return state, records


def replay_records(runtime: SlamRuntime, log: dict):
    """Replay the log through step_injected; returns (final state, list of
    StepRecords, left on the runtime's device)."""
    return run_uploaded(runtime, upload_log(runtime, log))


def replay_through_engine(runtime: SlamRuntime, log: dict) -> np.ndarray:
    """Replay the log through step_injected; returns the (T, 13) camera
    trajectory as float64."""
    _, records = replay_records(runtime, log)
    if not records:
        return np.zeros((0, 13))
    traj = torch.stack([rec.x_cam for rec in records])
    return traj.to("cpu", torch.float64).numpy()
