"""Where a frame of the PyTorch/CUDA port's replay path spends its time.

    python3 tools/profile_torch_replay.py [frames]

Records chip_smoke.py's synthetic injection log on the GPU, replays it once
to warm up, then replays it under ``torch.profiler`` and prints the host
wall time per frame, the device time per frame summed over every kernel,
the device's idle share, the host and device time of each phase of the
step (its profiler ranges), and the kernels by device time (all of them in
chiprun_out/torch_replay_profile.json).  Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from openekfmonoslam_tpu_torch.config import SlamConfig  # noqa: E402
from openekfmonoslam_tpu_torch.engine.step import (  # noqa: E402
    PHASE_PREFIX, SlamRuntime)
from openekfmonoslam_tpu_torch.eval import replay  # noqa: E402


def main(frames: int = 60) -> int:
    if not torch.cuda.is_available():
        print("profile_torch_replay: needs a CUDA device", file=sys.stderr)
        return 1
    runtime = SlamRuntime(SlamConfig())
    scene = chip_smoke.Scene(runtime.camera, np.random.default_rng(7))
    log, _, _, _ = chip_smoke.record_log(runtime, scene, frames, seed=11)
    ulog = replay.upload_log(runtime, log)
    replay.run_uploaded(runtime, ulog)                    # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay.run_uploaded(runtime, ulog)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the step's phase ranges also appear on the device's timeline; they
    # span kernels and are not kernels themselves
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith(PHASE_PREFIX)]
    device_us = sum(e.self_device_time_total for e in events)
    wall_ms = wall * 1e3 / frames
    dev_ms = device_us / 1e3 / frames
    print(f"card: {chip_smoke.smi_line()}")
    print(f"{frames} frames: host wall {wall_ms:.4f} ms/frame, device "
          f"{dev_ms:.4f} ms/frame summed over kernels, idle share "
          f"{1 - dev_ms / wall_ms:.4f}")
    phases = chip_smoke.phase_times(prof, frames)
    print("phases (host ms/frame, device ms/frame of PyTorch's kernels):")
    for name, t in phases.items():
        print(f"  {t['host_ms']:10.4f} {t['device_ms']:10.4f}  {name}")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    print("kernels by device time (us/frame, calls/frame):")
    for e in rows[:30]:
        print(f"  {e.self_device_time_total / frames:10.2f} "
              f"{e.count / frames:7.2f}  {e.key[:100]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_replay_profile.json").write_text(json.dumps({
        "frames": frames, "wall_ms_per_frame": wall_ms,
        "device_ms_per_frame": dev_ms, "phases": phases,
        "kernels": [{"name": e.key, "us_per_frame":
                     e.self_device_time_total / frames,
                     "calls_per_frame": e.count / frames} for e in rows]},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
