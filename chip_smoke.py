#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # device and the CUDA toolkit (nvcc)
    python3 chip_smoke.py --kernels-only    # phases 1 and 2 alone
    python3 chip_smoke.py --replay-seeds 1,2,7   # phase 4's float64
                                 # agreement at other scenes (phase 1 first)

Phases, each of which passes or raises (the script then exits non-zero):

  1. build    compile csrc/*.cu for sm_90a (one nvcc per source, in
              parallel) into build/torch_kernels/ and load the library;
  2. kernels  each hand-written kernel at the main path's shapes (N = 640,
              F = 96, 2F = 192, C = 96) against its plain PyTorch version
              run in float64 on the card, plus the factor the update used
              (L L^T against the float64 masked S), the no-use bit-exact
              pass-through and the exact symmetry of P' (the update also
              on the path's own frame-T/2 data, in phase 3); then each
              kernel's device time (CUDA graph of 200 launches), its eager
              time, the plain version's time and its bound, and for the
              update and the S-inverse each launch's device time by kernel
              name under torch.profiler; predict also at the large map's
              N = 1024, and the per-launch floor (an empty hand-written
              kernel in the same CUDA-graph harness);
  3. path     SlamRuntime(SlamConfig()) on the card at full s3 width: a
              closed-loop synthetic scene records an injection log (about
              160 points, a smooth camera path, 1 px noise, 5% outliers),
              then the log is replayed through the replay entry point
              (eval/replay.py run_uploaded) with every launch counter set
              to 0 just before and read just after, which gives frames/s;
              then two more replays: one counts host syncs per frame
              under PyTorch's sync debug mode, one takes each phase's
              host and device ms from torch.profiler's ranges and the
              device launches a call of predict_measurements;
  4. replay   the same log through the port on the CPU in float64 (the
              plain path), held against the card's float32 trajectory;
  5. live     the live entry points on 640x480 synthetic frames (a window
              sliding over a blob texture) under the s3 profile (STAR,
              BRIEF-256, descriptor matching with subpixel refinement):
              run_sequence_on_device (init_step, then step per frame) with
              every launch counter set to 0 just before and read just
              after, which gives frames/s; then a run under sync debug
              mode (host syncs per frame, at most 1), one under
              torch.profiler (host and device ms per step.<phase>), STAR
              and BRIEF against their plain versions on frame T/2's own
              image, and the live injection log (eval/replay.py
              record_live_log) replayed through step_injected on the CPU
              in float64, held against the card's trajectory.

  6. large   the engine API on the large map: SlamEngine("config.yml")
              with the s3 profile and MaxMapSize 960, which sizes the map
              at F = 168 slots, N = 1024 (2F = 336), so every update takes
              the chain with the S-inverse kernel and none the fused
              update; run_sequence over the phase-5 frames with every
              launch counter set to 0 just before and read just after,
              which gives frames/s; a run under sync debug mode (at most
              2 host syncs a frame, at the summary fetch in
              SlamEngine.step and the read in phase_mapman), one under
              torch.profiler (per-phase ms) that saves a checkpoint at
              frame 100 which a fresh engine resumes to the end (records
              bit for bit), the S-inverse on a kept frame's own S against
              float64, and the live log replayed on the CPU in float64.
  7. parity   the bug-compatible parity mode (reference_quirks and
              ransac_parity_visit, max_hypotheses 1000): phase 3's log
              replayed on the card with every launch counter set to 0 just
              before and read just after (2 quirks-variant measure and 2
              S-inverse launches a step, no fused update, 0 host syncs),
              then its first 40 frames under the profiler, and the visit
              scan alone; the same log on the CPU in float64
              through the port's quirks path (1e-5 m a frame, masks equal
              on 99% of frames) and through the bug-compatible oracle
              (eval/oracle.py, ATE < 1e-5 path + 1e-7); then
              SlamEngine("config.yml", reference_quirks=True,
              ransac_parity_visit=True) on the s3 map (F = 96) over 101
              live frames: the same launch rules with STAR and BRIEF once a
              frame, at most 2 host syncs a frame, healthy tracking, 40
              steps under the profiler, and its live log replayed in
              float64 (1e-4 m, masks 95%).

Phase 2 also checks STAR and BRIEF against their float32 plain versions
(bit for bit) on a textured 640x480 frame and on an odd 483x645 one:
STAR by both routes (the staged one the s3 settings take, and the direct
one), BRIEF by both variants (s256, the shipped pattern's, and generic)
and a 512-bit pattern by the generic variant; then the S-inverse kernel
at M = 192, 336, 512 and 640 (cond 1e2, 1e3, 1e4, and the update's
masked S at M = 336) against float64, the fused update
against the chain with the S-inverse kernel at N = 1024, 2F = 336, the
measure kernel's quirks variant against the float64 plain quirks chain,
and the blocked Cholesky solve at (M, K) from (1, 1) to (512, 640) against
the float64 solve (timed at (192, 640) and (336, 1024), beside
torch.linalg.solve).

The line before the last is one JSON object with a row per kernel (its
launches from its path: phase 5 for the six kernels of the s3 live path
and for STAR's direct route and BRIEF's generic variant, which no shipped
setting takes, phase 6 for the S-inverse, phase 7's engine for the
measure kernel's quirks variant; the Cholesky solve has no path; the
S-inverse's times and bound are on a kept frame's S of phase 6).  The
last line is {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from openekfmonoslam_tpu_torch.config import DetectorConfig, SlamConfig
from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.engine import checkpoint as ckpt_mod
from openekfmonoslam_tpu_torch.engine import engine as engine_mod
from openekfmonoslam_tpu_torch.engine import scan_runner
from openekfmonoslam_tpu_torch.engine import step as step_mod
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine, run_sequence
from openekfmonoslam_tpu_torch.engine.step import (LIVE_PHASE_PREFIX,
                                                   PHASE_PREFIX, SlamRuntime)
from openekfmonoslam_tpu_torch.eval import oracle, replay
from openekfmonoslam_tpu_torch.eval.trajectory import ate_rmse
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter import measure as meas_mod
from openekfmonoslam_tpu_torch.filter import predict as pred_mod
from openekfmonoslam_tpu_torch.filter import ransac as ransac_mod
from openekfmonoslam_tpu_torch.filter import update as upd_mod
from openekfmonoslam_tpu_torch.filter.state import dim_active_mask
from openekfmonoslam_tpu_torch.io.sources import SlidingWindowSource
from openekfmonoslam_tpu_torch.ops import (brief_kernel, cholsolve,
                                           cuda_lib, init_kernel,
                                           measure_kernel, predict_kernel,
                                           sinv, spd_core, star_kernel,
                                           update_kernel)
from openekfmonoslam_tpu_torch.vision import brief, star

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

KERNELS = {
    "predict": dict(counter=predict_kernel.LAUNCHES,
                    source="openekfmonoslam_tpu_torch/csrc/predict.cu",
                    replaces="openekfmonoslam_tpu/ops/predict_kernel.py:48"),
    "measure": dict(counter=measure_kernel.LAUNCHES,
                    source="openekfmonoslam_tpu_torch/csrc/measure.cu",
                    replaces="openekfmonoslam_tpu/ops/measure_kernel.py:44"),
    # the QUIRKS instantiation of the same kernel (quirks=True, :115-131)
    "measure_quirks": dict(
        counter=measure_kernel.QUIRKS_LAUNCHES,
        source="openekfmonoslam_tpu_torch/csrc/measure.cu",
        replaces="openekfmonoslam_tpu/ops/measure_kernel.py:44"),
    "update": dict(counter=update_kernel.LAUNCHES,
                   source="openekfmonoslam_tpu_torch/csrc/update.cu",
                   replaces="openekfmonoslam_tpu/ops/update_kernel.py:73"),
    "init": dict(counter=init_kernel.LAUNCHES,
                 source="openekfmonoslam_tpu_torch/csrc/init.cu",
                 replaces="openekfmonoslam_tpu/ops/init_kernel.py:48"),
    # _resp_kernel (:45) and _score_kernel (:69) in one launch: the route
    # that stages the integral-image window (max size up to 44) ...
    "star": dict(counter=star_kernel.LAUNCHES,
                 source="openekfmonoslam_tpu_torch/csrc/star.cu",
                 replaces="openekfmonoslam_tpu/ops/star_kernel.py:45"),
    # ... and the one that reads it through the read-only path
    "star_direct": dict(counter=star_kernel.DIRECT_LAUNCHES,
                        source="openekfmonoslam_tpu_torch/csrc/star.cu",
                        replaces="openekfmonoslam_tpu/ops/star_kernel.py:45"),
    # the shipped pattern's variant, and the one for any other pattern
    "brief": dict(counter=brief_kernel.LAUNCHES,
                  source="openekfmonoslam_tpu_torch/csrc/brief.cu",
                  replaces="openekfmonoslam_tpu/ops/brief_kernel.py:43"),
    "brief_generic": dict(
        counter=brief_kernel.GENERIC_LAUNCHES,
        source="openekfmonoslam_tpu_torch/csrc/brief.cu",
        replaces="openekfmonoslam_tpu/ops/brief_kernel.py:43"),
    "sinv": dict(counter=sinv.LAUNCHES,
                 source="openekfmonoslam_tpu_torch/csrc/sinv.cu",
                 replaces="openekfmonoslam_tpu/ops/sinv.py:169"),
    # no path: as in the JAX package, no engine path calls solve_spd
    "cholsolve": dict(counter=cholsolve.LAUNCHES,
                      source="openekfmonoslam_tpu_torch/csrc/cholsolve.cu",
                      replaces="openekfmonoslam_tpu/ops/cholsolve.py:102"),
}


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["counter"].reset()


def read_launches() -> dict:
    return {name: spec["counter"].count for name, spec in KERNELS.items()}

T_FRAMES = 220          # frames of the replay path (>= 200)
T_LIVE = 201            # frames of the live path: init_step + 200 steps
LIVE_HW = (480, 640)    # the s3 frame size
GRAPH_REPS = 200        # kernel launches per timed CUDA graph
EAGER_REPS = 200        # eager kernel launches per timing
PLAIN_REPS = 50         # plain-version calls per timing
SPLIT_REPS = 50         # calls per profiled split of a row by kernel name

# bounds of the kernel checks (float32 kernel vs float64 plain version)
TOL = {
    "predict_x": 1e-6, "predict_P": 1e-4,
    "measure_rtol": 1e-6,            # plus 1e-6 * max(|a|, 1) absolute
    "update_x": 5e-5, "update_P": 5e-4, "update_sym": 1e-5,
    "update_factor_rel": 1e-4,      # L L^T of the update's factor vs S
    "init_feats": 1e-5, "init_J1": 2e-2, "init_J2": 1e-4,
    # tests/test_cholsolve.py:32 on A A^T + 10 I; 1e-6 cond on spd_cond
    "chol_rel": 1e-4,
}
# float32 card trajectory vs the float64 CPU replay of the same log: the
# camera-position deviation on every frame (metres; about ten times the
# largest seen on the H100 over 220 frames, 9.8e-7), and the share of
# frames whose inlier and visibility masks must be identical
REPLAY_TOL = 1e-5
REPLAY_MASKS_SAME = 0.99
# the live log replayed in float64 against the card's live trajectory:
# predicted about 1e-6 m, as on the replay path; the bound allows one
# borderline RANSAC decision to flip
LIVE_REPLAY_TOL = 1e-4
LIVE_MASKS_SAME = 0.95
LIVE_SYNCS_PER_FRAME = 1.0    # the (add?, needed) read of phase_mapman
# the large map: MaxMapSize 960 sizes F = 168 slots, N = 1024, 2F = 336
LARGE_F, LARGE_N = 168, 1024
# the engine's summary fetch and the read of phase_mapman
LARGE_SYNCS_PER_FRAME = 2.0
LARGE_CKPT_AT = 100           # the frame whose checkpoint is resumed
# the parity mode (phase 7): the reference's bug-compatible filter
PARITY = dict(reference_quirks=True, ransac_parity_visit=True)
T_PARITY_LIVE = 101           # the parity engine: init + 100 steps
# frames of phase 7's runs under the profiler (its cost grows with the
# frames traced: about half a second a frame)
PARITY_PROFILED = 40
# the bug-compatible oracle is plain NumPy: it replays the log until this
# many seconds have gone, and then stops once it has done ORACLE_MIN_FRAMES
ORACLE_BUDGET_S = 120.0
ORACLE_MIN_FRAMES = 100


class PhaseError(RuntimeError):
    pass


def check(failures: list, ok: bool, what: str) -> None:
    print(("  pass " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


T_START = time.perf_counter()


def end_phase(name: str, failures: list) -> None:
    if failures:
        raise PhaseError(f"phase {name} failed: " + "; ".join(failures))
    print(f"phase {name}: ok ({time.perf_counter() - T_START:.1f} s into "
          "the run)", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_times(averages, frames: int, prefix: str = PHASE_PREFIX) -> dict:
    """{phase: {"host_ms", "device_ms"}} a frame from the profiler ranges
    that step_injected (or step, with LIVE_PHASE_PREFIX) opens around its
    phases: the host's wall time inside each range, and the device time of
    the PyTorch kernels launched in it.  The hand-written kernels are
    launched through ctypes, outside any PyTorch op, and the profiler does
    not count them in a range: their times are the kernel table's."""
    out = {}
    for e in averages:
        if (e.key.startswith(prefix)
                and e.device_type == torch.autograd.DeviceType.CPU):
            out[e.key[len(prefix):]] = {
                "host_ms": e.cpu_time_total / 1e3 / frames,
                "device_ms": e.device_time_total / 1e3 / frames}
    return out


def device_ms(averages, frames: int) -> float:
    """Device ms a frame of everything the profiler saw run on the card:
    PyTorch's kernels, the hand-written kernels launched through ctypes,
    memsets and copies.  The step's phase ranges also appear on the device
    timeline (as annotations spanning their kernels) and are left out."""
    return sum(e.device_time_total for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith((PHASE_PREFIX, LIVE_PHASE_PREFIX))) \
        / 1e3 / frames


# device kernels of the hand-written STAR and BRIEF functions, by name
LIVE_KERNEL_NAMES = ("star_tile_staged", "star_tile_direct",
                     "brief_planes_s256", "brief_planes_generic")
# the PyTorch chains beside them, by the range phase 5 opens around each
FRONTEND_CHAINS = {"frontend.smooth": (brief, "smooth"),
                   "frontend.integral": (star, "_integral")}
# ... and the measurement prediction of phase 3's replay (the measure
# kernel with H P and S beside it)
MEASURE_CHAIN = {"filter.predict_measurements": (meas_mod,
                                                 "predict_measurements")}
# ... of the S-inverse (csrc/sinv.cu) and of the fused update (update.cu)
SINV_KERNEL_NAMES = ("sinv_flags", "sinv_factor", "sinv_solve",
                     "sinv_product<0>", "sinv_product<1>", "sinv_product<2>")
UPDATE_KERNEL_NAMES = ("update_factor", "update_solve", "update_downdate")


def print_device(dev_ms: float, kernels_us: dict) -> None:
    print(f"  device ms a frame under the profiler (all kernels): "
          f"{dev_ms:.4f}" + "".join(
              f"; {k} {v['us_per_frame']:.2f} us a frame, "
              f"{v['calls_per_frame']:.2f} calls" for k, v in
              kernels_us.items()), flush=True)


def kernel_device_us(averages, frames: int,
                     names=LIVE_KERNEL_NAMES) -> dict:
    """{kernel: {"us_per_frame", "calls_per_frame"}} for the device kernels
    named in ``names``, from the profiler's device activity (it sees
    ctypes launches, which its op ranges do not)."""
    out = {}
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if (e.key.startswith(name + "(") or e.key == name
                    or "::" + name + "(" in e.key):
                out[name] = {"us_per_frame": e.device_time_total / frames,
                             "calls_per_frame": e.count / frames}
    return out


@contextlib.contextmanager
def chain_ranges(chains=FRONTEND_CHAINS):
    """Open a profiler range, named by each key of ``chains``, around every
    call of its (module, function) while the block runs."""
    saved = []
    for name, (module, attr) in chains.items():
        fn = getattr(module, attr)

        def ranged(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)

        saved.append((module, attr, fn))
        setattr(module, attr, ranged)
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def chain_device(events, frames: int, names=tuple(FRONTEND_CHAINS)) -> dict:
    """{range: device us, device launches (kernels, copies, memsets),
    calls and host us, each a frame} of the ranges ``chain_ranges``
    opened, from the profiler's events."""
    def launches(e):
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)

    out = {n: dict(device_us=0.0, launches=0.0, calls=0.0, host_us=0.0)
           for n in names}
    for e in events:
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            row = out[e.name]
            row["device_us"] += e.device_time_total / frames
            row["launches"] += launches(e) / frames
            row["calls"] += 1 / frames
            row["host_us"] += e.cpu_time_total / frames
    return out


# ----------------------------------------------------------------- timing

def events_ms(fn, reps: int, warm: int = 5) -> float:
    """Device-timeline ms per call of ``fn`` over ``reps`` eager calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int = GRAPH_REPS) -> float:
    """Device ms per call of ``fn`` with no host in the way: ``reps`` calls
    captured into one CUDA graph, replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def device_split_us(fn, reps: int = SPLIT_REPS) -> dict:
    """{device kernel name: device us a call of ``fn``} under
    torch.profiler over ``reps`` eager calls after a warm-up: the split of
    a wrapper's launches by kernel name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            e.device_time_total / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0}


def count_syncs(fn) -> tuple[collections.Counter, float]:
    """Run ``fn`` under PyTorch's sync debug mode; the host syncs by the
    source line that caused them, and the seconds it took."""
    sites: collections.Counter = collections.Counter()

    def on_warning(message, category, filename, lineno, *rest):
        if "synchronizing CUDA operation" in str(message):
            sites[f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites, seconds


# ----------------------------------------------------------------- phase 1

def phase_build() -> dict:
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    seconds = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.log").write_text(lib.build_log)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)
    print(f"build seconds: {seconds:.3f} (nvcc {lib.build_seconds:.3f})",
          flush=True)
    return {"build_s": seconds}


# ----------------------------------------------------------------- phase 2

def _spd_state(rng, N: int):
    P0 = rng.standard_normal((N, 80))
    P = P0 @ P0.T / 80 + 0.5 * np.eye(N)
    P = 0.5 * (P + P.T)        # exactly symmetric, as the filter keeps P
    x = rng.standard_normal(N) * 0.1
    q = rng.standard_normal(4)
    x[3:7] = q / np.linalg.norm(q)
    return P, x


def _measure_scene(rng, F: int):
    feats = np.zeros((F, 6))
    feats[:, 3] = rng.normal(0, 0.3, F)
    feats[:, 4] = rng.normal(0, 0.2, F)
    feats[:, 5] = np.abs(rng.normal(1.0, 0.3, F)) + 0.2
    feats[:, 0:3] = rng.normal(0, 0.05, (F, 3))
    is_xyz = rng.random(F) < 0.3
    for i in np.nonzero(is_xyz)[0]:
        th, ph, rho = feats[i, 3], feats[i, 4], feats[i, 5]
        m = np.array([np.cos(ph) * np.sin(th), -np.sin(ph),
                      np.cos(ph) * np.cos(th)])
        feats[i, 0:3] += m / rho
        feats[i, 3:] = 0
    active = rng.random(F) < 0.9
    q = np.array([1.0, 0.02, -0.03, 0.01])
    cam7 = np.concatenate([rng.normal(0, 0.02, 3), q / np.linalg.norm(q)])
    return feats, is_xyz, active, cam7


def _update_problem(rng, N: int, F: int, use_frac: float):
    P, x = _spd_state(rng, N)
    H = rng.standard_normal((2 * F, N)) * 0.05
    HP = H @ P
    Sfull = HP @ H.T
    uv = rng.uniform(0, 600, (F, 2))
    z = uv + rng.standard_normal((F, 2))
    use = rng.uniform(size=F) < use_frac
    return P, x, HP, Sfull, uv, z, use


def _masked_S(Sfull: torch.Tensor, use: torch.Tensor, pixel_error: float):
    u2 = use[:, None].expand(-1, 2).reshape(-1).to(Sfull.dtype)
    r = torch.where(u2 > 0, torch.full_like(u2, pixel_error),
                    torch.ones_like(u2))
    return Sfull * (u2[:, None] * u2[None, :]) + torch.diag(r)


def update_flops(Mu: int, N: int) -> float:
    """The operations the update needs on Mu used rows of a state of N:
    only those rows of HP and S carry data.  In factored form, counted in
    multiply-adds: Cholesky of S_u (Mu^3 / 6), V = L^-1 HP_u (Mu^2 N / 2),
    the downdate V^T V on one triangle (Mu N^2 / 2: P' is symmetric), y
    and dx = V^T y (Mu^2 / 2 + Mu N); two operations each."""
    return 2 * (Mu ** 3 / 6 + Mu * Mu * N / 2 + Mu * N * N / 2
                + Mu * Mu / 2 + Mu * N)


def check_predict(failures, tag, Pp, xp, lin, ang) -> dict:
    """The predict kernel against its float64 plain version: x and P
    within their bounds, P'[13:, 13:] passed through bit-exact, P' exactly
    symmetric; returns the kernel-table row."""
    N = Pp.shape[0]
    x_k, P_k = predict_kernel.predict(Pp, xp, 1.0, lin, ang)
    x_t, P_t = predict_kernel.predict_plain(Pp.double(), xp.double(), 1.0,
                                            lin, ang)
    ex, eP = max_abs(x_k, x_t), max_abs(P_k, P_t)
    check(failures, ex <= TOL["predict_x"],
          f"{tag} x err {ex:.3e} <= {TOL['predict_x']}")
    check(failures, eP <= TOL["predict_P"],
          f"{tag} P err {eP:.3e} <= {TOL['predict_P']}")
    check(failures, torch.equal(P_k[13:, 13:], Pp[13:, 13:]),
          f"{tag} P[13:, 13:] passes through bit-exact")
    check(failures, torch.equal(P_k, P_k.T), f"{tag} P' exactly symmetric")
    macs = 2 * 13 * 13 * (N - 13) + 13 * 13 * 2 * (13 * 13 + 13)
    return dict(
        max_abs_err=max(ex, eP), N=N,
        bytes=4 * (2 * N * N + 2 * N), flops=2 * macs,
        kernel=lambda: predict_kernel.predict(Pp, xp, 1.0, lin, ang),
        plain=lambda: predict_kernel.predict_plain(Pp, xp, 1.0, lin, ang))


def check_measure(failures, tag, camera, cam7, feats, is_xyz, active,
                  quirks: bool) -> tuple[float, tuple]:
    """The measure kernel against its float64 plain version: visibility
    equal, the visible slots' uv, Hc and Hf within 1e-6 relative, and the
    masks exact (invisible slots, Hc's columns 7:13 and the retired dims
    of XYZ slots are 0 in both); returns the largest error and the float64
    outputs."""
    got = measure_kernel.measure(camera, cam7, feats, is_xyz, active,
                                 quirks=quirks)
    ref = measure_kernel.measure_plain(camera, cam7.double(), feats.double(),
                                       is_xyz, active, quirks=quirks)
    m = ref[3]
    check(failures, torch.equal(got[3], m),
          f"{tag} visibility equal ({int(m.sum())} of {m.numel()} visible)")
    err = 0.0
    for name, a, b in zip(("uv", "Hc", "Hf"), ref[:3], got[:3]):
        masked = [b[~m]] + ([b[:, :, 7:]] if name == "Hc" else []) \
            + ([b[is_xyz][:, :, 3:]] if name == "Hf" else [])
        check(failures, all(torch.equal(t, torch.zeros_like(t))
                            for t in masked),
              f"{tag} {name} masked exactly as the plain version")
        a, b = a[m], b[m].double()
        lim = TOL["measure_rtol"] * (a.abs() + max(float(a.abs().max()), 1.0))
        worst = float(((b - a).abs() / lim).max())
        err = max(err, max_abs(a, b))
        check(failures, worst <= 1.0,
              f"{tag} {name} within rtol 1e-6 of the float64 plain version "
              f"(worst {worst:.3f} of the bound, abs err {max_abs(a, b):.3e})")
    return err, ref


def check_update(failures, tag, P, x, HP, Sfull, uv, z, use, pe) -> dict:
    """The update kernel against its float64 plain version, and the factor
    it used against the float64 masked S (L L^T); returns the errors."""
    x_k, P_k, factor = update_kernel.joint_update_cuda(P, x, HP, Sfull, uv,
                                                       z, use, pe)
    d = [a.double() for a in (P, x, HP, Sfull, uv, z)]
    x_t, P_t = update_kernel.update_plain(*d, use, pe)
    S64 = _masked_S(d[3], use, pe)
    L = spd_core.dense_factor(factor, S64.shape[0])
    eig = torch.linalg.eigvalsh(S64)
    e = {"x": max_abs(x_k, x_t), "P": max_abs(P_k, P_t),
         "sym": max_abs(P_k, P_k.T),
         "factor_rel": max_abs(L @ L.T, S64) / float(S64.abs().max()),
         "pivots": int(factor.meta[1]),
         "cond_S": float(eig.max() / eig.min()),
         "used_rows": int(use.sum()) * 2}
    check(failures, e["x"] <= TOL["update_x"],
          f"update[{tag}] x err {e['x']:.3e} <= {TOL['update_x']}")
    check(failures, e["P"] <= TOL["update_P"],
          f"update[{tag}] P err {e['P']:.3e} <= {TOL['update_P']}")
    check(failures, e["sym"] <= TOL["update_sym"],
          f"update[{tag}] max|P'-P'^T| {e['sym']:.3e} <= {TOL['update_sym']}")
    check(failures, e["factor_rel"] <= TOL["update_factor_rel"]
          and e["pivots"] == 0,
          f"update[{tag}] factor: L L^T rel err {e['factor_rel']:.3e} <= "
          f"{TOL['update_factor_rel']}, {e['pivots']} non-positive pivots "
          f"({e['used_rows']} used rows, cond(S) {e['cond_S']:.3e})")
    return e


def blob_texture(rng, h: int, w: int) -> np.ndarray:
    """A dark noisy background with bright square blobs of 2-12 px: many
    STAR responses above the s3 threshold of 30."""
    img = rng.integers(0, 30, (h, w))
    for _ in range(h * w // 80):
        y, x, r = rng.integers(0, h), rng.integers(0, w), rng.integers(1, 7)
        img[max(y - r, 0):y + r, max(x - r, 0):x + r] = rng.integers(60, 256)
    return img.astype(np.uint8)


def star_ops(settings) -> int:
    """Operations a pixel of the STAR function: per scale two box sums
    (3 adds, 1 multiply each), the difference, |.| and the running max;
    then the gradients (4), the three products, three separable 5x5 box
    sums (30 adds), det, trace and the gate (8), the threshold (2), and a
    separable (2r+1)^2 max with its test (4r + 3)."""
    n_sizes = len(star.star_sizes(settings.max_size))
    return 11 * n_sizes + 4 + 3 + 30 + 8 + 2 + 4 * settings.nms_radius + 3


def wide_pattern(frontend, dev):
    """A 512-bit pattern (BytesLength 64) of the s3 patch: the generic
    BRIEF variant's row."""
    desc = frontend.config.descriptor
    return brief_kernel.BriefPattern.make(*brief.make_shared_pattern(
        512, desc.patch_size, desc.pattern_seed), dev)


def check_star_brief(failures, tag: str, gray, frontend,
                     both: bool = False) -> dict:
    """STAR and BRIEF against their float32 plain versions on the card, on
    the same integral image and the same smoothed image: bit for bit.
    With ``both``, STAR by both routes and BRIEF by both variants, and a
    512-bit pattern by the generic one."""
    h, w = gray.shape
    s = frontend.star
    ii = star._integral(gray, star.integral_pad(s.max_size))
    raw_p, nms_p = star_kernel.star_plain(ii, h, w, s)
    peaks = int((nms_p > 0).sum())
    e_star = {}
    for route in (star_kernel.star_plan(s)[0], "direct")[:2 if both else 1]:
        raw, nms = star_kernel.star_cuda(ii, h, w, s, route)
        e_star[route] = max(max_abs(raw, raw_p), max_abs(nms, nms_p))
        check(failures, torch.equal(raw, raw_p) and torch.equal(nms, nms_p),
              f"star[{tag} {h}x{w}, {route}] raw and nms identical to the "
              f"plain version ({peaks} peaks, max |diff| "
              f"{e_star[route]:.3e})")
    smoothed = brief.smooth(gray, frontend.config.descriptor.blur_sigma)
    bits = {}
    cases = [(frontend.pattern.variant, frontend.pattern)]
    if both:
        cases += [("generic", frontend.pattern),
                  ("generic", wide_pattern(frontend, gray.device))]
    for variant, pattern in cases:
        planes = brief_kernel.dense_planes_cuda(smoothed, pattern, variant)
        planes_p = brief_kernel.dense_planes_plain(smoothed, pattern)
        n = sum(int(brief.popcount32(a ^ b).sum())
                for a, b in zip(planes, planes_p))
        key = f"{variant}_{pattern.pairs.shape[0]}"
        bits[key] = n
        check(failures, n == 0 and len(planes) == len(planes_p),
              f"brief[{tag} {h}x{w}, {variant}] {len(planes)} planes of "
              f"{tuple(planes[0].shape)} bit-identical ({n} bits differ)")
    return dict(ii=ii, smoothed=smoothed, star_err=e_star,
                brief_bits=bits, peaks=peaks)


def phase_kernels(cfg: SlamConfig, camera, frontend,
                  dev=torch.device("cuda", 0)) -> dict:
    """Each kernel against its plain version (float64 for the filter
    kernels, float32 bit for bit for STAR and BRIEF), then its times."""
    print("== phase 2: kernels", flush=True)
    N, F, C = cfg.padded_state_dim, cfg.max_features, cfg.max_features
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    failures: list = []
    rows: dict = {}

    # ---- predict: the s3 state, then the large map's N = 1024 (its own
    # generator, so the inputs of the checks after it stay as they were)
    lin, ang = cfg.ekf.linear_accel_sd ** 2, cfg.ekf.angular_accel_sd ** 2
    rows["predict"] = check_predict(
        failures, "predict", *(torch.tensor(a, **f32)
                               for a in _spd_state(rng, N)), lin, ang)
    rows["predict_n1024"] = check_predict(
        failures, "predict_n1024", *(torch.tensor(a, **f32) for a in
                                     _spd_state(np.random.default_rng(1024),
                                                LARGE_N)), lin, ang)

    # ---- measure
    feats, is_xyz, active, cam7 = _measure_scene(rng, F)
    feats, cam7 = torch.tensor(feats, **f32), torch.tensor(cam7, **f32)
    is_xyz = torch.tensor(is_xyz, device=dev)
    active = torch.tensor(active, device=dev)
    err, ref = check_measure(failures, "measure", camera, cam7, feats,
                             is_xyz, active, False)
    rows["measure"] = dict(
        max_abs_err=err,
        bytes=4 * (7 + 6 * F) + 2 * F + 4 * (2 + 26 + 12) * F + F,
        flops=600 * F,
        kernel=lambda: measure_kernel.measure(camera, cam7, feats, is_xyz,
                                              active),
        plain=lambda: measure_kernel.measure_plain(camera, cam7, feats,
                                                   is_xyz, active))

    # ---- measure, the quirks variant (the parity mode's), on the same slots
    err, quirky = check_measure(failures, "measure_quirks", camera, cam7,
                                feats, is_xyz, active, True)
    m = ref[3]
    check(failures, max_abs(quirky[1][m], ref[1][m]) > 1e-6,
          "the quirks chain differs from the correct math (Hc by "
          f"{max_abs(quirky[1][m], ref[1][m]):.3e})")
    rows["measure_quirks"] = dict(
        rows["measure"], max_abs_err=err,
        kernel=lambda: measure_kernel.measure(camera, cam7, feats, is_xyz,
                                              active, quirks=True),
        plain=lambda: measure_kernel.measure_plain(camera, cam7, feats,
                                                   is_xyz, active,
                                                   quirks=True))

    # ---- update
    pe = cfg.camera.pixel_error_x
    prob = _update_problem(rng, N, F, 0.6)
    P, x, HP, Sfull, uv, z = (torch.tensor(a, **f32) for a in prob[:6])
    use = torch.tensor(prob[6], device=dev)
    e = check_update(failures, "synthetic", P, x, HP, Sfull, uv, z, use, pe)
    none = torch.zeros_like(use)
    x_n, P_n, _ = update_kernel.joint_update_cuda(P, x, HP, Sfull, uv, z,
                                                  none, pe)
    check(failures, torch.equal(x_n, x) and torch.equal(P_n, P),
          "update with no slot used returns x and P bit-identical")
    Mu = int(use.sum()) * 2
    rows["update"] = dict(
        max_abs_err=max(e["x"], e["P"]), checks=e, split=True,
        bytes=4 * (2 * N * N + 2 * N + Mu * N + Mu * Mu + 4 * F) + F,
        flops=update_flops(Mu, N),
        kernel=lambda: update_kernel.joint_update(P, x, HP, Sfull, uv, z,
                                                  use, pe),
        plain=lambda: update_kernel.update_plain(P, x, HP, Sfull, uv, z,
                                                 use, pe))

    # ---- init
    q = rng.standard_normal(4)
    c7 = torch.tensor(np.concatenate([rng.normal(0, 0.1, 3),
                                      q / np.linalg.norm(q)]), **f32)
    cuv = torch.tensor(rng.uniform(20, 600, (C, 2)), **f32)
    rho0 = cfg.ekf.init_inv_depth_rho
    got = init_kernel.init_chain(camera, c7, cuv, rho0)
    ref = init_kernel.init_plain(camera, c7.double(), cuv.double(), rho0)
    errs = [max_abs(a, b) for a, b in zip(got, ref)]
    for name, err_i, tol in zip(("feats", "J1", "J2"), errs,
                                (TOL["init_feats"], TOL["init_J1"],
                                 TOL["init_J2"])):
        check(failures, err_i <= tol, f"init {name} err {err_i:.3e} <= {tol}")
    rows["init"] = dict(
        max_abs_err=max(errs),
        bytes=4 * (7 + (2 + 6 + 42 + 18) * C), flops=250 * C,
        kernel=lambda: init_kernel.init_chain(camera, c7, cuv, rho0),
        plain=lambda: init_kernel.init_plain(camera, c7, cuv, rho0))

    # ---- star, brief: the main path's 640x480 frame, then an odd shape
    h, w = LIVE_HW
    gray = torch.tensor(blob_texture(rng, h, w), device=dev)
    main = check_star_brief(failures, "main", gray, frontend, both=True)
    odd = check_star_brief(failures, "odd", torch.tensor(
        blob_texture(rng, 483, 645), device=dev), frontend, both=True)
    check(failures, main["peaks"] >= 1000,
          f"the textured frame has {main['peaks']} STAR peaks (>= 1000)")
    s_set, pattern = frontend.star, frontend.pattern
    wide = wide_pattern(frontend, dev)
    ii, smoothed = main["ii"], main["smoothed"]
    planned = star_kernel.star_plan(s_set)[0]
    check(failures, planned == "staged" and pattern.variant == "s256",
          f"the s3 settings take the staged STAR route ({planned}) and the "
          f"s256 BRIEF variant ({pattern.variant})")
    for name, route in (("star", "staged"), ("star_direct", "direct")):
        rows[name] = dict(
            max_abs_err=max(main["star_err"][route], odd["star_err"][route]),
            bytes=4 * (ii.numel() + 2 * h * w),
            flops=star_ops(s_set) * h * w,
            kernel=lambda route=route: star_kernel.star_cuda(ii, h, w, s_set,
                                                             route),
            plain=lambda: star_kernel.star_plain(ii, h, w, s_set))
    # max_abs_err: differing bits (0 = bit-identical); the operations are
    # one compare and one bit insert per bit
    for name, pat, variant in (("brief", pattern, "s256"),
                               ("brief_generic", wide, "generic"),
                               ("brief_generic_256", pattern, "generic")):
        n_bits, half = pat.pairs.shape[0], pat.half
        ih, iw = h - 2 * half, w - 2 * half
        key = f"{variant}_{n_bits}"
        rows[name] = dict(
            max_abs_err=float(main["brief_bits"][key]
                              + odd["brief_bits"][key]),
            n_bits=n_bits, bytes=4 * (h * w + (n_bits // 32) * ih * iw),
            flops=2 * n_bits * ih * iw,
            kernel=lambda pat=pat, variant=variant:
                brief_kernel.dense_planes_cuda(smoothed, pat, variant),
            plain=lambda pat=pat: brief_kernel.dense_planes_plain(smoothed,
                                                                  pat))

    # ---- sinv: the standalone S-inverse at M = 2F of the large map and
    # around it, against float64
    sinv_checks = []
    cases = [(m, cond, spd_cond(m, cond)) for m in SINV_M
             for cond in SINV_CONDS] + [(336, "masked", masked_s(336))]
    for m, cond, s_np in cases:
        S = torch.tensor(s_np, **f32)
        rel, err, info = check_sinv(failures, f"M {m} cond {cond}", S,
                                    sinv_limit(cond))
        sinv_checks.append(dict(M=m, cond=cond, rel_err=rel, abs_err=err,
                                info=info))
    S336 = torch.tensor(spd_cond(336, 1e2), **f32)
    rows["sinv_spd336"] = sinv_row(S336, max(
        c["abs_err"] for c in sinv_checks if c["M"] == 336))

    # ---- cholsolve: X = S^-1 B against the float64 solve (its own
    # generator, so the inputs of the checks after it stay as they were)
    crng = np.random.default_rng(5)
    chol_checks = []
    for m_, k_ in CHOL_SHAPES:
        B_ = torch.tensor(crng.normal(size=(m_, k_)), **f32)
        cases = [("A A^T + 10 I", spd_plus(crng, m_), TOL["chol_rel"])] + [
            (f"cond {c:.0e}", spd_cond(m_, c), 1e-6 * c)
            for c in CHOL_CONDS]
        for tag, s_np, limit in cases:
            S_ = torch.tensor(s_np, **f32)
            rel = chol_rel_err(cholsolve.chol_solve_cuda(S_, B_), S_, B_)
            chol_checks.append(dict(M=m_, K=k_, case=tag, rel_err=rel))
            check(failures, rel <= limit,
                  f"cholsolve[M {m_}, K {k_}, {tag}] rel err {rel:.3e} <= "
                  f"{limit:.1e}")
    for m_, k_ in CHOL_TIMED:
        S_ = torch.tensor(spd_plus(crng, m_), **f32)
        B_ = torch.tensor(crng.normal(size=(m_, k_)), **f32)
        rows[f"cholsolve_{m_}x{k_}"] = dict(
            max_abs_err=max_abs(cholsolve.chol_solve_cuda(S_, B_),
                                torch.linalg.solve(S_.double(),
                                                   B_.double())),
            M=m_, K=k_, bytes=4 * (m_ * m_ + 2 * m_ * k_),
            flops=m_ ** 3 / 3 + 2 * m_ * m_ * k_,
            kernel=lambda S_=S_, B_=B_: cholsolve.chol_solve_cuda(S_, B_),
            plain=lambda S_=S_, B_=B_: cholsolve.chol_solve_plain(S_, B_),
            library=lambda S_=S_, B_=B_: torch.linalg.solve(S_, B_))
    rows["cholsolve"] = rows.pop(f"cholsolve_{CHOL_TIMED[0][0]}x"
                                 f"{CHOL_TIMED[0][1]}")
    rows["cholsolve"]["checks"] = chol_checks

    # ---- the fused update against the chain with the S-inverse kernel
    # on one problem at the large map's N = 1024, 2F = 336
    Fl = LARGE_F
    Nl = 13 + 6 * Fl + (-(13 + 6 * Fl)) % 128
    prob = _update_problem(rng, Nl, Fl, 0.6)
    Pl, xl, HPl, Sfl, uvl, zl = (torch.tensor(a, **f32) for a in prob[:6])
    usel = torch.tensor(prob[6], device=dev)
    argsl = (Pl, xl, HPl, Sfl, uvl, zl, usel, pe)
    x64, P64 = update_kernel.update_plain(
        *[a.double() for a in argsl[:6]], usel, pe)
    Mu = int(usel.sum()) * 2
    for tag, fn in (("update_fused_n1024", update_kernel.joint_update),
                    ("update_chain_n1024", upd_mod.update_chain)):
        xk, Pk = fn(*argsl)
        ex, eP = max_abs(xk, x64), max_abs(Pk, P64)
        check(failures, ex <= TOL["update_x"] and eP <= TOL["update_P"],
              f"{tag}: x err {ex:.3e} <= {TOL['update_x']}, P err "
              f"{eP:.3e} <= {TOL['update_P']}")
        rows[tag] = dict(
            max_abs_err=max(ex, eP), split=tag == "update_fused_n1024",
            bytes=4 * (2 * Nl * Nl + 2 * Nl + Mu * Nl + Mu * Mu + 4 * Fl)
            + Fl,
            flops=update_flops(Mu, Nl),
            kernel=lambda fn=fn: fn(*argsl),
            plain=lambda: update_kernel.update_plain(*argsl))
    rows["sinv_spd336"]["checks"] = sinv_checks
    end_phase("kernels (checks)", failures)

    for name, row in rows.items():
        time_row(name, row)
    # the per-launch floor: an empty hand-written kernel in the same harness
    rows["floor"] = dict(
        ms=graph_ms(lambda: cuda_lib.library().call(
            "ekf_noop", torch.cuda.current_stream(dev).cuda_stream)),
        card=smi_line())
    print(f"  floor (empty kernel): {rows['floor']['ms'] * 1e3:.2f} "
          f"us/launch on the device; {rows['floor']['card']}", flush=True)
    print(f"  timed ({time.perf_counter() - T_START:.1f} s into the run)",
          flush=True)
    return rows


def time_row(name: str, row: dict) -> None:
    """A kernel row's device time (CUDA graph), eager time, plain and
    library times and bound, in place; drops its callables."""
    row["ms"] = graph_ms(row["kernel"])
    row["eager_ms"] = events_ms(row["kernel"], EAGER_REPS)
    row["plain_ms"] = events_ms(row["plain"], PLAIN_REPS)
    library = row.pop("library", None)
    row["library_ms"] = (events_ms(library, EAGER_REPS)
                         if library is not None else None)
    row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["flops"])
    if row.pop("split", False):
        row["split_us"] = device_split_us(row["kernel"])
        print(f"  {name} by kernel under the profiler (device us a call): "
              + ", ".join(f"{k} {v:.2f}" for k, v in row["split_us"].items()),
              flush=True)
    lib = ("" if row["library_ms"] is None
           else f", library {row['library_ms'] * 1e3:.2f} us")
    print(f"  {name}: {row['ms'] * 1e3:.2f} us/launch on the device "
          f"(eager {row['eager_ms'] * 1e3:.2f} us), plain "
          f"{row['plain_ms'] * 1e3:.2f} us{lib}, bound "
          f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
          f"({row['bytes']} B, {row['flops']} flop)", flush=True)
    del row["kernel"], row["plain"]


# ------------------------------------------------------- the S-inverse

SINV_M = (192, 336, 512, 640)
SINV_CONDS = (1e2, 1e3, 1e4)


def spd_cond(m: int, cond: float, seed: int = 0) -> np.ndarray:
    """tests/test_sinv.py ``_spd``: eigenvalues geomspace(1, cond)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    s = (q * np.geomspace(1.0, cond, m)) @ q.T
    return ((s + s.T) / 2).astype(np.float32)


def masked_s(m: int, seed: int = 1) -> np.ndarray:
    """tests/test_sinv.py's masked S: identity rows for unused slots, the
    shape the update gives the inverse."""
    rng = np.random.default_rng(seed)
    used = rng.random(m) < 0.6
    h = rng.normal(size=(m, 30)) * 3.0
    s = np.zeros((m, m), np.float32)
    s[np.ix_(used, used)] = (h @ h.T)[np.ix_(used, used)]
    s[np.diag_indices(m)] += 1.0
    return s


def sinv_limit(cond) -> float:
    """The TPU kernel tests' bounds (tests/test_sinv.py:44,63)."""
    return 1e-4 if cond == "masked" else 3e-5 * max(cond / 1e2, 1.0)


def check_sinv(failures, tag, S, limit) -> tuple[float, float, int]:
    """The S-inverse kernel on S against the float64 inverse; returns the
    relative and absolute errors and the info word (non-positive
    pivots, which must be 0)."""
    X, info = sinv.sinv_cuda(S)
    want = torch.linalg.inv(S.double())
    err = max_abs(X, want)
    rel = err / float(want.abs().max())
    info = int(info)
    check(failures, rel <= limit and info == 0,
          f"sinv[{tag}] rel err {rel:.3e} <= {limit:.1e}, info {info} == 0")
    return rel, err, info


def sinv_row(S: torch.Tensor, err: float) -> dict:
    """A kernel-table row for the S-inverse on S: its bound counts S in
    and S^-1 out, and the Mu^3 operations of an SPD inverse over the Mu
    rows that are not identity rows."""
    M = S.shape[0]
    eye = torch.eye(M, dtype=S.dtype, device=S.device)
    Mu = int(((S - eye).abs().sum(dim=1) > 0).sum())
    return dict(
        max_abs_err=err, M=M, used_rows=Mu, bytes=8 * M * M, flops=Mu ** 3,
        split=True,
        kernel=lambda: sinv.sinv_cuda(S),
        plain=lambda: sinv.cholesky_inverse(S),
        library=lambda: torch.linalg.inv(S))


# ---------------------------------------------------- the Cholesky solve

CHOL_SHAPES = ((1, 1), (48, 200), (64, 128), (192, 640), (336, 1024),
               (512, 640))
CHOL_CONDS = (1e2, 1e3, 1e4)
# the s3 update's S^-1 (H P) shape first (the kernel table's row), then
# the large map's
CHOL_TIMED = ((192, 640), (336, 1024))


def spd_plus(rng, m: int, scale: float = 10.0) -> np.ndarray:
    """tests/test_cholsolve.py's ``_spd``: A A^T + scale I."""
    A = rng.normal(size=(m, m)).astype(np.float32)
    return A @ A.T + scale * np.eye(m, dtype=np.float32)


def chol_rel_err(X: torch.Tensor, S: torch.Tensor, B: torch.Tensor) -> float:
    want = torch.linalg.solve(S.double(), B.double())
    return max_abs(X, want) / float(want.abs().max())


# ----------------------------------------------------------------- phase 3

def true_pose(t: float) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth camera at frame t: starts at rest at the origin and
    accelerates smoothly (well inside the filter's process noise)."""
    def ease(amp, period):
        return amp * (1.0 - math.cos(2.0 * math.pi * t / period))
    r = np.array([ease(0.25, 400), ease(0.03, 250), ease(0.10, 300)])
    yaw, pitch = ease(0.15, 350), ease(0.03, 270)
    q_yaw = np.array([math.cos(yaw / 2), 0.0, math.sin(yaw / 2), 0.0])
    q_pitch = np.array([math.cos(pitch / 2), math.sin(pitch / 2), 0.0, 0.0])
    q = quat.multiply(torch.tensor(q_yaw), torch.tensor(q_pitch)).numpy()
    return r, q


class Scene:
    """World points observed through the port's own camera model."""

    def __init__(self, camera, rng, n_points: int = 160):
        self.camera = camera
        self.points = np.stack([rng.uniform(-3.0, 4.5, n_points),
                                rng.uniform(-1.8, 1.8, n_points),
                                rng.uniform(2.5, 7.0, n_points)], axis=1)

    def observe(self, t: float, margin: float):
        """(uv (n, 2) distorted pixels, visible (n,)) at frame t."""
        r, q = true_pose(t)
        R = quat.to_rotation_matrix(torch.tensor(q))
        p_cam = (torch.tensor(self.points) - torch.tensor(r)) @ R
        front = cam_mod.in_front_and_in_fov(self.camera, p_cam)
        z = torch.clamp(p_cam[:, 2], min=1e-3)
        p_safe = torch.cat([p_cam[:, :2], z[:, None]], dim=1)
        uv = cam_mod.distort(self.camera, cam_mod.project(self.camera,
                                                          p_safe))
        cam = self.camera
        inside = ((uv[:, 0] > margin) & (uv[:, 0] < cam.pixels_x - margin)
                  & (uv[:, 1] > margin) & (uv[:, 1] < cam.pixels_y - margin))
        return uv.numpy(), (front & inside).numpy()


def _pick_spread(uv, candidates, taken_uv, k, rng, min_px=15.0):
    """Up to k candidate point ids, in random order, at least min_px from
    every taken pixel and from each other."""
    chosen = []
    pts = list(taken_uv)
    for p in rng.permutation(candidates):
        if len(chosen) >= k:
            break
        if all(np.hypot(*(uv[p] - o)) >= min_px for o in pts):
            chosen.append(int(p))
            pts.append(uv[p])
    return chosen


def record_log(runtime: SlamRuntime, scene: Scene, T: int, seed: int,
               keep_at: int | None = None):
    """Run the scene closed loop through step_injected and record the
    injection log (eval/replay.py format).  The generator reads the filter's
    slot mask and inlier count back after every frame (host syncs that only
    this recording pays), pins new points to free slots through
    ``new_slot``, and offers as many as the inlier count falls short of
    MinMatchesPerImage.  Frame ``keep_at``'s predicted state and
    measurement prediction are kept, as ``(state, pred)``, for the update
    kernel's check on the path's own data."""
    cfg = runtime.config
    F = C = cfg.max_features
    target = cfg.ekf.min_matches_per_image
    rng = np.random.default_rng(seed)
    slot_pt = np.full(F, -1)

    uv, vis = scene.observe(0, margin=20.0)
    first = _pick_spread(uv, np.nonzero(vis)[0], [], target, rng)
    init = [(uv[p].copy(), s) for s, p in enumerate(first)]
    slot_pt[:len(first)] = first
    state = runtime.make_initial_state()
    uv0, valid0, slots0 = replay._additions(init, C)
    desc = torch.zeros((C,) + tuple(state.descriptors.shape[1:]),
                       dtype=state.descriptors.dtype, device=runtime.device)
    state = feat_mod.add_features_at(
        state, runtime.camera, cfg, runtime._tensor(uv0, runtime.dtype), desc,
        runtime._tensor(slots0, torch.int32),
        runtime._tensor(valid0, torch.bool))

    kept = None
    frames, records = [], []
    last_inliers = len(first)
    for t in range(1, T + 1):
        if t == keep_at:
            predicted = pred_mod.predict(
                state._replace(frame=state.frame + 1), cfg)
            kept = (predicted, meas_mod.predict_measurements(
                predicted, runtime.camera, hp_layout=runtime.hp_layout))
        uv, vis = scene.observe(t, margin=5.0)
        z = np.zeros((F, 2))
        matched = np.zeros(F, bool)
        for s in np.nonzero(slot_pt >= 0)[0]:
            p = slot_pt[s]
            if vis[p] and rng.random() < 0.97:
                matched[s] = True
                z[s] = uv[p] + rng.normal(0.0, 1.0, 2)
                if rng.random() < 0.05:
                    a = rng.uniform(0, 2 * math.pi)
                    z[s] += 30.0 * np.array([math.cos(a), math.sin(a)])
        free = np.nonzero(slot_pt < 0)[0]
        want = min(len(free), max(0, target - last_inliers))
        tracked = set(slot_pt[slot_pt >= 0].tolist())
        _, vis_new = scene.observe(t, margin=20.0)
        cands = [p for p in np.nonzero(vis_new)[0] if p not in tracked]
        taken = [uv[p] for p in tracked if vis[p]]
        new_pts = _pick_spread(uv, cands, taken, want, rng)
        new = [(uv[p] + rng.normal(0.0, 0.5, 2), int(free[i]))
               for i, p in enumerate(new_pts)]
        nuv, nvalid, nslot = replay._additions(new, C)
        state, rec = runtime.step_injected(
            state, z, matched, new_uv=nuv, new_valid=nvalid,
            new_slot=nslot)
        ok = rec.new_ok.cpu().numpy()
        for i, p in enumerate(new_pts):
            if ok[i]:
                slot_pt[new[i][1]] = p
        slot_pt[~state.active.cpu().numpy()] = -1
        last_inliers = int(rec.li_inliers + rec.hi_inliers)
        frames.append({"z": z, "matched": matched, "new": new})
        records.append(rec)
    return {"init": init, "frames": frames}, state, records, kept


def phase_path(cfg: SlamConfig, failures: list) -> dict:
    print("== phase 3: path", flush=True)
    runtime = SlamRuntime(cfg)            # the card: cuda:0
    assert runtime.device.type == "cuda"
    F, N = cfg.max_features, cfg.padded_state_dim
    print(f"  SlamConfig(): F = {F}, N = {N} (state dim {cfg.state_dim}), "
          f"{cfg.dtype}, {cfg.camera.pixels_x}x{cfg.camera.pixels_y}",
          flush=True)
    scene = Scene(runtime.camera, np.random.default_rng(7))
    mid = T_FRAMES // 2
    t0 = time.perf_counter()
    log, rec_state, rec_records, kept = record_log(
        runtime, scene, T_FRAMES, seed=11, keep_at=mid)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    print(f"  recorded {T_FRAMES} frames closed loop in {record_s:.2f} s",
          flush=True)

    # the update kernel on this path's own inputs: frame T/2's predicted
    # state and measurements, with that frame's inliers and, harder, all
    # its matches (gross outliers included) as the used slots
    path_update = {}
    predicted, pred = kept
    rec = rec_records[mid - 1]
    for tag, use in (("path inliers", rec.inliers),
                     ("path matched", rec.matched)):
        path_update[tag] = check_update(
            failures, tag, predicted.P, predicted.x, pred.HP, pred.Sfull,
            pred.uv, rec.z, use, cfg.camera.pixel_error_x)

    # the main path: replay the log through the replay entry point with
    # every launch counter at 0 just before and read just after
    ulog = replay.upload_log(runtime, log)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, records = replay.run_uploaded(runtime, ulog)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    fps = T_FRAMES / elapsed
    print(f"  main path: {T_FRAMES} frames in {elapsed:.4f} s = "
          f"{fps:.2f} frames/s (bootstrap included)", flush=True)
    print(f"  launches: {launches}", flush=True)

    # the same replay once more under PyTorch's sync debug mode, counting
    # the host syncs by the line that caused them
    sync_sites, elapsed2 = count_syncs(
        lambda: replay.run_uploaded(runtime, ulog))
    syncs = sum(sync_sites.values())
    print(f"  second replay (sync debug mode): {T_FRAMES / elapsed2:.2f} "
          f"frames/s, {syncs} host syncs ({syncs / T_FRAMES:.3f} per "
          f"frame): {dict(sync_sites)}", flush=True)

    # and once more under torch.profiler, for the time of each phase, with
    # a range around each predict_measurements call for its device launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            chain_ranges(MEASURE_CHAIN):
        replay.run_uploaded(runtime, ulog)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    mc = chain_device(prof.events(), T_FRAMES, tuple(MEASURE_CHAIN))[
        "filter.predict_measurements"]
    measure_launches = mc["launches"] / mc["calls"]
    print(f"  predict_measurements: {measure_launches:.2f} device launches "
          f"a call ({mc['calls']:.2f} calls a frame, "
          f"{mc['device_us'] / mc['calls']:.2f} device us a call)",
          flush=True)
    phase_ms = phase_times(averages, T_FRAMES)
    dev_ms = device_ms(averages, T_FRAMES)
    update_us = kernel_device_us(averages, T_FRAMES, UPDATE_KERNEL_NAMES)
    print("  per-phase ms/frame under the profiler (host, device of "
          "PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    print_device(dev_ms, update_us)

    T = T_FRAMES
    check(failures, launches["predict"] == T, f"predict launches {T}")
    check(failures, launches["measure"] == 2 * T, f"measure launches {2 * T}")
    check(failures, launches["measure_quirks"] == 0,
          "no launch of the measure kernel's quirks variant")
    check(failures, launches["update"] == 2 * T, f"update launches {2 * T}")
    check(failures, launches["sinv"] == 0, "no S-inverse launch")
    check(failures, launches["init"] >= 1, "init launched at least once")
    check(failures, bool(torch.isfinite(state.x).all())
          and bool(torch.isfinite(state.P).all()), "final x and P finite")
    dm = dim_active_mask(state)
    diag = torch.diagonal(state.P)[dm]
    check(failures, bool((diag >= 0).all()),
          f"diag(P) >= 0 on the {int(dm.sum())} active dims")
    matched = np.array([int(r.total_matches) for r in records])
    inl = np.array([int(r.li_inliers + r.hi_inliers) for r in records])
    healthy = float(np.mean(inl >= 0.5 * matched))
    check(failures, healthy >= 0.9,
          f"tracking healthy on {healthy:.3f} of frames (>= 0.9): mean "
          f"matched {matched.mean():.1f}, mean inliers {inl.mean():.1f}")
    same = max(max_abs(a.x_cam, b.x_cam) for a, b in zip(records,
                                                         rec_records))
    print(f"  replay vs recording run: max |x_cam| difference {same:.3e}",
          flush=True)
    return dict(runtime=runtime, log=log, records=records, state=state,
                launches=launches, fps=fps, elapsed_s=elapsed,
                syncs=syncs, fps_second=T_FRAMES / elapsed2,
                phase_ms=phase_ms, device_ms=dev_ms,
                update_kernels_us=update_us, record_s=record_s,
                measure_launches_per_call=measure_launches,
                sync_sites=dict(sync_sites),
                healthy=healthy, mean_matched=float(matched.mean()),
                mean_inliers=float(inl.mean()),
                replay_vs_recording=same, path_update=path_update)


# ----------------------------------------------------------------- phase 4

def against_float64(card_x, card_inliers, card_visible, recs64) -> dict:
    """The card's trajectory and masks against a float64 CPU replay's
    records: camera-position deviation a frame, the share of frames whose
    inlier and visibility masks are identical."""
    ref = np.stack([r.x_cam.numpy() for r in recs64])
    dev = np.linalg.norm(np.asarray(card_x)[:, 0:3].astype(np.float64)
                         - ref[:, 0:3], axis=1)
    same_inl = float(np.mean([
        np.array_equal(np.asarray(a), b.inliers.numpy())
        for a, b in zip(card_inliers, recs64)]))
    same_vis = float(np.mean([
        np.array_equal(np.asarray(a), b.visible.numpy())
        for a, b in zip(card_visible, recs64)]))
    worst = int(np.argmax(dev))
    return dict(dev_max=float(dev.max()), dev_mean=float(dev.mean()),
                dev_final=float(dev[-1]), worst_frame=worst + 1,
                inliers_same=same_inl, visible_same=same_vis,
                dev_per_frame=dev.tolist())


def phase_replay(path: dict, failures: list) -> dict:
    print("== phase 4: float64 CPU replay", flush=True)
    cfg64 = SlamConfig(dtype="float64")
    rt64 = SlamRuntime(cfg64, device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, path["log"])
    cpu_s = time.perf_counter() - t0
    recs = path["records"]
    agree = against_float64(
        np.stack([r.x_cam.double().cpu().numpy() for r in recs]),
        [r.inliers.cpu().numpy() for r in recs],
        [r.visible.cpu().numpy() for r in recs], recs64)
    sigma = np.array([math.sqrt(max(float(torch.trace(r.P_cam[0:3, 0:3])),
                                    0.0)) for r in recs64])
    print(f"  CPU float64 replay {cpu_s:.1f} s; camera-position deviation "
          f"max {agree['dev_max']:.3e}, mean {agree['dev_mean']:.3e}, final "
          f"{agree['dev_final']:.3e}; f64 sigma_r final {sigma[-1]:.3e}",
          flush=True)
    print(f"  inlier masks identical on {agree['inliers_same']:.3f} of "
          f"frames, visibility on {agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= REPLAY_TOL,
          f"deviation <= {REPLAY_TOL} on every frame (worst frame "
          f"{agree['worst_frame']}: {agree['dev_max']:.3e})")
    check(failures, agree["inliers_same"] >= REPLAY_MASKS_SAME,
          f"inlier masks identical on >= {REPLAY_MASKS_SAME} of frames")
    check(failures, agree["visible_same"] >= REPLAY_MASKS_SAME,
          f"visibility masks identical on >= {REPLAY_MASKS_SAME} of frames")
    return dict(cpu_s=cpu_s, sigma_final=float(sigma[-1]),
                sigma_per_frame=sigma.tolist(), **agree)


def replay_margin(cfg: SlamConfig, seeds: list, T: int = T_FRAMES,
                  device=None) -> list:
    """Phase 4's float64 agreement on other scenes, to read how far it is
    from its bound: for each seed s, record the closed loop on the card
    (the scene made from s, the log from s + 4; s = 7 is phase 3's pair)
    and replay its log in float64 on the CPU.  Reports, for each seed, the
    deviation, the masks, the frames whose inlier mask differs and the
    deviation on the frame before the first of them; checks nothing."""
    runtime = SlamRuntime(cfg, device=device)
    rt64 = SlamRuntime(SlamConfig(dtype="float64"), device="cpu")
    out = []
    for s in seeds:
        scene = Scene(runtime.camera, np.random.default_rng(s))
        log, _, recs, _ = record_log(runtime, scene, T, seed=s + 4)
        _, recs64 = replay.replay_records(rt64, log)
        card_inl = [r.inliers.cpu().numpy() for r in recs]
        agree = against_float64(
            np.stack([r.x_cam.double().cpu().numpy() for r in recs]),
            card_inl, [r.visible.cpu().numpy() for r in recs], recs64)
        flips = [t + 1 for t, (a, b) in enumerate(zip(card_inl, recs64))
                 if not np.array_equal(a, b.inliers.numpy())]
        dev = agree.pop("dev_per_frame")
        before = dev[flips[0] - 2] if flips and flips[0] > 1 else None
        row = dict(seed=s, inlier_flip_frames=flips,
                   dev_before_first_flip=before, **agree)
        out.append(row)
        print(f"  seed {s}: deviation max {row['dev_max']:.3e} (frame "
              f"{row['worst_frame']}), mean {row['dev_mean']:.3e}; inlier "
              f"masks identical on {row['inliers_same']:.3f} of frames, "
              f"visibility on {row['visible_same']:.3f}; inlier flips at "
              f"frames {flips}, deviation before the first "
              f"{before if before is None else f'{before:.3e}'}",
              flush=True)
    return out


# ----------------------------------------------------------------- phase 5

def live_frames(T: int, hw=LIVE_HW, seed: int = 5) -> np.ndarray:
    """(T, H, W) uint8: a window sliding 2 px a frame over a blob texture
    (io/sources.py SlidingWindowSource), an image-space pan."""
    h, w = hw
    still = blob_texture(np.random.default_rng(seed), h, w + 2 * T)
    return np.stack(list(SlidingWindowSource(still, (h, w), step_xy=(2, 0),
                                             n_frames=T)))


def phase_live(cfg: SlamConfig, failures: list, T: int = T_LIVE) -> dict:
    print("== phase 5: live path", flush=True)
    runtime = SlamRuntime(cfg)            # the card: cuda:0
    frames = live_frames(T)
    S = T - 1
    print(f"  SlamConfig(detector=STAR): {cfg.detector.kind} max size "
          f"{cfg.detector.star_max_size}, response "
          f"{cfg.detector.star_response_threshold}, line "
          f"{cfg.detector.star_line_threshold}, NMS radius "
          f"{cfg.detector.nonmax_radius}; {cfg.descriptor.kind}-"
          f"{cfg.descriptor.n_bits} patch {cfg.descriptor.patch_size}; "
          f"F = {cfg.max_features}, {cfg.dtype}, {frames.shape[2]}x"
          f"{frames.shape[1]}, {T} frames", flush=True)

    # warm-up off the clock: first calls, allocations, add frames
    scan_runner.run_sequence_on_device(runtime, frames[:21])
    torch.cuda.synchronize()

    # the main path: every launch counter at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    state, recs = scan_runner.run_sequence_on_device(runtime, frames)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    # the same run again, for the host's run-to-run spread
    t0 = time.perf_counter()
    scan_runner.run_sequence_on_device(runtime, frames)
    torch.cuda.synchronize()
    elapsed_again = time.perf_counter() - t0
    fps = T / elapsed
    print(f"  main path: run_sequence_on_device over {T} frames in "
          f"{elapsed:.4f} s = {fps:.2f} frames/s (init_step, the upload "
          f"and the records' copy back included); again: "
          f"{T / elapsed_again:.2f} frames/s", flush=True)
    print(f"  launches: {launches}", flush=True)
    check(failures, launches["star"] == T and launches["brief"] == T,
          f"star and brief launched once a frame plus once for init_step "
          f"({T})")
    check(failures, launches["star_direct"] == 0
          and launches["brief_generic"] == 0,
          "no launch of STAR's direct route or BRIEF's generic variant")
    check(failures, launches["predict"] == S, f"predict launches {S}")
    check(failures, launches["measure"] == 2 * S, f"measure launches {2 * S}")
    check(failures, launches["measure_quirks"] == 0,
          "no launch of the measure kernel's quirks variant")
    check(failures, launches["update"] == 2 * S, f"update launches {2 * S}")
    check(failures, launches["sinv"] == 0,
          "no S-inverse launch on the s3 map (the fused update applies)")
    check(failures, 1 <= launches["init"] <= T,
          f"init launched on init_step and on add frames only "
          f"({launches['init']})")
    check(failures, bool(torch.isfinite(state.x).all())
          and bool(torch.isfinite(state.P).all()), "final x and P finite")
    matched = recs.total_matches.astype(np.int64)
    inl = (recs.li_inliers + recs.hi_inliers).astype(np.int64)
    healthy = float(np.mean(inl >= 0.5 * matched))
    check(failures, healthy >= 0.9 and matched.mean() >= 20,
          f"tracking healthy on {healthy:.3f} of frames (>= 0.9): mean "
          f"matched {matched.mean():.1f} (>= 20), mean inliers "
          f"{inl.mean():.1f}, mean active {recs.n_active.mean():.1f}, "
          f"{int(recs.new_ok.sum())} features added")

    # host syncs per frame, on frames already on the card
    gpu_frames = runtime._tensor(frames)
    st0 = runtime.init_step(runtime.make_initial_state(), gpu_frames[0])
    torch.cuda.synchronize()
    sites, sync_s = count_syncs(
        lambda: scan_runner.scan_frames(runtime, st0, gpu_frames[1:]))
    syncs = sum(sites.values())
    print(f"  sync debug run: {S / sync_s:.2f} steps/s, {syncs} host syncs "
          f"({syncs / S:.3f} per frame): {dict(sites)}", flush=True)
    check(failures, syncs / S <= LIVE_SYNCS_PER_FRAME,
          f"host syncs per frame {syncs / S:.3f} <= {LIVE_SYNCS_PER_FRAME}")

    # per-phase host and device ms under the profiler, with a range around
    # each of the PyTorch chains beside the STAR and BRIEF kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, chain_ranges():
        scan_runner.scan_frames(runtime, st0, gpu_frames[1:])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    phase_ms = phase_times(averages, S, LIVE_PHASE_PREFIX)
    print("  per-phase ms/frame under the profiler (host, device of "
          "PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    vision_us = kernel_device_us(averages, S,
                                 LIVE_KERNEL_NAMES + UPDATE_KERNEL_NAMES)
    dev_ms = device_ms(averages, S)
    print_device(dev_ms, vision_us)
    chains = chain_device(prof.events(), S)
    print("  PyTorch chains beside the front-end kernels, a frame: "
          + "; ".join(f"{k} {v['device_us']:.2f} device us in "
                      f"{v['launches']:.2f} device launches "
                      f"({v['calls']:.2f} calls, host {v['host_us']:.1f} us)"
                      for k, v in chains.items()), flush=True)

    # STAR and BRIEF on frame T/2's own image
    mid = check_star_brief(failures, f"frame {T // 2}", gpu_frames[T // 2],
                           runtime.frontend)

    # the live injection log, replayed on the CPU in float64
    log = replay.record_live_log(runtime, gpu_frames)
    card = log["records"]
    rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                       device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, log)
    cpu_s = time.perf_counter() - t0
    agree = against_float64(card.x_cam, card.inliers, card.visible, recs64)
    same_rec = float(np.abs(card.x_cam - recs.x_cam).max())
    print(f"  live log: {len(log['init'])} bootstrap features, "
          f"{sum(len(f['new']) for f in log['frames'])} additions; its "
          f"run vs the main run: max |x_cam| difference {same_rec:.3e}",
          flush=True)
    print(f"  float64 CPU replay of the live log {cpu_s:.1f} s: "
          f"camera-position deviation max {agree['dev_max']:.3e} (frame "
          f"{agree['worst_frame']}), mean {agree['dev_mean']:.3e}, final "
          f"{agree['dev_final']:.3e}; inlier masks identical on "
          f"{agree['inliers_same']:.3f} of frames, visibility on "
          f"{agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL,
          f"live replay deviation <= {LIVE_REPLAY_TOL} on every frame "
          f"(worst {agree['dev_max']:.3e})")
    check(failures, agree["inliers_same"] >= LIVE_MASKS_SAME
          and agree["visible_same"] >= LIVE_MASKS_SAME,
          f"live replay masks identical on >= {LIVE_MASKS_SAME} of frames")
    return dict(launches=launches, fps=fps, elapsed_s=elapsed,
                fps_again=T / elapsed_again,
                syncs=syncs, syncs_per_frame=syncs / S,
                sync_sites=dict(sites), fps_sync_debug=S / sync_s,
                phase_ms=phase_ms, vision_kernels_us=vision_us,
                frontend_chains=chains, device_ms=dev_ms,
                healthy=healthy,
                mean_matched=float(matched.mean()),
                mean_inliers=float(inl.mean()),
                added=int(recs.new_ok.sum()),
                mid_frame=dict(star_err=mid["star_err"],
                               brief_bits=mid["brief_bits"],
                               peaks=mid["peaks"]),
                replay=dict(cpu_s=cpu_s, log_run_vs_main=same_rec, **agree))


# ----------------------------------------------------------------- phase 6

LARGE_MAP_CONFIG = """%YAML:1.0
RunConfiguration:
  ExtendedKalmanFilter: "S3"
  FeatureDetector: "STAR"
  DescriptorExtractor: "BRIEF"
ExtendedKalmanFilter:
  S3:
    MinMatchesPerImage: "60"
    MaxMapSize: "960"
FeatureDetector:
  STAR:
    Type: "STAR"
    MaxSize: "16"
    ResponseThreshold: "30"
    LineThresholdProjected: "10"
    SuppressNonmaxSize: "5"
DescriptorExtractor:
  BRIEF:
    Type: "BRIEF"
    BytesLength: "32"
"""


def source_line(module, needle: str) -> str:
    """"file:line" of the first line of ``module`` that holds ``needle``
    (the form in which count_syncs names a sync's site)."""
    path = Path(module.__file__)
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if needle in line:
            return f"{path.name}:{i}"
    raise PhaseError(f"{needle!r} not found in {path.name}")


def record_values(records) -> np.ndarray:
    """(T, 182) state and covariance corner of the engine's records."""
    return np.array([r["position"] + r["orientation"] + r["linear_velocity"]
                     + r["angular_velocity"]
                     + sum(r["covariance_cam"], []) for r in records])


def phase_large_map(failures: list, T: int = T_LIVE) -> dict:
    print("== phase 6: the engine on the large map", flush=True)
    OUT.mkdir(exist_ok=True)
    path = OUT / "large_map_config.yml"
    path.write_text(LARGE_MAP_CONFIG)
    frames = live_frames(T)
    S = T - 1
    engine = SlamEngine(str(path), output_path=str(OUT / "large_map"))
    cfg = engine.config
    F, N = cfg.max_features, cfg.padded_state_dim
    print(f"  SlamEngine(config.yml, MaxMapSize {cfg.ekf.max_map_size}): "
          f"F = {F}, N = {N} (state dim {cfg.state_dim}), 2F = {2 * F}; "
          f"{cfg.detector.kind} max size {cfg.detector.star_max_size}, "
          f"response {cfg.detector.star_response_threshold}, line "
          f"{cfg.detector.star_line_threshold}, NMS radius "
          f"{cfg.detector.nonmax_radius}; {cfg.descriptor.kind}-"
          f"{cfg.descriptor.n_bits}; MinMatchesPerImage "
          f"{cfg.ekf.min_matches_per_image}; {cfg.dtype}, on "
          f"{engine.device}", flush=True)
    check(failures, (F, N) == (LARGE_F, LARGE_N),
          f"F = {F}, N = {N} (want {LARGE_F}, {LARGE_N})")
    if (F, N) != (LARGE_F, LARGE_N):
        return {}

    # warm-up off the clock: first calls, allocations, add frames
    run_sequence(SlamEngine(str(path)), frames[:21])
    torch.cuda.synchronize()

    # the main path: every launch counter at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    records = run_sequence(engine, frames)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    engine.close()
    fps = T / elapsed
    print(f"  main path: run_sequence over {T} frames in {elapsed:.4f} s = "
          f"{fps:.2f} frames/s (init, the uploads and the per-frame "
          f"summaries included)", flush=True)
    print(f"  launches: {launches}", flush=True)
    check(failures, launches["sinv"] == 2 * S,
          f"S-inverse launches {launches['sinv']} == {2 * S} (2 a step)")
    check(failures, launches["update"] == 0,
          f"fused update launches {launches['update']} == 0")
    check(failures, launches["predict"] == S, f"predict launches {S}")
    check(failures, launches["measure"] == 2 * S, f"measure launches {2 * S}")
    check(failures, launches["measure_quirks"] == 0,
          "no launch of the measure kernel's quirks variant")
    check(failures, launches["star"] == T and launches["brief"] == T,
          f"star and brief launched once a frame plus once for init ({T})")
    check(failures, 1 <= launches["init"] <= T,
          f"init launched on init and on add frames only "
          f"({launches['init']})")
    check(failures, bool(torch.isfinite(engine.state.x).all())
          and bool(torch.isfinite(engine.state.P).all()),
          "final x and P finite")
    matched = np.array([r["total_matches"] for r in records])
    inl = np.array([r["li_inliers"] + r["hi_inliers"] for r in records])
    active = np.array([r["n_active"] for r in records])
    healthy = float(np.mean(inl >= 0.5 * matched))
    check(failures, healthy >= 0.9 and matched.mean() >= 20,
          f"tracking healthy on {healthy:.3f} of frames (>= 0.9): mean "
          f"matched {matched.mean():.1f} (>= 20), mean inliers "
          f"{inl.mean():.1f}, mean active {active.mean():.1f}, max active "
          f"{active.max()}")

    # host syncs a frame, by site: only the two named lines may sync
    allowed = {source_line(engine_mod, "packed.cpu()"),
               source_line(step_mod, ".tolist()")}
    eng_sync = SlamEngine(str(path))
    eng_sync.init(frames[0])
    torch.cuda.synchronize()
    sites, sync_s = count_syncs(
        lambda: [eng_sync.step(f) for f in frames[1:]])
    syncs = sum(sites.values())
    print(f"  sync debug run: {S / sync_s:.2f} steps/s, {syncs} host syncs "
          f"({syncs / S:.3f} per frame): {dict(sites)}", flush=True)
    check(failures, syncs / S <= LARGE_SYNCS_PER_FRAME
          and set(sites) <= allowed,
          f"host syncs per frame {syncs / S:.3f} <= "
          f"{LARGE_SYNCS_PER_FRAME}, only at {sorted(allowed)}")

    # per-phase host and device ms under the profiler over the first
    # LARGE_CKPT_AT steps; the same engine then saves the checkpoint that
    # a fresh engine resumes, and runs on to the end
    ckpt = OUT / "large_map_checkpoint.npz"
    eng_prof = SlamEngine(str(path))
    eng_prof.init(frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in frames[1:LARGE_CKPT_AT + 1]:
            eng_prof.step(f)
        torch.cuda.synchronize()
    eng_prof.save_checkpoint(str(ckpt))
    for f in frames[LARGE_CKPT_AT + 1:]:
        eng_prof.step(f)
    averages = prof.key_averages()
    phase_ms = phase_times(averages, LARGE_CKPT_AT, LIVE_PHASE_PREFIX)
    print(f"  per-phase ms/frame under the profiler over {LARGE_CKPT_AT} "
          "steps (host, device of PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    kernel_us = kernel_device_us(averages, LARGE_CKPT_AT,
                                 LIVE_KERNEL_NAMES + SINV_KERNEL_NAMES)
    dev_ms = device_ms(averages, LARGE_CKPT_AT)
    print_device(dev_ms, {})
    print("  hand-written device kernels under the profiler (us a frame, "
          "calls a frame): "
          + ", ".join(f"{k} {v['us_per_frame']:.2f} {v['calls_per_frame']:.2f}"
                      for k, v in kernel_us.items()), flush=True)
    same_run = float(np.abs(record_values(eng_prof.records)
                            - record_values(records[:S])).max())
    print(f"  profiled run vs the main run: max |difference| {same_run:.3e}",
          flush=True)

    # a fresh engine resumes the frame-100 checkpoint and runs to the end
    resumed = SlamEngine(str(path))
    resumed.resume(str(ckpt))
    for f in frames[LARGE_CKPT_AT + 1:]:
        resumed.step(f)
    want = eng_prof.records[LARGE_CKPT_AT:]
    strip = [{k: v for k, v in r.items() if k != "wall_time_s"}
             for r in resumed.records]
    identical = strip == [{k: v for k, v in r.items() if k != "wall_time_s"}
                          for r in want]
    resume_diff = float(np.abs(record_values(resumed.records)
                               - record_values(want)).max())
    print(f"  resumed at frame {LARGE_CKPT_AT}: {len(resumed.records)} "
          f"records, identical to the uninterrupted run: {identical} "
          f"(max |difference| {resume_diff:.3e})", flush=True)
    check(failures, identical and len(strip) == S - LARGE_CKPT_AT,
          "the resumed run's records equal the uninterrupted run's bit for "
          "bit")

    # the live log of this configuration, replayed on the CPU in float64
    gpu_frames = engine.runtime._tensor(frames)
    log = replay.record_live_log(engine.runtime, gpu_frames)
    card = log["records"]
    log_vs_main = float(np.abs(card.x_cam[:, 0:3].astype(np.float64)
                               - record_values(records)[:, 0:3]).max())
    rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                       device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, log)
    cpu_s = time.perf_counter() - t0
    agree = against_float64(card.x_cam, card.inliers, card.visible, recs64)
    print(f"  live log: {len(log['init'])} bootstrap features, "
          f"{sum(len(f['new']) for f in log['frames'])} additions; its run "
          f"vs the engine's: max |position| difference {log_vs_main:.3e}",
          flush=True)
    print(f"  float64 CPU replay {cpu_s:.1f} s: camera-position deviation "
          f"max {agree['dev_max']:.3e} (frame {agree['worst_frame']}), mean "
          f"{agree['dev_mean']:.3e}, final {agree['dev_final']:.3e}; inlier "
          f"masks identical on {agree['inliers_same']:.3f} of frames, "
          f"visibility on {agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL,
          f"large-map replay deviation <= {LIVE_REPLAY_TOL} on every frame "
          f"(worst {agree['dev_max']:.3e})")
    check(failures, agree["inliers_same"] >= LIVE_MASKS_SAME
          and agree["visible_same"] >= LIVE_MASKS_SAME,
          f"large-map replay masks identical on >= {LIVE_MASKS_SAME} of "
          "frames")

    # the S-inverse on the path's own S: frame 101's prediction from the
    # checkpointed state, with that frame's inliers as the used slots
    state = ckpt_mod.load_checkpoint(str(ckpt), like=resumed.state)
    _, pred = engine.runtime.phase_predict(state)
    use = torch.tensor(card.inliers[LARGE_CKPT_AT], device=state.x.device)
    pe = cfg.camera.pixel_error_x
    S_path = _masked_S(pred.Sfull, use, pe).contiguous()
    eig = torch.linalg.eigvalsh(S_path.double())
    cond = float(eig.max() / eig.min())
    rel, err, info = check_sinv(failures, f"frame {LARGE_CKPT_AT + 1}",
                                 S_path, sinv_limit(cond))
    row = sinv_row(S_path, err)
    row.update(rel_err=rel, cond=cond, info=info)
    return dict(launches=launches, fps=fps, elapsed_s=elapsed,
                F=F, N=N, syncs=syncs, syncs_per_frame=syncs / S,
                sync_sites=dict(sites), fps_sync_debug=S / sync_s,
                phase_ms=phase_ms, kernels_us=kernel_us, device_ms=dev_ms,
                healthy=healthy,
                mean_matched=float(matched.mean()),
                mean_inliers=float(inl.mean()),
                mean_active=float(active.mean()),
                max_active=int(active.max()),
                profiled_vs_main=same_run,
                resume=dict(identical=identical, max_diff=resume_diff),
                replay=dict(cpu_s=cpu_s, log_run_vs_main=log_vs_main,
                            **agree),
                sinv_row=row)


# ----------------------------------------------------------------- phase 7

def oracle_prefix(cfg64: SlamConfig, log: dict) -> tuple:
    """The log through the port's bug-compatible oracle (OracleQuirks()),
    frame by frame, stopping after ORACLE_BUDGET_S once ORACLE_MIN_FRAMES
    are done; returns (oracle, frames replayed, seconds)."""
    orc = oracle.ReferenceOracle(cfg64, oracle.OracleQuirks())
    orc.init_with_features(log["init"])
    t0 = time.perf_counter()
    for k, fr in enumerate(log["frames"]):
        orc.step_injected(fr["z"], fr["matched"], fr.get("new", ()))
        if (time.perf_counter() - t0 > ORACLE_BUDGET_S
                and k + 1 >= ORACLE_MIN_FRAMES):
            break
    return orc, len(orc.trajectory), time.perf_counter() - t0


def check_parity_launches(failures, launches: dict, steps: int,
                          frames: int | None = None) -> None:
    """The parity mode's kernels: the quirks variant of measure twice a
    step, the S-inverse twice a step (every update takes the chain), no
    fused update and no correct-math measure; with ``frames``, the live
    path's STAR and BRIEF once a frame."""
    S = steps
    check(failures, launches["measure_quirks"] == 2 * S,
          f"measure quirks-variant launches {launches['measure_quirks']} == "
          f"{2 * S}")
    check(failures, launches["measure"] == 0,
          f"correct-math measure launches {launches['measure']} == 0")
    check(failures, launches["sinv"] == 2 * S,
          f"S-inverse launches {launches['sinv']} == {2 * S}")
    check(failures, launches["update"] == 0,
          f"fused update launches {launches['update']} == 0")
    check(failures, launches["predict"] == S, f"predict launches {S}")
    check(failures, launches["init"] >= 1,
          f"init launched on add frames ({launches['init']})")
    if frames is not None:
        check(failures, launches["star"] == frames
              and launches["brief"] == frames,
              f"star and brief launched once a frame plus once for init "
              f"({frames})")


def visit_scan_cost(F: int, p: float, dev, reps: int = 50) -> dict:
    """The parity RANSAC's visit scan alone at F slots: its device kernels'
    time a call (under the profiler) and its host time a call (wall clock
    over ``reps`` eager calls, ending in a synchronize)."""
    rng = np.random.default_rng(3)
    sup = torch.tensor(rng.integers(0, 60, F), dtype=torch.int32, device=dev)
    mt = torch.tensor(rng.random(F) < 0.7, device=dev)

    def scan():
        return ransac_mod._adaptive_visit_scan(sup, mt, p, 1000)

    for _ in range(5):
        scan()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        scan()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            scan()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(host_us=host_us,
                device_us=sum(e.device_time_total for e in kernels) / reps,
                kernels=sum(e.count for e in kernels) / reps)


def phase_parity(cfg: SlamConfig, path: dict, failures: list) -> dict:
    """The parity mode on the card: phase 3's log replayed with the
    reference's quirks and adaptive visit, then SlamEngine in parity mode
    on the live frames."""
    print("== phase 7: the parity mode", flush=True)
    qcfg = dataclasses.replace(cfg, max_hypotheses=1000, **PARITY)
    runtime = SlamRuntime(qcfg)
    log = path["log"]
    T = len(log["frames"])
    F = qcfg.max_features
    print(f"  SlamConfig(reference_quirks, ransac_parity_visit, "
          f"max_hypotheses 1000): F = {F}, N = {qcfg.padded_state_dim}, "
          f"{qcfg.dtype}; phase 3's log, {T} frames", flush=True)
    ulog = replay.upload_log(runtime, log)
    torch.cuda.synchronize()

    # the replay path, counts at 0 just before and read just after
    reset_launches()
    t0 = time.perf_counter()
    state, records = replay.run_uploaded(runtime, ulog)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    fps = T / elapsed
    print(f"  replay: {T} frames in {elapsed:.4f} s = {fps:.2f} frames/s "
          f"(bootstrap included)", flush=True)
    print(f"  launches: {launches}", flush=True)
    check_parity_launches(failures, launches, T)
    check(failures, bool(torch.isfinite(state.x).all())
          and bool(torch.isfinite(state.P).all()), "final x and P finite")
    sites, sync_s = count_syncs(lambda: replay.run_uploaded(runtime, ulog))
    syncs = sum(sites.values())
    print(f"  sync debug run: {T / sync_s:.2f} frames/s, {syncs} host syncs: "
          f"{dict(sites)}", flush=True)
    check(failures, syncs == 0, f"0 host syncs a frame ({syncs} in {T})")
    # the first PARITY_PROFILED frames under the profiler
    K = min(PARITY_PROFILED, T)
    head = ulog._replace(z=ulog.z[:K], matched=ulog.matched[:K],
                         new_uv=ulog.new_uv[:K], new_valid=ulog.new_valid[:K],
                         new_slot=ulog.new_slot[:K])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay.run_uploaded(runtime, head)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    phase_ms = phase_times(averages, K)
    kernel_us = kernel_device_us(averages, K, SINV_KERNEL_NAMES + (
                                               "measure_kernel<true>",))
    dev_ms = device_ms(averages, K)
    print_device(dev_ms, {})
    print(f"  per-phase ms/frame under the profiler over {K} frames (host, "
          "device of PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    print("  hand-written kernels under the profiler (us a frame, calls a "
          "frame): " + ", ".join(
              f"{k} {v['us_per_frame']:.2f} {v['calls_per_frame']:.2f}"
              for k, v in kernel_us.items()), flush=True)
    scan = visit_scan_cost(F, qcfg.ekf.ransac_all_inliers_probability,
                           state.x.device)
    print(f"  the visit scan alone at F = {F}: {scan['device_us']:.2f} us "
          f"of device kernels ({scan['kernels']:.0f} launches) and "
          f"{scan['host_us']:.2f} us of host time a call", flush=True)

    # the same log on the CPU in float64 through the port's quirks path,
    # and through the bug-compatible oracle
    q64 = dataclasses.replace(qcfg, dtype="float64")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(SlamRuntime(q64, device="cpu"), log)
    cpu_s = time.perf_counter() - t0
    agree = against_float64(
        np.stack([r.x_cam.double().cpu().numpy() for r in records]),
        [r.inliers.cpu().numpy() for r in records],
        [r.visible.cpu().numpy() for r in records], recs64)
    print(f"  float64 CPU replay (quirks path) {cpu_s:.1f} s: camera-"
          f"position deviation max {agree['dev_max']:.3e} (frame "
          f"{agree['worst_frame']}), mean {agree['dev_mean']:.3e}; inlier "
          f"masks identical on {agree['inliers_same']:.3f} of frames, "
          f"visibility on {agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= REPLAY_TOL,
          f"deviation <= {REPLAY_TOL} on every frame")
    check(failures, agree["inliers_same"] >= REPLAY_MASKS_SAME
          and agree["visible_same"] >= REPLAY_MASKS_SAME,
          f"masks identical on >= {REPLAY_MASKS_SAME} of frames")
    orc, n_orc, orc_s = oracle_prefix(q64, log)
    ref = np.stack(orc.trajectory)
    cpu = np.stack([r.x_cam.numpy() for r in recs64[:n_orc]])
    path_len = float(np.sum(np.linalg.norm(np.diff(ref[:, 0:3], axis=0),
                                           axis=1)))
    ate = ate_rmse(cpu[:, 0:3], ref[:, 0:3], align=False)
    bound = 1e-5 * max(path_len, 1e-3) + 1e-7
    print(f"  oracle (OracleQuirks()): {n_orc} of {T} frames in {orc_s:.1f} "
          f"s, slot_collisions {orc.slot_collisions}; float64 quirks "
          f"replay vs oracle ATE {ate:.3e} over path {path_len:.4f} m "
          f"(bound {bound:.3e})", flush=True)
    check(failures, ate < bound, f"ATE vs the oracle {ate:.3e} < {bound:.3e}")
    replay_part = dict(
        fps=fps, elapsed_s=elapsed, launches=launches, syncs=syncs,
        sync_sites=dict(sites), fps_sync_debug=T / sync_s,
        profiled_frames=K, phase_ms=phase_ms, kernels_us=kernel_us,
        device_ms=dev_ms,
        visit_scan=scan, cpu_s=cpu_s,
        float64=agree,
        oracle=dict(frames=n_orc, seconds=orc_s, ate=ate, path=path_len,
                    bound=bound, slot_collisions=orc.slot_collisions))
    return dict(replay=replay_part,
                engine=parity_engine(failures))


def parity_engine(failures: list, T: int = T_PARITY_LIVE) -> dict:
    """SlamEngine from the s3 config file (no MaxMapSize: F = 96) with the
    parity flags, over the live frames."""
    OUT.mkdir(exist_ok=True)
    path = OUT / "parity_config.yml"
    path.write_text(LARGE_MAP_CONFIG.replace('    MaxMapSize: "960"\n', ""))
    frames = live_frames(T)
    S = T - 1
    engine = SlamEngine(str(path), **PARITY)
    cfg = engine.config
    print(f"  SlamEngine(config.yml, reference_quirks, ransac_parity_visit):"
          f" F = {cfg.max_features}, N = {cfg.padded_state_dim}, "
          f"max_hypotheses {cfg.max_hypotheses}, {cfg.dtype}; {T} frames",
          flush=True)
    check(failures, cfg.max_features == 96, "F = 96 (the s3 map)")
    run_sequence(SlamEngine(str(path), **PARITY), frames[:11])   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    records = run_sequence(engine, frames)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    engine.close()
    fps = T / elapsed
    print(f"  engine: run_sequence over {T} frames in {elapsed:.4f} s = "
          f"{fps:.2f} frames/s", flush=True)
    print(f"  launches: {launches}", flush=True)
    check_parity_launches(failures, launches, S, frames=T)
    matched = np.array([r["total_matches"] for r in records])
    inl = np.array([r["li_inliers"] + r["hi_inliers"] for r in records])
    healthy = float(np.mean(inl >= 0.5 * matched))
    check(failures, healthy >= 0.9 and matched.mean() >= 20,
          f"tracking healthy on {healthy:.3f} of frames (>= 0.9): mean "
          f"matched {matched.mean():.1f} (>= 20), mean inliers "
          f"{inl.mean():.1f}")

    allowed = {source_line(engine_mod, "packed.cpu()"),
               source_line(step_mod, ".tolist()")}
    eng = SlamEngine(str(path), **PARITY)
    eng.init(frames[0])
    torch.cuda.synchronize()
    sites, sync_s = count_syncs(lambda: [eng.step(f) for f in frames[1:]])
    syncs = sum(sites.values())
    print(f"  sync debug run: {S / sync_s:.2f} steps/s, {syncs} host syncs "
          f"({syncs / S:.3f} per frame): {dict(sites)}", flush=True)
    check(failures, syncs / S <= LARGE_SYNCS_PER_FRAME
          and set(sites) <= allowed,
          f"host syncs per frame {syncs / S:.3f} <= "
          f"{LARGE_SYNCS_PER_FRAME}, only at {sorted(allowed)}")

    eng = SlamEngine(str(path), **PARITY)
    eng.init(frames[0])
    torch.cuda.synchronize()
    K = min(PARITY_PROFILED, S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in frames[1:K + 1]:
            eng.step(f)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    phase_ms = phase_times(averages, K, LIVE_PHASE_PREFIX)
    kernel_us = kernel_device_us(averages, K, LIVE_KERNEL_NAMES + (
        *SINV_KERNEL_NAMES, "measure_kernel<true>"))
    dev_ms = device_ms(averages, K)
    print_device(dev_ms, {})
    print(f"  per-phase ms/frame under the profiler over {K} steps (host, "
          "device of PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    print("  hand-written kernels under the profiler (us a frame, calls a "
          "frame): " + ", ".join(
              f"{k} {v['us_per_frame']:.2f} {v['calls_per_frame']:.2f}"
              for k, v in kernel_us.items()), flush=True)

    # the live log of this run, replayed on the CPU in float64 (quirks)
    log = replay.record_live_log(engine.runtime,
                                 engine.runtime._tensor(frames))
    card = log["records"]
    rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                       device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, log)
    cpu_s = time.perf_counter() - t0
    agree = against_float64(card.x_cam, card.inliers, card.visible, recs64)
    print(f"  live log: {len(log['init'])} bootstrap features, "
          f"{sum(len(f['new']) for f in log['frames'])} additions; float64 "
          f"CPU replay {cpu_s:.1f} s: deviation max {agree['dev_max']:.3e} "
          f"(frame {agree['worst_frame']}), mean {agree['dev_mean']:.3e}; "
          f"inlier masks identical on {agree['inliers_same']:.3f} of "
          f"frames, visibility on {agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL,
          f"live replay deviation <= {LIVE_REPLAY_TOL} on every frame")
    check(failures, agree["inliers_same"] >= LIVE_MASKS_SAME
          and agree["visible_same"] >= LIVE_MASKS_SAME,
          f"live replay masks identical on >= {LIVE_MASKS_SAME} of frames")
    return dict(fps=fps, elapsed_s=elapsed, launches=launches, syncs=syncs,
                syncs_per_frame=syncs / S, sync_sites=dict(sites),
                fps_sync_debug=S / sync_s, profiled_steps=K,
                phase_ms=phase_ms, kernels_us=kernel_us, device_ms=dev_ms,
                healthy=healthy,
                mean_matched=float(matched.mean()),
                mean_inliers=float(inl.mean()), cpu_s=cpu_s, float64=agree)


# ------------------------------------------------------------------- main

def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the GPU", file=sys.stderr)
        return 1
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    smi = smi_line()
    print(smi, flush=True)
    report = {"card": smi, "device": torch.cuda.get_device_name(0)}
    report["build"] = phase_build()

    cfg = SlamConfig()
    # the s3 profile: SlamConfig() alone is the FAST profile
    live_cfg = SlamConfig(detector=DetectorConfig(kind="STAR"))
    camera = cam_mod.Camera.from_calibration(cfg.camera)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--replay-seeds" in argv:
        # phase 4's margin on other scenes alone, no result line
        seeds = [int(v) for v in
                 argv[argv.index("--replay-seeds") + 1].split(",")]
        print(f"== float64 agreement of the replay path at seeds {seeds}",
              flush=True)
        margin = replay_margin(cfg, seeds)
        OUT.mkdir(exist_ok=True)
        (OUT / "replay_margin.json").write_text(json.dumps(margin, indent=1))
        print(f"replay seeds: {time.perf_counter() - T_START:.1f} s",
              flush=True)
        return 0
    rows = phase_kernels(cfg, camera, SlamRuntime(live_cfg).frontend)
    if "--kernels-only" in argv:
        # phases 1-2 alone: the kernels' checks and times, no result line
        print(f"kernels only: {time.perf_counter() - T_START:.1f} s",
              flush=True)
        return 0

    failures: list = []
    path = phase_path(cfg, failures)
    end_phase("path", failures)
    failures = []
    rep = phase_replay(path, failures)
    end_phase("replay", failures)
    failures = []
    live = phase_live(live_cfg, failures)
    end_phase("live", failures)
    failures = []
    large = phase_large_map(failures)
    end_phase("large map", failures)
    rows["sinv"] = large.pop("sinv_row")
    print("  the S-inverse on the path's own S (M = "
          f"{rows['sinv']['M']}, {rows['sinv']['used_rows']} used rows, cond "
          f"{rows['sinv']['cond']:.3e}):", flush=True)
    time_row("sinv", rows["sinv"])

    failures = []
    parity = phase_parity(cfg, path, failures)
    end_phase("parity", failures)

    T = T_FRAMES
    # each kernel's launches come from the path that runs it: the s3 live
    # path, the large map for the S-inverse, the parity engine for the
    # measure kernel's quirks variant; the Cholesky solve has none
    paths = {"sinv": ("large map (phase 6)", large["launches"], T_LIVE),
             "measure_quirks": ("parity engine (phase 7)",
                                parity["engine"]["launches"],
                                T_PARITY_LIVE),
             "cholsolve": ("none: no engine path calls solve_spd", None, 1),
             "star_direct": ("none on the shipped settings: max size 45 "
                             "and above", live["launches"], T_LIVE),
             "brief_generic": ("none on the shipped pattern: any other "
                               "BRIEF pattern", live["launches"], T_LIVE)}
    kernels = []
    for name, spec in KERNELS.items():
        row = rows[name]
        on, counts, frames = paths.get(name, ("s3 live path (phase 5)",
                                              live["launches"], T_LIVE))
        launches = counts[name] if counts is not None else 0
        kernels.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "eager_ms": row["eager_ms"], "path": on,
            "launches_per_frame": launches / frames,
            "launches_replay_path": path["launches"][name],
            "launches_s3_live_path": live["launches"][name],
            "launches_large_map": large["launches"][name],
            "launches_parity_replay": parity["replay"]["launches"][name],
            "launches_parity_engine": parity["engine"]["launches"][name]})
    extra = ("sinv_spd336", "update_fused_n1024", "update_chain_n1024",
             "cholsolve_336x1024", "brief_generic_256", "predict_n1024",
             "floor")
    report.update(kernels=kernels, update_checks=rows["update"]["checks"],
                  path_update_checks=path["path_update"],
                  path={k: path[k] for k in (
                      "fps", "fps_second", "elapsed_s", "syncs", "sync_sites",
                      "phase_ms", "measure_launches_per_call",
                      "record_s",
                      "healthy", "mean_matched", "mean_inliers",
                      "replay_vs_recording", "launches")},
                  frames=T, syncs_per_frame=path["syncs"] / T, replay=rep,
                  live={k: v for k, v in live.items()},
                  large_map=large, sinv_path_row=rows["sinv"],
                  other_rows={k: rows[k] for k in extra},
                  cholsolve_checks=rows["cholsolve"]["checks"],
                  parity=parity, seconds=time.perf_counter() - T_START)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"replay path: frames/s {path['fps']:.2f} over {T} frames, host "
          f"syncs/frame {path['syncs'] / T:.3f}", flush=True)
    print(f"live path: frames/s {live['fps']:.2f} over {T_LIVE} frames, "
          f"host syncs/frame {live['syncs_per_frame']:.3f}", flush=True)
    print(f"large map (F = {large['F']}, N = {large['N']}): frames/s "
          f"{large['fps']:.2f} over {T_LIVE} frames, host syncs/frame "
          f"{large['syncs_per_frame']:.3f}", flush=True)
    pr, pe = parity["replay"], parity["engine"]
    print(f"parity replay: frames/s {pr['fps']:.2f} over {T} frames, host "
          f"syncs {pr['syncs']}; parity engine: frames/s {pe['fps']:.2f} "
          f"over {T_PARITY_LIVE} frames, host syncs/frame "
          f"{pe['syncs_per_frame']:.3f}; {time.perf_counter() - T_START:.1f}"
          " s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
