#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # device and the CUDA toolkit (nvcc)
    python3 chip_smoke.py --kernels-only    # phases 1 and 2 alone
    python3 chip_smoke.py --profiles-only   # phases 1 and 8 alone
    python3 chip_smoke.py --engine-features-only   # phases 1 and 9-11
    python3 chip_smoke.py --batch-only      # phases 1 and 12 alone
    python3 chip_smoke.py --viz-only        # phases 1 and 13 alone
    python3 chip_smoke.py --shard-only      # phases 1 and 14 alone
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
              update, the S-inverse and the Cholesky solve each launch's
              device time by kernel name under torch.profiler; predict
              also at the large map's N = 1024, and the per-launch floor
              (an empty hand-written kernel in the same CUDA-graph
              harness).  The add path's two launches, init (A) and
              init_augment (B), are held together against the plain
              version in float64 at 16, 1 and 96 valid of 96 candidates
              and with two valid candidates on one slot;
  3. path     SlamRuntime(SlamConfig()) on the card at full s3 width: a
              closed-loop synthetic scene records an injection log (about
              160 points, a smooth camera path, 1 px noise, 5% outliers),
              then the log is replayed through the replay entry point
              (eval/replay.py run_uploaded) with every launch counter set
              to 0 just before and read just after, which gives frames/s;
              then two more replays: one counts host syncs per frame
              under PyTorch's sync debug mode, one of the first 40 frames
              takes each phase's host and device ms from torch.profiler's
              ranges, the device launches a call of predict_measurements
              and of an addition (filter/features._add_features_impl);
  4. replay   the same log through the port on the CPU in float64 (the
              plain path), held against the card's float32 trajectory;
              then in float32, for the frames whose inlier mask flips
              between the card and the plain float32 path (reported);
  5. live     the live entry points on 640x480 synthetic frames (a window
              sliding over a blob texture) under the s3 profile (STAR,
              BRIEF-256, descriptor matching with subpixel refinement):
              run_sequence_on_device (init_step, then step per frame) with
              every launch counter set to 0 just before and read just
              after, which gives frames/s, the step's prefix replayed as
              its CUDA graph (captured once; every phase of an engine or
              runtime that steps live checks the same), the graph's
              capture seconds, and its nodes, device µs and idle µs a
              node over back-to-back replays; then a run under sync debug
              mode (host syncs per frame, at most 1), one under
              torch.profiler (host and device ms per step span), STAR
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
              frame 50 which a fresh engine resumes to the end (records
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
  8. profiles the other front-end profiles on the live entry points:
              SlamConfig() (FAST + BRIEF-256, the default) over phase 5's
              101 frames through run_sequence_on_device, with every launch
              counter set to 0 just before and read just after (BRIEF once
              a frame, STAR never, predict, measure, the fused update and
              init as in phase 5), a second timed run, a run under sync
              debug mode (at most 1 host sync a frame, at the read of
              phase_mapman), 20 steps under torch.profiler with a range
              around each PyTorch chain of the front end, the first
              frame's score maps and descriptors against the same port
              functions' plain float32 run on the CPU (bit for bit; float
              descriptors to 1e-6), and the live log replayed in float64
              (1e-4 m, masks 95%); then ORB/ORB, SIFT/SURF, SURF/SURF,
              HARRIS/BRIEF and SHI_TOMASI/ORB, each with the config's
              defaults, over the first 21 of those frames with the same
              checks but the second run (10 steps under the profiler).
  9. ncc      the NCC matcher live: SlamConfig(matcher="ncc") with PATCH
              descriptors at their defaults (F = 96, patch radius 7,
              search radius 10, the warp on, FAST for additions) over the
              first 101 of phase 5's frames through run_sequence_on_device,
              with every launch counter set to 0 just before and read just
              after; a sync debug run (at most 1 a frame), 20 steps under
              torch.profiler with a range around warp_templates, ncc_match
              and extract_patches_bilinear, ncc_match with warped templates
              on frame T/2's own inputs against the same functions' plain
              float32 run on the CPU (matched and refreshed identical, z
              within 1e-3 px, templates within 1e-5), and the live log
              replayed in float64 (1e-4 m, masks 95%);
 10. loop     SlamEngine with the s3 profile, keyframe_every 6 and
              relocalize_after 3 over tests/test_loop_closure.py's scenario
              on phase 5's texture (46 frames forward, 8 black, back):
              launches, at least one relocalization and one accepted loop
              closure, corrected_trajectory()'s endpoint error under 0.8x
              the raw one, the card's optimised graph against the same raw
              graph optimised on the CPU in float64 (1e-4 m), optimize's
              device ms, a pose-graph checkpoint round trip, and host syncs
              on keyframe frames and on the others (at most 2);
 11. serve    SlamServer(SlamConfig()) on the card in a thread on a unix
              socket, driven by the C client (native/ekf_client.c built
              with gcc into build/torch_kernels/, loaded by ctypes): 21
              frames whose served poses must equal an in-process
              SlamEngine's bit for bit, a second session, a bad session
              and a bad frame answered with errors while the daemon keeps
              serving, and ms a step through the socket and in process.
 12. batch    B = 8 s3 streams through one step (parallel/batch_runner.py
              on the card): stream b slides 1 + b % 3 px a frame over its
              own texture (seed 5 + b), 101 frames, batched_init_recorded
              then scan_batched_sequences with every launch counter set to
              0 just before and read just after (each kernel's launches a
              batched frame as a single-stream frame's, init only on
              frames where a stream adds); at most 1 host sync a batched
              frame (the gate's read); each stream against its own
              single-stream run on the card (1e-4 m, masks on 95% of
              frames); streams 0 and 7's live logs replayed in float64 on
              the CPU (1e-4 m); tracking health per stream; stream 0 bit
              for bit with stream 1's frames flipped; 10 batched frames
              under torch.profiler; and stream-frames/s at B = 1, 4, 8 and
              16 over 21 frames after 5 (the sweep up and down) beside the
              single-stream step in the same call.  Then, at B = 4 over 21
              frames of those streams, each other configuration at full
              width with its own defaults: ORB/ORB, SIFT/SURF, SURF/SURF,
              HARRIS/BRIEF and SHI_TOMASI/ORB, NCC (PATCH), the parity mode
              (both flags, 1000 hypotheses) and the large map (MaxMapSize
              960: F = 168, N = 1024): each kernel launched as often a
              batched frame as a single-stream frame (the S-inverse's
              memset and six launches once an update phase on the large
              map and in parity, its six batched kernels by name under the
              profiler), at most 1 host sync a batched frame, each stream
              within 1e-4 m of its single-stream card run (masks on 95% of
              frames), tracking health, stream-frames/s beside the single
              stream, and vmap's per-sample fallbacks by op (the card's
              torch lacks some batching rules the CPU's has);
 13. viz      SlamEngine with the s3 profile, render, render_debug and
              viz3d_every 10 over 21 frames into chiprun_out/viz: the JAX
              engine's files (%05d.png, videoOutput.mp4, debug/%05d.png,
              debug/ransacDebug.mp4, map3d_%05d.png), each overlay against
              the port's draw_* applied on the CPU to that frame's record,
              the host syncs a rendered frame against an unrendered one,
              the drawing fields' read-back and snapshot_from_state against
              the CPU's.  OpenCV or matplotlib missing on the machine is
              printed on its own line, and what needs it is not rendered.
 14. shard    the large map (phase 6's configuration and frames) with P
              split over torch.distributed ranks (parallel/sharding.py),
              each rank a spawned process on the one card: p = 1 over NCCL
              (21 frames), p = 2 row strips and (p, q) = (2, 2) tiles over
              gloo (41 frames), and (d, p) = (2, 2) over gloo, phase 12's
              streams 0 and 1 through batch_runner's two-axis layout (21
              frames).  Each run: launches a step (measure 2, the
              S-inverse's set 2, STAR 1, BRIEF 1, init (A) on adding frames
              only, no predict, fused update or (B)), the collectives a
              step by kind, axis and site with their bytes (none of N x N
              elements, under 4 N^2 x 4 bytes a step), each rank's P bytes,
              the replicated state and records of every rank bit for bit
              against its group's first rank on every step, host syncs a
              step by site (at most 1 over NCCL), max |P - P^T| / max |P|
              of the gathered P (<= 1e-6), each run within 1e-4 m of the
              single-device run of the same frames in this call (masks on
              95% of frames), p = 2's log replayed in float64 on the CPU
              (1e-4 m), and frames/s beside the single device (the ranks
              share one card: no scaling is measured).

Phases 5, 6 and 8 run 100 steps each, which keeps the whole run well
inside its time limit with phases 12 to 14.

Phase 2 also launches each main-path kernel (predict, measure and its
quirks variant, the update's three launches, init (A) and (B), STAR by
both routes, BRIEF by both variants, the S-inverse's memset and six
launches) once over 8 streams' different inputs, checks it bit for bit
against 8 single launches, and times that launch (CUDA graph): each row's
``batch8_ms``.  The S-inverse's 8 streams are masked S of the large map's
M = 336 (one with every row masked), and again at M = 337.

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
S-inverse's times and bound are on a kept frame's S of phase 6), with
``launches_batch`` from phase 12's main run, ``launches_batch_configs``
from its runs of the other configurations, ``launches_shard`` from phase
14's runs (rank 0's), and ``batch8_ms`` from phase 2
(null for the Cholesky solve, which has no path and no batched launch).  The last line is {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import hashlib
import importlib.util
import json
import math
import multiprocessing
import os
import queue
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from openekfmonoslam_tpu_torch import spans
from openekfmonoslam_tpu_torch.config import (DescriptorConfig,
                                              DetectorConfig, SlamConfig,
                                              auto_max_features, load_config)
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
from openekfmonoslam_tpu_torch.filter.state import SlamState, dim_active_mask
from openekfmonoslam_tpu_torch.graph import pose_graph as graph_mod
from openekfmonoslam_tpu_torch.io.sources import SlidingWindowSource
from openekfmonoslam_tpu_torch.ops import (brief_kernel, cholsolve,
                                           cuda_lib, init_kernel,
                                           measure_kernel, predict_kernel,
                                           ransac_kernel, sinv, spd_core,
                                           star_kernel, update_kernel)
from openekfmonoslam_tpu_torch.parallel import (batch_runner, multihost,
                                                sharding)
from openekfmonoslam_tpu_torch.serving import server as server_mod
from openekfmonoslam_tpu_torch.vision import brief
from openekfmonoslam_tpu_torch.vision import dog as dog_mod
from openekfmonoslam_tpu_torch.vision import fast as fast_mod
from openekfmonoslam_tpu_torch.vision import floatdesc
from openekfmonoslam_tpu_torch.vision import harris as harris_mod
from openekfmonoslam_tpu_torch.vision import ncc as ncc_mod
from openekfmonoslam_tpu_torch.vision import orb as orb_mod
from openekfmonoslam_tpu_torch.vision import star
from openekfmonoslam_tpu_torch.vision.frontend import Frontend

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
    # the add path's two launches: (A) the chain with the compact operands,
    # (B) the covariance augmentation, which carries the work the TPU
    # kernel's caller ran after it in XLA (filter/features.py:177-224)
    "init": dict(counter=init_kernel.LAUNCHES,
                 source="openekfmonoslam_tpu_torch/csrc/init.cu",
                 replaces="openekfmonoslam_tpu/ops/init_kernel.py:48"),
    "init_augment": dict(counter=init_kernel.AUGMENT_LAUNCHES,
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
    # RANSAC's hypotheses and support count, both variants (the deadband
    # one in the parity mode)
    "ransac_support": dict(counter=ransac_kernel.LAUNCHES,
                           source="openekfmonoslam_tpu_torch/csrc/ransac.cu",
                           replaces="none: RANSAC is XLA in the JAX package"),
}


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["counter"].reset()


def read_launches() -> dict:
    return {name: spec["counter"].count for name, spec in KERNELS.items()}

T_FRAMES = 220          # frames of the replay path (>= 200)
# its first frames under the profiler (which costs about half a second a
# frame with the chain ranges)
PATH_PROFILED = 40
T_LIVE = 101            # frames of the live path: init_step + 100 steps
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
    # P grown by the add path, relative to its largest entry: new rows and
    # columns are sums of four products of entries of P and J1, whose
    # entries reach the tens for a ray near the vertical
    "init_P_rel": 1e-5,
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
LARGE_CKPT_AT = 50            # the frame whose checkpoint is resumed
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
# ... and its additions (the init kernels with the scatters beside them)
ADD_CHAIN = {"filter.add_features": (feat_mod, "_add_features_impl")}
# ... of the S-inverse (csrc/sinv.cu) and of the fused update (update.cu)
SINV_KERNEL_NAMES = ("sinv_flags<false>", "sinv_factor<false>",
                     "sinv_solve<false>", "sinv_product<0, false>",
                     "sinv_product<1, false>", "sinv_product<2, false>")
# ... and its batched launch (one over B streams each)
SINV_BATCH_NAMES = tuple(n.replace("false>", "true>")
                         for n in SINV_KERNEL_NAMES)
UPDATE_KERNEL_NAMES = ("update_factor", "update_solve", "update_downdate")
# ... of the add path (csrc/init.cu)
ADD_KERNEL_NAMES = ("init_chain", "init_augment<true>", "init_augment<false>")
# ... and the batched launches of phase 12 (one over B streams each)
BATCH_KERNEL_NAMES = ("predict_kernel<4, true>",
                      "measure_kernel_batched<false, true>",
                      "update_factor_batched", "update_solve_batched",
                      "update_downdate_batched", "init_chain_batched<true>",
                      "init_augment_batched<true>", "star_tile_batched<true>",
                      "brief_planes_s256_batched")


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
                    or "::" + name + "(" in e.key
                    or " " + name + "(" in e.key):
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


def ransac_frame(rng, F: int, N: int, camera, dev) -> tuple:
    """A RANSAC frame at the main path's shapes: x (N) holding a camera and
    _measure_scene's F slots, the prediction's uv, an H P of a frame's
    scale and an SPD S per slot, matches 0.7 px off with a tenth 30 px
    off: ``ransac_kernel.support``'s tensor arguments, float32 on ``dev``
    (the masks bool)."""
    feats, is_xyz, active, cam7 = _measure_scene(rng, F)
    x = np.zeros(N)
    x[:7] = cam7
    x[13:13 + 6 * F] = feats.reshape(-1)
    uv, _, _, vis = measure_kernel.measure_plain(
        camera, torch.tensor(cam7), torch.tensor(feats),
        torch.tensor(is_xyz), torch.tensor(active))
    A = rng.standard_normal((F, 2, 2))
    z = uv.numpy() + rng.normal(0, 0.7, (F, 2))
    z[rng.random(F) < 0.1] += 30.0
    matched = vis.numpy() & (rng.random(F) < 0.9)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(x, **f32),
            torch.tensor(rng.normal(0, 0.01, (2 * F, N)), **f32),
            torch.tensor(A @ A.transpose(0, 2, 1) + np.eye(2), **f32),
            torch.tensor(z, **f32), uv.to(**f32),
            *(torch.tensor(m, device=dev) for m in (matched, active,
                                                    is_xyz)))


def ransac_gaps(camera, args, pe: float, thr: float, deadband: bool,
                got=None) -> dict:
    """The kernel's RANSAC decisions (``got``: its (support, good), else a
    launch on ``args``) against the plain float32 chain's on the same
    inputs: the (hypothesis, slot) decisions that differ outside the knife
    edges (ransac_kernel.knife_edges), the supports that differ by more
    than their row's edges, and the edges."""
    sup, good = got or ransac_kernel.support(camera, *args, pe, thr,
                                             deadband)
    sup_p, good_p = ransac_kernel.support_plain(camera, *args, pe, thr,
                                                deadband)
    edge = ransac_kernel.knife_edges(camera, *args, pe, thr, deadband)
    return dict(
        wrong=int((good != good_p)[~edge].sum()),
        support_off=int(((sup - sup_p).abs() > edge.sum(1)).sum()),
        edges=int(edge.sum()), decisions=good.numel(),
        max_support=int(sup_p.max()))


def ransac_decisions(failures, tag: str, run) -> dict:
    """RANSAC's decisions on every frame ``run()`` steps: each launch's
    inputs and outputs kept, then held against the plain float32 chain
    (ransac_gaps) on the card: no decision may differ outside the knife
    edges.  The steps run eagerly (spans.collect), since a replayed CUDA
    graph calls no Python wrapper."""
    calls = []
    launch = ransac_kernel.support

    def kept(camera, *args):
        out = launch(camera, *args)
        calls.append((camera, [a.clone() for a in args[:8]], args[8:],
                      [o.clone() for o in out]))
        return out

    ransac_kernel.support = kept
    try:
        with spans.collect():
            run()
        torch.cuda.synchronize()
    finally:
        ransac_kernel.support = launch
    gaps = [ransac_gaps(camera, args, *rest, got=out)
            for camera, args, rest, out in calls]
    total = {k: sum(g[k] for g in gaps)
             for k in ("wrong", "support_off", "edges", "decisions")}
    check(failures, bool(gaps) and total["wrong"] == 0
          and total["support_off"] == 0,
          f"{tag}: RANSAC's decisions on {len(gaps)} frames equal the plain "
          f"float32 chain's outside {total.get('edges')} knife edges "
          f"({total.get('decisions')} decisions; {total.get('wrong')} "
          f"differ, {total.get('support_off')} supports off)")
    return dict(frames=len(gaps), **total)


def check_graph(failures, tag: str, runtime) -> dict:
    """The runtime's step replays its prefix's CUDA graph: each key
    captured once, and the last step replayed (engine/step_graph.py)."""
    graphs = runtime._graphs
    captures = list(graphs.captures.values())
    check(failures, bool(captures) and set(captures) == {1}
          and runtime.replayed,
          f"{tag}: the step's prefix captured once a key ({captures}) and "
          f"replayed ({runtime.replayed})")
    return dict(captures=len(captures),
                capture_s=[round(v, 4) for v in graphs.capture_s.values()])


def graph_nodes(runtime, reps: int = GRAPH_REPS) -> dict:
    """The runtime's captured step graph replayed ``reps`` times back to
    back on its static inputs: µs a replay by CUDA events (the device's
    extent, launch to end), its device records (nodes) and their summed
    µs under the profiler, and the idle µs a node between them."""
    (graph,) = [g.graph for g in runtime._graphs._graphs.values()]
    for _ in range(3):
        graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    extent = t0.elapsed_time(t1) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    nodes = sum(e.count for e in device) / reps
    busy = sum(e.device_time_total for e in device) / reps
    return dict(extent_us=extent, nodes=nodes, busy_us=busy,
                idle_us_per_node=(extent - busy) / max(nodes, 1))


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
    cases = [(frontend.brief_pattern.variant, frontend.brief_pattern)]
    if both:
        cases += [("generic", frontend.brief_pattern),
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


# operations of (A) a candidate: the chain (about 250) and the compact
# operands B = J1 P77 and B J1^T + J2 diag(r) J2^T (about 230)
INIT_FLOPS = 480
# valid candidates of phase 2's timed augmentation (of C = 96), and the
# checks' cases: (valid candidates, a duplicate slot?)
AUG_VALID = 16
AUG_CASES = ((AUG_VALID, False), (1, False), (96, False), (12, True))


def augment_case(rng, C: int, F: int, valid: int, duplicate: bool, dev):
    """slots (C,) int32 and ok (C,): ``valid`` candidates at shuffled slots
    of the F, the rest invalid at slot F; with ``duplicate``, two valid
    candidates name one slot."""
    slots = np.full(C, F, np.int32)
    ok = np.zeros(C, bool)
    where = rng.choice(C, valid, replace=False)
    slots[where] = rng.choice(F, valid, replace=False)
    ok[where] = True
    if duplicate:
        slots[where[2]] = slots[where[0]]
    return (torch.tensor(slots, device=dev), torch.tensor(ok, device=dev))


def check_augment(failures, camera, P, c7, cuv, rho0, r_add, F) -> dict:
    """(A) + (B) against the plain version in float64 on the CPU (where a
    dim two valid candidates name goes to the higher one, as in the
    kernel) at each of AUG_CASES; the elements of no new dim bit for bit.
    The row of (B) at AUG_VALID valid candidates."""
    rng = np.random.default_rng(10)
    N, C = P.shape[0], cuv.shape[0]
    cpu = [t.double().cpu() for t in (P, c7, cuv)]
    err = 0.0
    for valid, dup in AUG_CASES:
        slots, ok = augment_case(rng, C, F, valid, dup, P.device)
        feats, P_new = init_kernel.add_covariance(camera, P, c7, cuv, slots,
                                                  ok, rho0, r_add)
        f64, P64 = init_kernel.add_covariance_plain(
            camera, *cpu, slots.cpu(), ok.cpu(), rho0, r_add)
        new = torch.zeros((N + 1,), dtype=torch.bool)
        new[init_kernel.new_dims(slots, ok, N).reshape(-1).cpu()] = True
        old = ~new[:N]
        e = max_abs(P_new.cpu(), P64)
        limit = TOL["init_P_rel"] * max(1.0, float(P64.abs().max()))
        same = torch.equal(P_new.cpu()[old][:, old], P.cpu()[old][:, old])
        check(failures, e <= limit and same
              and max_abs(feats.cpu(), f64) <= TOL["init_feats"],
              f"init (A) + (B) at {valid} valid of {C}"
              + (", a duplicate slot" if dup else "")
              + f": P_new err {e:.3e} <= {limit:.1e}, the other "
              f"elements bit-identical: {same}")
        err = max(err, e)
        if valid == AUG_VALID and not dup:
            timed = (slots, ok)
    slots, ok = timed
    ops = init_kernel._chain_cuda(camera, c7, cuv, rho0, P, r_add)[3]
    _, J1, J2 = init_kernel.init_plain(camera, c7, cuv, rho0)
    k6 = 6 * AUG_VALID
    return dict(
        max_abs_err=err, valid=AUG_VALID,
        bytes=2 * N * N * 4 + C * (4 * init_kernel.OPS + 4 + 1),
        # a new element: at most four multiply-adds
        flops=8 * (2 * k6 * N - k6 * k6),
        kernel=lambda: init_kernel.augment_cuda(P, ops, slots, ok),
        plain=lambda: init_kernel.augment_plain(P, J1, J2, slots, ok, r_add))


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

    # ---- RANSAC's support count on a frame of the s3 map (its own
    # generators, so the inputs of the checks after it stay as they were),
    # its deadband variant (the parity mode's) on the same frame, and a
    # frame of the large map (F = 168, N = 1024)
    pe = cfg.camera.pixel_error_x
    thr = cfg.ekf.ransac_threshold_predict_distance
    r_s3 = ransac_frame(np.random.default_rng(18), F, N, camera, dev)
    r_large = ransac_frame(np.random.default_rng(168), LARGE_F, LARGE_N,
                           camera, dev)
    for name, deadband, r_args in (
            ("ransac_support", False, r_s3),
            ("ransac_support_deadband", True, r_s3),
            ("ransac_support_f168", False, r_large)):
        Fr, Nr = r_args[5].shape[0], r_args[0].shape[0]
        gaps = ransac_gaps(camera, r_args, pe, thr, deadband)
        check(failures, gaps["wrong"] == gaps["support_off"] == 0
              and gaps["max_support"] >= 3,
              f"{name}: decisions equal the plain float32 chain's outside "
              f"{gaps['edges']} knife edges ({gaps})")
        # the operations: about 400 a (hypothesis, slot), h(x)'s 11 Newton
        # steps most of them
        rows[name] = dict(
            max_abs_err=float(gaps["wrong"]), checks=gaps, F=Fr, N=Nr,
            bytes=4 * ((2 * Fr + 1) * (7 + 6 * Fr) + 8 * Fr) + 3 * Fr
            + Fr * Fr + 4 * Fr,
            flops=400 * Fr * Fr,
            kernel=lambda d=deadband, a=r_args: ransac_kernel.support(
                camera, *a, pe, thr, d),
            plain=lambda d=deadband, a=r_args: ransac_kernel.support_plain(
                camera, *a, pe, thr, d))

    # ---- update
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

    # ---- init: (A) the chain with the compact operands, as the add path
    # runs it on the s3 state, and (B) the augmentation of P
    q = rng.standard_normal(4)
    c7 = torch.tensor(np.concatenate([rng.normal(0, 0.1, 3),
                                      q / np.linalg.norm(q)]), **f32)
    cuv = torch.tensor(rng.uniform(20, 600, (C, 2)), **f32)
    rho0 = cfg.ekf.init_inv_depth_rho
    r_add = (cfg.camera.pixel_error_x ** 2, cfg.camera.pixel_error_y ** 2,
             cfg.ekf.inverse_depth_rho_sd ** 2)
    Pa = torch.tensor(_spd_state(np.random.default_rng(9), N)[0], **f32)
    got = init_kernel._chain_cuda(camera, c7, cuv, rho0, Pa, r_add)[:3]
    ref = init_kernel.init_plain(camera, c7.double(), cuv.double(), rho0)
    errs = [max_abs(a, b) for a, b in zip(got, ref)]
    for name, err_i, tol in zip(("feats", "J1", "J2"), errs,
                                (TOL["init_feats"], TOL["init_J1"],
                                 TOL["init_J2"])):
        check(failures, err_i <= tol, f"init {name} err {err_i:.3e} <= {tol}")
    rows["init"] = dict(
        max_abs_err=max(errs),
        bytes=4 * (7 + 49 + (2 + 6 + 42 + 18 + init_kernel.OPS) * C),
        flops=INIT_FLOPS * C,
        kernel=lambda: init_kernel._chain_cuda(camera, c7, cuv, rho0, Pa,
                                               r_add),
        plain=lambda: init_kernel.init_plain(camera, c7, cuv, rho0))
    aug = check_augment(failures, camera, Pa, c7, cuv, rho0, r_add, F)
    rows["init_augment"] = aug

    # ---- star, brief: the main path's 640x480 frame, then an odd shape
    h, w = LIVE_HW
    gray = torch.tensor(blob_texture(rng, h, w), device=dev)
    main = check_star_brief(failures, "main", gray, frontend, both=True)
    odd = check_star_brief(failures, "odd", torch.tensor(
        blob_texture(rng, 483, 645), device=dev), frontend, both=True)
    check(failures, main["peaks"] >= 1000,
          f"the textured frame has {main['peaks']} STAR peaks (>= 1000)")
    s_set, pattern = frontend.star, frontend.brief_pattern
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
            flops=m_ ** 3 / 3 + 2 * m_ * m_ * k_, split=True,
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
    check_batched_kernels(failures, rows, cfg, camera, frontend, dev)
    sinv_batch8 = check_sinv_batched(failures, dev)
    # the update's masked S at M = 336 (a single launch), and the batch
    S_m = torch.tensor(masked_s(336), **f32)
    rows["sinv_masked336"] = sinv_row(S_m, max(
        c["abs_err"] for c in sinv_checks if c["cond"] == "masked"))
    rows["sinv_masked336"]["batch8"] = sinv_batch8
    end_phase("kernels (checks)", failures)

    for name, row in rows.items():
        time_row(name, row)
    # the path's S-inverse row (timed after phase 6) takes the same batch
    rows["sinv_batch8_fn"] = sinv_batch8
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


# ------------------------------------------------ batched launches

BATCH = 8     # streams of phase 2's batched launches and of phase 12


def batched_kernel_cases(cfg: SlamConfig, camera, frontend, dev) -> dict:
    """{row: (one launch over BATCH stacked inputs, stream b's single
    launch)} at the main path's shapes, on BATCH different inputs; each
    callable returns a tuple of tensors (the batched one's with a leading
    stream axis).  Stream 0 of the update uses no slot and stream 0 of the
    augmentation has no valid candidate: they pass through while the
    others change."""
    rng = np.random.default_rng(12)
    N, F, C = cfg.padded_state_dim, cfg.max_features, cfg.max_features
    f32 = dict(dtype=torch.float32, device=dev)

    def stack(arrays, **kw):
        return torch.stack([torch.tensor(a, **kw) for a in arrays])

    cases = {}
    lin, ang = cfg.ekf.linear_accel_sd ** 2, cfg.ekf.angular_accel_sd ** 2
    states = [_spd_state(rng, N) for _ in range(BATCH)]
    P, x = (stack([s[k] for s in states], **f32) for k in (0, 1))
    cases["predict"] = (
        lambda: predict_kernel.predict_cuda(P, x, 1.0, lin, ang),
        lambda b: predict_kernel.predict_cuda(P[b], x[b], 1.0, lin, ang))

    scenes = [_measure_scene(rng, F) for _ in range(BATCH)]
    feats, cam7 = (stack([s[k] for s in scenes], **f32) for k in (0, 3))
    is_xyz, active = (stack([s[k] for s in scenes], device=dev)
                      for k in (1, 2))
    for name, quirks in (("measure", False), ("measure_quirks", True)):
        cases[name] = (
            lambda q=quirks: measure_kernel.measure_cuda(
                camera, cam7, feats, is_xyz, active, q),
            lambda b, q=quirks: measure_kernel.measure_cuda(
                camera, cam7[b], feats[b], is_xyz[b], active[b], q))

    pe = cfg.camera.pixel_error_x
    thr = cfg.ekf.ransac_threshold_predict_distance
    frames = [ransac_frame(np.random.default_rng(18 + b), F, N, camera, dev)
              for b in range(BATCH)]
    frames[0][5].zero_()                            # stream 0 matches none
    R = [torch.stack(parts) for parts in zip(*frames)]
    cases["ransac_support"] = (
        lambda: ransac_kernel.support_cuda(camera, *R, pe, thr),
        lambda b: ransac_kernel.support_cuda(camera, *(r[b] for r in R),
                                             pe, thr))
    probs = [_update_problem(rng, N, F, frac)
             for frac in np.linspace(0.0, 0.9, BATCH)]
    U = [stack([p[k] for p in probs], **f32) for k in range(6)]
    U.append(stack([p[6] for p in probs], device=dev))
    cases["update"] = (
        lambda: update_kernel.joint_update_cuda(*U, pe)[:2],
        lambda b: update_kernel.joint_update_cuda(*(u[b] for u in U),
                                                  pe)[:2])

    rho0 = cfg.ekf.init_inv_depth_rho
    r_add = (cfg.camera.pixel_error_x ** 2, cfg.camera.pixel_error_y ** 2,
             cfg.ekf.inverse_depth_rho_sd ** 2)
    qs = rng.standard_normal((BATCH, 4))
    c7 = stack([np.concatenate([rng.normal(0, 0.1, 3),
                                q / np.linalg.norm(q)]) for q in qs], **f32)
    cuv = stack([rng.uniform(20, 600, (C, 2)) for _ in range(BATCH)], **f32)
    cases["init"] = (
        lambda: init_kernel._chain_cuda(camera, c7, cuv, rho0, P, r_add),
        lambda b: init_kernel._chain_cuda(camera, c7[b], cuv[b], rho0, P[b],
                                          r_add))
    ops = init_kernel._chain_cuda(camera, c7, cuv, rho0, P, r_add)[3]
    placed = [augment_case(rng, C, F, valid, dup, dev) for valid, dup in
              zip((0, 1, 16, 96, 12, 40, 7, 64),
                  (False, False, False, False, True, False, False, True))]
    slots, ok = (torch.stack([a[k] for a in placed]) for k in (0, 1))
    cases["init_augment"] = (
        lambda: (init_kernel.augment_cuda(P, ops, slots, ok),),
        lambda b: (init_kernel.augment_cuda(P[b], ops[b], slots[b], ok[b]),))

    h, w = LIVE_HW
    s_set, pattern = frontend.star, frontend.brief_pattern
    grays = [torch.tensor(blob_texture(rng, h, w), device=dev)
             for _ in range(BATCH)]
    ii = torch.stack([star._integral(g, star.integral_pad(s_set.max_size))
                      for g in grays])
    smoothed = torch.stack([brief.smooth(g, cfg.descriptor.blur_sigma)
                            for g in grays])
    for name, route in (("star", "staged"), ("star_direct", "direct")):
        cases[name] = (
            lambda r=route: star_kernel.star_cuda(ii, h, w, s_set, r),
            lambda b, r=route: star_kernel.star_cuda(ii[b], h, w, s_set, r))
    wide = wide_pattern(frontend, dev)
    for name, pat, variant in (("brief", pattern, "s256"),
                               ("brief_generic", wide, "generic")):
        cases[name] = (
            lambda pat=pat, v=variant: (
                brief_kernel.dense_planes_cuda(smoothed, pat, v),),
            lambda b, pat=pat, v=variant: (torch.stack(
                brief_kernel.dense_planes_cuda(smoothed[b], pat, v)),))
    return cases


def check_batched_kernels(failures, rows: dict, cfg: SlamConfig, camera,
                          frontend, dev) -> None:
    """Each main-path kernel's launch over BATCH streams against BATCH
    single launches on the same inputs, bit for bit; puts the batched
    launch on its row (``batch8``) for time_row."""
    for name, (batched_fn, single_fn) in batched_kernel_cases(
            cfg, camera, frontend, dev).items():
        got = batched_fn()
        same = all(torch.equal(g[b], s)
                   for b in range(BATCH)
                   for g, s in zip(got, single_fn(b)))
        check(failures, same and got[0].shape[0] == BATCH,
              f"{name}: one launch over {BATCH} streams bit-identical to "
              f"{BATCH} single launches ({len(got)} outputs)")
        rows[name]["batch8"] = batched_fn


def time_row(name: str, row: dict) -> None:
    """A kernel row's device time (CUDA graph), eager time, plain and
    library times and bound, in place; drops its callables.  A row with a
    batched launch also gets its time over BATCH streams (CUDA graph)."""
    batch8 = row.pop("batch8", None)
    row["ms"] = graph_ms(row["kernel"])
    row["eager_ms"] = events_ms(row["kernel"], EAGER_REPS)
    row["plain_ms"] = events_ms(row["plain"], PLAIN_REPS)
    library = row.pop("library", None)
    row["library_ms"] = (events_ms(library, EAGER_REPS)
                         if library is not None else None)
    row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"], row["flops"])
    # after the single launch's times, so the card runs them as before
    row["batch8_ms"] = graph_ms(batch8) if batch8 is not None else None
    if row.pop("split", False):
        row["split_us"] = device_split_us(row["kernel"])
        print(f"  {name} by kernel under the profiler (device us a call): "
              + ", ".join(f"{k} {v:.2f}" for k, v in row["split_us"].items()),
              flush=True)
    lib = ("" if row["library_ms"] is None
           else f", library {row['library_ms'] * 1e3:.2f} us")
    if row["batch8_ms"] is not None:
        lib += (f"; {BATCH} streams in one launch "
                f"{row['batch8_ms'] * 1e3:.2f} us "
                f"({row['batch8_ms'] * 1e3 / BATCH:.2f} us a stream)")
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


def masked_s(m: int, seed: int = 1, used_frac: float = 0.6) -> np.ndarray:
    """tests/test_sinv.py's masked S: identity rows for unused slots (about
    1 - used_frac of them), the shape the update gives the inverse."""
    rng = np.random.default_rng(seed)
    used = rng.random(m) < used_frac
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


def sinv_batch(m: int, seed: int) -> np.ndarray:
    """(BATCH, m, m) float32: BATCH different masked S, stream 0's with
    every row masked (S = I), the others using about 0.1 to 0.9 of their
    rows."""
    return np.stack([np.eye(m, dtype=np.float32)] + [
        masked_s(m, seed + b, frac)
        for b, frac in enumerate(np.linspace(0.1, 0.9, BATCH - 1))])


# the S-inverse's batched launch: the large map's M = 2F = 336, and an odd M
SINV_BATCH_M = (336, 337)


def check_sinv_batched(failures, dev):
    """The S-inverse's one launch set over BATCH streams' different S
    (sinv_batch) against BATCH single launches, bit for bit, at each of
    SINV_BATCH_M, and the all-masked stream exactly I; returns the launch
    at M = 336 for the timing (the ``sinv`` row's ``batch8``)."""
    timed = None
    for m in SINV_BATCH_M:
        S = torch.tensor(sinv_batch(m, m), device=dev)
        X, info = sinv.sinv_cuda(S)
        same = all(torch.equal(X[b], sinv.sinv_cuda(S[b])[0])
                   for b in range(BATCH))
        check(failures, same and bool(torch.equal(
            X[0], torch.eye(m, device=dev))) and not bool(info.any()),
              f"sinv: one launch set over {BATCH} masked S at M = {m} "
              f"bit-identical to {BATCH} single launches, the all-masked "
              "stream exactly I, no non-positive pivot")
        if timed is None:
            timed = (lambda S=S: sinv.sinv_cuda(S))
    return timed


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

    # and its first PATH_PROFILED frames under torch.profiler, for the time
    # of each phase, with a range around each predict_measurements call and
    # each addition for their device launches
    K = PATH_PROFILED
    head = ulog._replace(**{f: getattr(ulog, f)[:K] for f in (
        "z", "matched", "new_uv", "new_valid", "new_slot")})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            chain_ranges({**MEASURE_CHAIN, **ADD_CHAIN}):
        replay.run_uploaded(runtime, head)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    mc = chain_device(prof.events(), K, tuple(MEASURE_CHAIN))[
        "filter.predict_measurements"]
    measure_launches = mc["launches"] / mc["calls"]
    print(f"  predict_measurements: {measure_launches:.2f} device launches "
          f"a call ({mc['calls']:.2f} calls a frame, "
          f"{mc['device_us'] / mc['calls']:.2f} device us a call)",
          flush=True)
    # the addition's PyTorch launches (the range does not see the two
    # ctypes launches of csrc/init.cu, which kernel_device_us reads)
    ac = chain_device(prof.events(), K, tuple(ADD_CHAIN))[
        "filter.add_features"]
    add_us = kernel_device_us(averages, K, ADD_KERNEL_NAMES)
    add_call = dict(calls_per_frame=ac["calls"],
                    torch_launches=ac["launches"] / ac["calls"],
                    torch_device_us=ac["device_us"] / ac["calls"],
                    host_us=ac["host_us"] / ac["calls"],
                    kernels_us={k: v["us_per_frame"] / ac["calls"]
                                for k, v in add_us.items()})
    print(f"  additions: {add_call['torch_launches']:.2f} PyTorch device "
          f"launches a call plus the two of csrc/init.cu "
          f"({ac['calls']:.2f} calls a frame; PyTorch's "
          f"{add_call['torch_device_us']:.2f} device us, "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      add_call["kernels_us"].items())
          + f" us; host {add_call['host_us']:.2f} us a call)", flush=True)
    phase_ms = phase_times(averages, K)
    dev_ms = device_ms(averages, K)
    update_us = kernel_device_us(averages, K, UPDATE_KERNEL_NAMES)
    print(f"  per-phase ms/frame under the profiler over {K} frames (host, "
          "device of PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    print_device(dev_ms, update_us)

    T = T_FRAMES
    check(failures, launches["predict"] == T, f"predict launches {T}")
    check(failures, launches["ransac_support"] == T,
          f"ransac_support launches {T} (one a RANSAC phase)")
    check(failures, launches["measure"] == 2 * T, f"measure launches {2 * T}")
    check(failures, launches["measure_quirks"] == 0,
          "no launch of the measure kernel's quirks variant")
    check(failures, launches["update"] == 2 * T, f"update launches {2 * T}")
    check(failures, launches["sinv"] == 0, "no S-inverse launch")
    check(failures, launches["init"] >= 1, "init launched at least once")
    check(failures, launches["init_augment"] == launches["init"],
          "each addition launches (A) and (B) once "
          f"({launches['init']}, {launches['init_augment']})")
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
                add_call=add_call,
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
    # the rounding of the kernels judged against the plain float32 path's
    # own: the same log through the port's plain versions on the CPU in
    # float32, and the frames whose inlier mask differs (reported only)
    _, recs32 = replay.replay_records(SlamRuntime(SlamConfig(), device="cpu"),
                                      path["log"])

    def flips(a, b):
        return [t + 1 for t, (x, y) in enumerate(zip(a, b))
                if not np.array_equal(x, y)]
    card = [r.inliers.cpu().numpy() for r in recs]
    plain32 = [r.inliers.numpy() for r in recs32]
    f64 = [r.inliers.numpy() for r in recs64]
    mask_flips = dict(card_vs_plain32=flips(card, plain32),
                      card_vs_float64=flips(card, f64),
                      plain32_vs_float64=flips(plain32, f64))
    print("  inlier-mask flips (frames): "
          + "; ".join(f"{k} {v}" for k, v in mask_flips.items()), flush=True)
    return dict(cpu_s=cpu_s, sigma_final=float(sigma[-1]),
                sigma_per_frame=sigma.tolist(), mask_flips=mask_flips,
                **agree)


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

def live_frames(T: int, hw=LIVE_HW, seed: int = 5,
                step: int = 2) -> np.ndarray:
    """(T, H, W) uint8: a window sliding ``step`` px a frame over a blob
    texture (io/sources.py SlidingWindowSource), an image-space pan."""
    h, w = hw
    still = blob_texture(np.random.default_rng(seed), h, w + step * T)
    return np.stack(list(SlidingWindowSource(still, (h, w),
                                             step_xy=(step, 0),
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
    graph = check_graph(failures, "live path", runtime)
    check(failures, launches["star"] == T and launches["brief"] == T,
          f"star and brief launched once a frame plus once for init_step "
          f"({T})")
    check(failures, launches["star_direct"] == 0
          and launches["brief_generic"] == 0,
          "no launch of STAR's direct route or BRIEF's generic variant")
    check(failures, launches["predict"] == S, f"predict launches {S}")
    check(failures, launches["ransac_support"] == S,
          f"ransac_support launches {S} (one a RANSAC phase)")
    check(failures, launches["measure"] == 2 * S, f"measure launches {2 * S}")
    check(failures, launches["measure_quirks"] == 0,
          "no launch of the measure kernel's quirks variant")
    check(failures, launches["update"] == 2 * S, f"update launches {2 * S}")
    check(failures, launches["sinv"] == 0,
          "no S-inverse launch on the s3 map (the fused update applies)")
    check(failures, 1 <= launches["init"] <= T,
          f"init launched on init_step and on add frames only "
          f"({launches['init']})")
    check(failures, launches["init_augment"] == launches["init"],
          "each addition launches (A) and (B) once")
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
    graph["nodes"] = graph_nodes(runtime)
    print(f"  the step's CUDA graph: capture {graph['capture_s']} s; a "
          f"replay {graph['nodes']}", flush=True)
    chains = chain_device(prof.events(), S)
    print("  PyTorch chains beside the front-end kernels, a frame: "
          + "; ".join(f"{k} {v['device_us']:.2f} device us in "
                      f"{v['launches']:.2f} device launches "
                      f"({v['calls']:.2f} calls, host {v['host_us']:.1f} us)"
                      for k, v in chains.items()), flush=True)

    # STAR and BRIEF on frame T/2's own image
    mid = check_star_brief(failures, f"frame {T // 2}", gpu_frames[T // 2],
                           runtime.frontend)
    decisions = ransac_decisions(
        failures, "live path",
        lambda: scan_runner.scan_frames(runtime, st0, gpu_frames[1:]))

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
                frontend_chains=chains, device_ms=dev_ms, graph=graph,
                healthy=healthy,
                mean_matched=float(matched.mean()),
                mean_inliers=float(inl.mean()),
                added=int(recs.new_ok.sum()),
                mid_frame=dict(star_err=mid["star_err"],
                               brief_bits=mid["brief_bits"],
                               peaks=mid["peaks"]),
                ransac_decisions=decisions,
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
    check_graph(failures, "large map", engine.runtime)
    check(failures, launches["sinv"] == 2 * S,
          f"S-inverse launches {launches['sinv']} == {2 * S} (2 a step)")
    check(failures, launches["update"] == 0,
          f"fused update launches {launches['update']} == 0")
    check(failures, launches["predict"] == S, f"predict launches {S}")
    check(failures, launches["ransac_support"] == S,
          f"ransac_support launches {S} (one a RANSAC phase)")
    check(failures, launches["measure"] == 2 * S, f"measure launches {2 * S}")
    check(failures, launches["measure_quirks"] == 0,
          "no launch of the measure kernel's quirks variant")
    check(failures, launches["star"] == T and launches["brief"] == T,
          f"star and brief launched once a frame plus once for init ({T})")
    check(failures, 1 <= launches["init"] <= T,
          f"init launched on init and on add frames only "
          f"({launches['init']})")
    check(failures, launches["init_augment"] == launches["init"],
          "each addition launches (A) and (B) once")
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

    decisions = ransac_decisions(
        failures, "large map", lambda: run_sequence(SlamEngine(str(path)),
                                                    frames))

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

    # a fresh engine resumes the frame-50 checkpoint and runs to the end
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
                max_active=int(active.max()), ransac_decisions=decisions,
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
    check(failures, launches["ransac_support"] == S,
          f"ransac_support launches {S} (one a RANSAC phase)")
    check(failures, launches["init"] >= 1,
          f"init launched on add frames ({launches['init']})")
    check(failures, launches["init_augment"] == launches["init"],
          "each addition launches (A) and (B) once")
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
    check_graph(failures, "parity engine", engine.runtime)
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

# ----------------------------------------------------------------- phase 8

# the other front-end profiles: (detector, descriptor) pairs, each with the
# DetectorConfig / DescriptorConfig defaults, at full width, short depth
PROFILE_PAIRS = (("ORB", "ORB"), ("SIFT", "SURF"), ("SURF", "SURF"),
                 ("HARRIS", "BRIEF"), ("SHI_TOMASI", "ORB"))
T_PROFILE = 21            # frames of each of them: init_step + 20 steps
# steps under the profiler (its cost grows with the launches it traces,
# 3000 a frame on SIFT): the default path's, and each other profile's
DEFAULT_PROFILED = 20
PROFILE_PROFILED = 10
PROFILE_WARM = 6          # frames of a profile's warm-up run
# the front ends' PyTorch chains, each a profiler range; a call nested in
# another (pyramid FAST's fast_scores) counts in both
PROFILE_CHAINS = {
    "frontend.fast_scores": (fast_mod, "fast_scores"),
    "frontend.pyramid_fast": (orb_mod, "pyramid_fast_scores"),
    "frontend.dog": (dog_mod, "dog_scores"),
    "frontend.doh": (dog_mod, "doh_scores"),
    "frontend.harris": (harris_mod, "harris_scores"),
    "frontend.shi_tomasi": (harris_mod, "shi_tomasi_scores"),
    "frontend.nms": (fast_mod, "non_max_suppress"),
    "frontend.smooth": (brief, "smooth"),
    "frontend.moments": (orb_mod, "centroid_moment_maps"),
    "frontend.steered": (orb_mod, "steered_extract"),
    "frontend.surf64": (floatdesc, "surf64"),
}
# a float descriptor of the card against the CPU's, relative to the
# vector's largest entry (float32 sums in each device's order)
FLOAT_DESC_REL = 1e-6


def profile_config(det: str, desc: str) -> SlamConfig:
    return SlamConfig(detector=DetectorConfig(kind=det),
                      descriptor=DescriptorConfig(kind=desc))


def check_profile_frame(failures, tag: str, runtime: SlamRuntime,
                        gray) -> dict:
    """The front end on one frame on the card against the same port
    functions' plain float32 run on the CPU: both score maps bit for bit,
    and the descriptors of the CPU's keypoints (binary ones bit for bit,
    float ones to FLOAT_DESC_REL)."""
    fe = runtime.frontend
    cpu_fe = Frontend(runtime.config, "cpu")
    aux = fe.precompute(gray)
    gray_cpu = gray.cpu()
    aux_p = cpu_fe.precompute(gray_cpu)
    for key in ("score_raw", "score_nms"):
        same = torch.equal(aux[key].cpu(), aux_p[key])
        check(failures, same,
              f"{tag}: {key} identical to the CPU's plain float32 map "
              f"(max |diff| {max_abs(aux[key].cpu(), aux_p[key]):.3e})")
    h, w = gray.shape
    m = fe.border
    ys = torch.arange(h)[:, None]
    xs = torch.arange(w)[None, :]
    inside = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    kps = fast_mod.detect_keypoints(aux_p["score_nms"], inside,
                                    runtime.config.max_keypoints)
    yx = kps.yx[kps.valid]
    desc = fe.describe(aux, yx.to(gray.device)).cpu()
    desc_p = cpu_fe.describe(aux_p, yx)
    if fe.is_binary:
        err = sum(int(brief.popcount32(a ^ b).sum())
                  for a, b in zip(desc, desc_p))
        check(failures, err == 0 and desc.dtype == torch.int32,
              f"{tag}: {len(yx)} {fe.desc_kind} descriptors bit-identical "
              f"({err} bits differ)")
    else:
        scale = desc_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        err = float(((desc - desc_p).abs() / scale).max())
        check(failures, err <= FLOAT_DESC_REL and desc.dtype == torch.float32,
              f"{tag}: {len(yx)} {fe.desc_kind} float descriptors within "
              f"{FLOAT_DESC_REL} relative ({err:.3e})")
    return dict(keypoints=int(len(yx)), desc_err=err,
                peaks=int((aux_p["score_nms"] > 0).sum()))


def live_syncs(failures, tag: str, runtime: SlamRuntime, st0,
               gpu_frames) -> dict:
    """The host syncs of scan_frames over ``gpu_frames[1:]`` from ``st0``
    under sync debug mode, by site: at most LIVE_SYNCS_PER_FRAME a frame,
    all at the read of phase_mapman."""
    S = len(gpu_frames) - 1
    sites, sync_s = count_syncs(
        lambda: scan_runner.scan_frames(runtime, st0, gpu_frames[1:]))
    syncs = sum(sites.values())
    allowed = {source_line(step_mod, ".tolist()")}
    print(f"  {tag}: sync debug run {S / sync_s:.2f} steps/s, {syncs} host "
          f"syncs ({syncs / S:.3f} a frame): {dict(sites)}", flush=True)
    check(failures, syncs / S <= LIVE_SYNCS_PER_FRAME
          and set(sites) <= allowed,
          f"{tag}: host syncs a frame {syncs / S:.3f} <= "
          f"{LIVE_SYNCS_PER_FRAME}, all at {sorted(allowed)}")
    return dict(syncs=syncs, syncs_per_frame=syncs / S,
                sync_sites=dict(sites), fps_sync_debug=S / sync_s)


def run_profile(failures, det: str, desc: str, frames: np.ndarray,
                full: bool) -> dict:
    """One profile on the card through run_sequence_on_device, with every
    launch counter set to 0 just before and read just after, and the
    host-sync count; ``full`` adds a second timed run (the default
    path)."""
    tag = f"{det}/{desc}"
    t_start = time.perf_counter()
    cfg = profile_config(det, desc)
    runtime = SlamRuntime(cfg)
    T = len(frames)
    S = T - 1
    print(f"  -- {tag}: {frames.shape[2]}x{frames.shape[1]}, {T} frames, "
          f"F = {cfg.max_features}, N = {cfg.padded_state_dim}, "
          f"{cfg.dtype}", flush=True)
    scan_runner.run_sequence_on_device(
        runtime, frames[:21 if full else PROFILE_WARM])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, recs = scan_runner.run_sequence_on_device(runtime, frames)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    out = dict(fps=T / elapsed, elapsed_s=elapsed, launches=launches,
               frames=T)
    print(f"  {tag}: run_sequence_on_device {T / elapsed:.2f} frames/s "
          f"({elapsed:.4f} s); launches {launches}", flush=True)
    check_graph(failures, tag, runtime)
    brief_n = T if desc == "BRIEF" else 0
    check(failures, launches["brief"] == brief_n
          and launches["brief_generic"] == 0,
          f"{tag}: BRIEF kernel (s256) launched {launches['brief']} times "
          f"({brief_n}: once a frame with BRIEF, never without)")
    check(failures, launches["star"] == launches["star_direct"] == 0,
          f"{tag}: no STAR launch")
    check(failures, launches["predict"] == S
          and launches["measure"] == 2 * S and launches["update"] == 2 * S
          and launches["ransac_support"] == S
          and launches["measure_quirks"] == launches["sinv"] == 0,
          f"{tag}: predict {S}, measure {2 * S}, fused update {2 * S}, "
          f"ransac_support {S}")
    check(failures, 1 <= launches["init"] == launches["init_augment"] <= T,
          f"{tag}: each addition launches (A) and (B) once "
          f"({launches['init']})")
    check(failures, bool(torch.isfinite(state.x).all())
          and bool(torch.isfinite(state.P).all()), f"{tag}: final x, P "
          "finite")
    matched = recs.total_matches.astype(np.int64)
    inl = (recs.li_inliers + recs.hi_inliers).astype(np.int64)
    healthy = float(np.mean(inl >= 0.5 * matched))
    check(failures, healthy >= 0.9 and matched.mean() >= 20,
          f"{tag}: tracking healthy on {healthy:.3f} of frames (>= 0.9), "
          f"mean matched {matched.mean():.1f} (>= 20), mean inliers "
          f"{inl.mean():.1f}, {int(recs.new_ok.sum())} features added")
    out.update(healthy=healthy, mean_matched=float(matched.mean()),
               mean_inliers=float(inl.mean()))

    gpu_frames = runtime._tensor(frames)
    st0 = runtime.init_step(runtime.make_initial_state(), gpu_frames[0])
    torch.cuda.synchronize()
    if full:
        t0 = time.perf_counter()
        scan_runner.run_sequence_on_device(runtime, frames)
        torch.cuda.synchronize()
        out["fps_again"] = T / (time.perf_counter() - t0)
        print(f"  {tag}: again {out['fps_again']:.2f} frames/s", flush=True)
    out.update(live_syncs(failures, tag, runtime, st0, gpu_frames))

    # per-phase ms and the front end's chains under the profiler
    n_prof = min(S, DEFAULT_PROFILED if full else PROFILE_PROFILED)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, chain_ranges(PROFILE_CHAINS):
        scan_runner.scan_frames(runtime, st0, gpu_frames[1:1 + n_prof])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    phase_ms = phase_times(averages, n_prof, LIVE_PHASE_PREFIX)
    kern = kernel_device_us(averages, n_prof, LIVE_KERNEL_NAMES)
    dev_ms = device_ms(averages, n_prof)
    chains = {k: v for k, v in chain_device(
        prof.events(), n_prof, tuple(PROFILE_CHAINS)).items()
        if v["calls"] > 0}
    print(f"  {tag} under the profiler ({n_prof} steps), ms a frame (host, "
          "device of PyTorch's kernels): " + ", ".join(
              f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
              for k, v in phase_ms.items()), flush=True)
    print_device(dev_ms, kern)
    print(f"  {tag} front-end chains, a frame: " + "; ".join(
        f"{k} {v['device_us']:.2f} device us in {v['launches']:.2f} device "
        f"launches ({v['calls']:.2f} calls, host {v['host_us']:.1f} us)"
        for k, v in chains.items()), flush=True)
    out.update(phase_ms=phase_ms, kernels_us=kern, device_ms=dev_ms,
               chains=chains, profiled_steps=n_prof)

    out["first_frame"] = check_profile_frame(failures, tag, runtime,
                                             gpu_frames[0])

    # the live log, replayed on the CPU in float64
    log = replay.record_live_log(runtime, gpu_frames)
    card = log["records"]
    rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                       device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, log)
    cpu_s = time.perf_counter() - t0
    agree = against_float64(card.x_cam, card.inliers, card.visible, recs64)
    print(f"  {tag}: float64 CPU replay of the live log {cpu_s:.1f} s: "
          f"deviation max {agree['dev_max']:.3e} (frame "
          f"{agree['worst_frame']}), final {agree['dev_final']:.3e}; inlier "
          f"masks identical on {agree['inliers_same']:.3f} of frames, "
          f"visibility on {agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL,
          f"{tag}: live replay deviation <= {LIVE_REPLAY_TOL} on every "
          f"frame (worst {agree['dev_max']:.3e})")
    check(failures, agree["inliers_same"] >= LIVE_MASKS_SAME
          and agree["visible_same"] >= LIVE_MASKS_SAME,
          f"{tag}: live replay masks identical on >= {LIVE_MASKS_SAME} of "
          "frames")
    out["replay"] = dict(cpu_s=cpu_s, **agree)
    out["seconds"] = time.perf_counter() - t_start
    print(f"  {tag}: {out['seconds']:.1f} s", flush=True)
    return out


def phase_profiles(failures: list) -> dict:
    """SlamConfig() (FAST + BRIEF-256) over phase 5's frames, then every
    other profile over the first T_PROFILE of them."""
    print("== phase 8: profiles", flush=True)
    frames = live_frames(T_LIVE)
    out = {"FAST/BRIEF": run_profile(failures, "FAST", "BRIEF", frames,
                                     full=True)}
    for det, desc in PROFILE_PAIRS:
        out[f"{det}/{desc}"] = run_profile(failures, det, desc,
                                           frames[:T_PROFILE], full=False)
    return out


# ----------------------------------------------------------------- phase 9

T_NCC = 101               # frames of the NCC cell: init_step + 100 steps
NCC_PROFILED = 20         # its steps under the profiler
# the NCC chain's functions, each a profiler range (extract_patches_bilinear
# runs inside ncc_match and counts in both)
NCC_CHAINS = {"ncc.warp_templates": (ncc_mod, "warp_templates"),
              "ncc.ncc_match": (ncc_mod, "ncc_match"),
              "ncc.extract_patches_bilinear": (ncc_mod,
                                               "extract_patches_bilinear")}
# the card's ncc_match against the same functions' plain float32 run on
# the CPU: the matched pixels (px) and the stored templates
NCC_Z_TOL = 1e-3
NCC_DESC_TOL = 1e-5


def ncc_config() -> SlamConfig:
    """SlamConfig(matcher="ncc") with PATCH descriptors at their defaults:
    F = 96, patch radius 7, search radius 10, the warp on, FAST for the
    additions."""
    return SlamConfig(matcher="ncc", descriptor=DescriptorConfig(kind="PATCH"))


def to_cpu(t):
    """A named tuple of tensors (SlamState, Prediction) on the CPU."""
    return type(t)(*(f.cpu() for f in t))


def check_ncc_frame(failures, tag: str, runtime: SlamRuntime, state,
                    gray) -> dict:
    """warp_templates and ncc_match on one frame's own inputs on the card
    against the same port functions' plain float32 run on the CPU."""
    state, pred = runtime.phase_predict(state)
    aux = runtime.frontend.precompute(gray)
    m = runtime.match_ncc(state, pred, aux)
    cpu = SlamRuntime(runtime.config, device="cpu")
    st_c, pred_c = to_cpu(state), to_cpu(pred)
    aux_c = cpu.frontend.precompute(gray.cpu())
    m_c = cpu.match_ncc(st_c, pred_c, aux_c)
    same_m = torch.equal(m.matched.cpu(), m_c.matched)
    same_r = torch.equal(m.refreshed.cpu(), m_c.refreshed)
    z_err = max_abs(m.z.cpu(), m_c.z)
    d_err = max_abs(m.desc.cpu(), m_c.desc)
    smooth_same = torch.equal(aux["smoothed"].cpu(), aux_c["smoothed"])
    print(f"  {tag}: {int(m.matched.sum())} matched of "
          f"{int(pred.visible.sum())} visible, {int(m.refreshed.sum())} "
          f"refreshed; card vs CPU: matched {same_m}, refreshed {same_r}, "
          f"z {z_err:.3e} px, desc {d_err:.3e}, smoothed image identical "
          f"{smooth_same}", flush=True)
    check(failures, same_m and same_r,
          f"{tag}: matched and refreshed identical to the CPU's")
    check(failures, z_err <= NCC_Z_TOL and d_err <= NCC_DESC_TOL,
          f"{tag}: z within {NCC_Z_TOL} px ({z_err:.3e}), desc within "
          f"{NCC_DESC_TOL} ({d_err:.3e})")
    return dict(matched=int(m.matched.sum()),
                refreshed=int(m.refreshed.sum()), z_err=z_err,
                desc_err=d_err, smoothed_identical=smooth_same)


def phase_ncc(failures: list, T: int = T_NCC) -> dict:
    """The NCC matcher live: SlamConfig(matcher="ncc", PATCH) over the first
    T of phase 5's frames."""
    print("== phase 9: ncc live", flush=True)
    t_start = time.perf_counter()
    cfg = ncc_config()
    runtime = SlamRuntime(cfg)
    frames = live_frames(T_LIVE)[:T]
    S = T - 1
    print(f"  SlamConfig(matcher=ncc, PATCH): patch radius "
          f"{cfg.descriptor.patch_radius}, search radius "
          f"{cfg.ncc_search_radius}, warp {cfg.ncc_warp}, min corr "
          f"{cfg.ncc_min_corr}, refresh below {cfg.ncc_refresh_below}, "
          f"detector {cfg.detector.kind}; F = {cfg.max_features}, "
          f"{cfg.dtype}, {frames.shape[2]}x{frames.shape[1]}, {T} frames",
          flush=True)
    scan_runner.run_sequence_on_device(runtime, frames[:21])    # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, recs = scan_runner.run_sequence_on_device(runtime, frames)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    fps = T / elapsed
    print(f"  main path: run_sequence_on_device over {T} frames in "
          f"{elapsed:.4f} s = {fps:.2f} frames/s; launches {launches}",
          flush=True)
    check_graph(failures, "ncc", runtime)
    check(failures, launches["predict"] == S and launches["measure"] == 2 * S
          and launches["update"] == 2 * S
          and launches["ransac_support"] == S,
          f"predict {S}, measure {2 * S}, fused update {2 * S}, "
          f"ransac_support {S}")
    check(failures, launches["brief"] == launches["star"] == 0
          and launches["brief_generic"] == launches["star_direct"] == 0,
          "no STAR or BRIEF launch (FAST detector, PATCH descriptors)")
    check(failures, launches["measure_quirks"] == launches["sinv"] == 0,
          "no quirks measure, no S-inverse")
    check(failures, 1 <= launches["init"] == launches["init_augment"] <= T,
          f"each addition launches (A) and (B) once ({launches['init']})")
    check(failures, bool(torch.isfinite(state.x).all())
          and bool(torch.isfinite(state.P).all()), "final x and P finite")
    matched = recs.total_matches.astype(np.int64)
    inl = (recs.li_inliers + recs.hi_inliers).astype(np.int64)
    healthy = float(np.mean(inl >= 0.5 * matched))
    check(failures, healthy >= 0.9 and matched.mean() >= 20,
          f"tracking healthy on {healthy:.3f} of frames (>= 0.9): mean "
          f"matched {matched.mean():.1f} (>= 20), mean inliers "
          f"{inl.mean():.1f}, {int(recs.new_ok.sum())} features added")
    out = dict(launches=launches, fps=fps, elapsed_s=elapsed, frames=T,
               healthy=healthy, mean_matched=float(matched.mean()),
               mean_inliers=float(inl.mean()),
               added=int(recs.new_ok.sum()))

    gpu_frames = runtime._tensor(frames)
    st0 = runtime.init_step(runtime.make_initial_state(), gpu_frames[0])
    torch.cuda.synchronize()
    out.update(live_syncs(failures, "ncc", runtime, st0, gpu_frames))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof, chain_ranges(NCC_CHAINS):
        scan_runner.scan_frames(runtime, st0,
                                gpu_frames[1:1 + NCC_PROFILED])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    phase_ms = phase_times(averages, NCC_PROFILED, LIVE_PHASE_PREFIX)
    dev_ms = device_ms(averages, NCC_PROFILED)
    chains = chain_device(prof.events(), NCC_PROFILED, tuple(NCC_CHAINS))
    print(f"  ncc under the profiler ({NCC_PROFILED} steps), ms a frame "
          "(host, device of PyTorch's kernels): " + ", ".join(
              f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
              for k, v in phase_ms.items()), flush=True)
    print_device(dev_ms, kernel_device_us(averages, NCC_PROFILED,
                                          UPDATE_KERNEL_NAMES))
    print("  NCC chains, a frame: " + "; ".join(
        f"{k} {v['device_us']:.2f} device us in {v['launches']:.2f} device "
        f"launches ({v['calls']:.2f} calls, host {v['host_us']:.1f} us)"
        for k, v in chains.items()), flush=True)
    out.update(phase_ms=phase_ms, device_ms=dev_ms, chains=chains,
               profiled_steps=NCC_PROFILED)

    # ncc_match with warp_templates on frame T/2's own inputs
    mid, _ = scan_runner.scan_frames(runtime, st0, gpu_frames[1:T // 2])
    out["mid_frame"] = check_ncc_frame(failures, f"frame {T // 2}", runtime,
                                       mid, gpu_frames[T // 2])

    # the live log, replayed on the CPU in float64
    log = replay.record_live_log(runtime, gpu_frames)
    card = log["records"]
    rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                       device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, log)
    cpu_s = time.perf_counter() - t0
    agree = against_float64(card.x_cam, card.inliers, card.visible, recs64)
    print(f"  ncc: float64 CPU replay of the live log {cpu_s:.1f} s: "
          f"deviation max {agree['dev_max']:.3e} (frame "
          f"{agree['worst_frame']}), final {agree['dev_final']:.3e}; inlier "
          f"masks identical on {agree['inliers_same']:.3f} of frames, "
          f"visibility on {agree['visible_same']:.3f}", flush=True)
    check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL,
          f"ncc: live replay deviation <= {LIVE_REPLAY_TOL} on every frame "
          f"(worst {agree['dev_max']:.3e})")
    check(failures, agree["inliers_same"] >= LIVE_MASKS_SAME
          and agree["visible_same"] >= LIVE_MASKS_SAME,
          f"ncc: live replay masks identical on >= {LIVE_MASKS_SAME} of "
          "frames")
    out["replay"] = dict(cpu_s=cpu_s, **agree)
    out["seconds"] = time.perf_counter() - t_start
    print(f"  ncc: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 10

LOOP_FORWARD = 46         # tests/test_loop_closure.py's scenario: forward,
LOOP_BLACK = 8            # black frames, then the forward frames reversed
LOOP_KEYFRAME_EVERY = 6
LOOP_RELOCALIZE_AFTER = 3
LOOP_ITERATIONS = 40      # corrected_trajectory's Gauss-Newton steps
LOOP_NODE_TOL = 1e-4      # the card's optimised graph vs float64 on the CPU
LOOP_SYNCS_PER_FRAME = 2.0  # frames without a keyframe: the engine's two


def loop_frames() -> list:
    fwd = list(live_frames(T_LIVE)[:LOOP_FORWARD])
    return fwd + [np.zeros_like(fwd[0])] * LOOP_BLACK + fwd[::-1][1:]


def loop_engine(cfg: SlamConfig) -> SlamEngine:
    return SlamEngine(cfg, keyframe_every=LOOP_KEYFRAME_EVERY,
                      relocalize_after=LOOP_RELOCALIZE_AFTER)


def syncs_by_frame(engine: SlamEngine, seq) -> tuple[list, float]:
    """init + step over ``seq`` under sync debug mode: the host syncs of
    each frame (index 0 is init) with their sites, and the seconds."""
    per_frame: list = [collections.Counter()]

    def on_warning(message, category, filename, lineno, *rest):
        if "synchronizing CUDA operation" in str(message):
            per_frame[-1][f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            engine.init(seq[0])
            for f in seq[1:]:
                per_frame.append(collections.Counter())
                engine.step(f)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return per_frame, seconds


def graph_to(graph, device, dtype):
    return graph._replace(**{f: getattr(graph, f).to(device=device,
                                                     dtype=dtype)
                             for f in ("node_r", "node_q", "edge_dr",
                                       "edge_dq", "edge_info")},
                          **{f: getattr(graph, f).to(device)
                             for f in ("node_active", "n_nodes", "edge_ij",
                                       "edge_active", "n_edges")})


def phase_loop(live_cfg: SlamConfig, failures: list) -> dict:
    """SlamEngine with the s3 profile and the pose graph over the
    loop-closure scenario on phase 5's texture."""
    print("== phase 10: loop closure", flush=True)
    t_start = time.perf_counter()
    seq = loop_frames()
    T = len(seq)
    S = T - 1
    print(f"  SlamEngine(s3 profile, keyframe_every={LOOP_KEYFRAME_EVERY}, "
          f"relocalize_after={LOOP_RELOCALIZE_AFTER}): {LOOP_FORWARD} frames "
          f"forward, {LOOP_BLACK} black, {LOOP_FORWARD - 1} back; "
          f"{seq[0].shape[1]}x{seq[0].shape[0]}, {T} frames", flush=True)
    run_sequence(loop_engine(live_cfg), seq[:13])                # warm-up
    torch.cuda.synchronize()
    engine = loop_engine(live_cfg)
    reset_launches()
    t0 = time.perf_counter()
    run_sequence(engine, seq)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    fps = T / elapsed
    closures = engine.loop_closer.closures
    check_graph(failures, "loop closure", engine.runtime)
    print(f"  run_sequence over {T} frames in {elapsed:.4f} s = {fps:.2f} "
          f"frames/s; {engine.relocalizations} relocalizations, keyframes at "
          f"{engine.keyframe_frames}; closures (i, j, matches, rms px): "
          + str([(c["i"], c["j"], c["matches"], round(c["rms_px"], 3))
                 for c in closures]), flush=True)
    print(f"  launches {launches}", flush=True)
    check(failures, launches["predict"] == S and launches["measure"] == 2 * S
          and launches["update"] == 2 * S
          and launches["ransac_support"] == S,
          f"predict {S}, measure {2 * S}, fused update {2 * S}, "
          f"ransac_support {S}")
    # STAR and BRIEF: a frame each, once more for each bootstrap and for
    # each keyframe that looks for a closure (LoopCloser._signature)
    check(failures, launches["star"] == launches["brief"] >= T,
          f"STAR and BRIEF launched together, at least once a frame "
          f"({launches['star']}, {launches['brief']})")
    check(failures, engine.relocalizations >= 1,
          f"relocalized ({engine.relocalizations})")
    check(failures, len(closures) >= 1,
          f"at least one loop closure accepted ({len(closures)})")

    raw = np.asarray([r["position"] for r in engine.records])
    raw_graph = engine.pose_graph
    k = int(raw_graph.n_nodes)
    corrected = engine.corrected_trajectory(LOOP_ITERATIONS)
    raw_err = float(np.linalg.norm(raw[-1] - raw[0]))
    corr_err = float(np.linalg.norm(corrected[-1] - corrected[0]))
    check(failures, corr_err < 0.8 * raw_err,
          f"endpoint error corrected {corr_err:.4f} m < 0.8 x raw "
          f"{raw_err:.4f} m")
    cpu64 = graph_mod.optimize(graph_to(raw_graph, "cpu", torch.float64),
                               LOOP_ITERATIONS)
    node_err = float(np.abs(engine.pose_graph.node_r[:k].cpu().double()
                            .numpy() - cpu64.node_r[:k].numpy()).max())
    check(failures, node_err <= LOOP_NODE_TOL,
          f"the card's optimised graph ({k} nodes, "
          f"{int(raw_graph.n_edges)} edges) against the same graph "
          f"optimised on the CPU in float64: {node_err:.3e} m <= "
          f"{LOOP_NODE_TOL}")

    # optimize's device time (40 steps) and its launches
    opt_ms = events_ms(lambda: graph_mod.optimize(raw_graph,
                                                  LOOP_ITERATIONS), reps=2,
                       warm=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph_mod.optimize(raw_graph, LOOP_ITERATIONS)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    opt_dev_ms = device_ms(averages, 1)
    opt_launches = sum(e.count for e in averages
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  optimize ({LOOP_ITERATIONS} steps, capacity "
          f"{raw_graph.capacity}): {opt_ms:.3f} ms on the device timeline, "
          f"{opt_dev_ms:.3f} ms in {opt_launches} device launches",
          flush=True)

    # a pose-graph checkpoint round trip through the engine
    OUT.mkdir(exist_ok=True)
    ckpt = str(OUT / "loop_checkpoint.npz")
    engine.save_checkpoint(ckpt)
    resumed = loop_engine(live_cfg)
    resumed.resume(ckpt)
    same = all(torch.equal(getattr(resumed.pose_graph, f),
                           getattr(engine.pose_graph, f))
               for f in engine.pose_graph._fields)
    check(failures, same, "the pose-graph checkpoint resumes bit for bit")

    # host syncs by frame: keyframe frames against the others
    per_frame, sync_s = syncs_by_frame(loop_engine(live_cfg), seq)
    kf_frames = set(engine.keyframe_frames)
    on_kf = [sum(c.values()) for i, c in enumerate(per_frame)
             if i in kf_frames]
    off_kf = [sum(c.values()) for i, c in enumerate(per_frame)
              if i and i not in kf_frames]
    kf_sites = sum((c for i, c in enumerate(per_frame) if i in kf_frames),
                   collections.Counter())
    off_sites = sum((c for i, c in enumerate(per_frame)
                     if i and i not in kf_frames), collections.Counter())
    print(f"  sync debug run {S / sync_s:.2f} frames/s: {len(on_kf)} "
          f"keyframe frames, {np.mean(on_kf):.2f} syncs each (at most "
          f"{max(on_kf)}): {dict(kf_sites)}; the other {len(off_kf)} "
          f"frames {np.mean(off_kf):.2f} each (at most {max(off_kf)}): "
          f"{dict(off_sites)}", flush=True)
    check(failures, max(off_kf) <= LOOP_SYNCS_PER_FRAME,
          f"frames without a keyframe: at most {LOOP_SYNCS_PER_FRAME} host "
          f"syncs ({max(off_kf)})")
    out = dict(fps=fps, elapsed_s=elapsed, frames=T, launches=launches,
               relocalizations=engine.relocalizations,
               keyframe_frames=engine.keyframe_frames,
               closures=[{k_: c[k_] for k_ in ("i", "j", "matches",
                                               "rms_px", "frame_i",
                                               "frame_j")}
                         for c in closures],
               raw_endpoint_err=raw_err, corrected_endpoint_err=corr_err,
               node_err_vs_cpu64=node_err, optimize_ms=opt_ms,
               optimize_device_ms=opt_dev_ms, optimize_launches=opt_launches,
               syncs_keyframe_frames=float(np.mean(on_kf)),
               syncs_other_frames=float(np.mean(off_kf)),
               sync_sites_keyframe=dict(kf_sites),
               sync_sites_other=dict(off_sites),
               fps_sync_debug=S / sync_s)
    out["seconds"] = time.perf_counter() - t_start
    print(f"  loop closure: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------- phase 11

SERVE_FRAMES = 21         # init + 20 steps through the socket


class EkfPose(ctypes.Structure):
    """native/ekf_client.h's ekf_pose."""
    _fields_ = [("r", ctypes.c_double * 3), ("q", ctypes.c_double * 4),
                ("v", ctypes.c_double * 3), ("matches", ctypes.c_uint32),
                ("li_inliers", ctypes.c_uint32),
                ("hi_inliers", ctypes.c_uint32),
                ("map_size", ctypes.c_uint32)]


def client_library():
    """native/ekf_client.c compiled with gcc into build/torch_kernels/ and
    loaded by ctypes, as a host application links it."""
    so = ROOT / "build" / "torch_kernels" / "libekfclient.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-std=gnu11",
                    str(ROOT / "native" / "ekf_client.c"), "-o", str(so)],
                   check=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.ekf_connect.restype = ctypes.c_void_p
    lib.ekf_connect.argtypes = [ctypes.c_char_p]
    lib.ekf_create.restype = ctypes.c_int64
    lib.ekf_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ekf_init.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_char_p, ctypes.c_uint32,
                             ctypes.c_uint32]
    lib.ekf_step.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                             ctypes.c_char_p, ctypes.c_uint32,
                             ctypes.c_uint32, ctypes.POINTER(EkfPose)]
    lib.ekf_state.restype = ctypes.c_int64
    lib.ekf_state.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.c_size_t]
    lib.ekf_release.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ekf_last_error.restype = ctypes.c_char_p
    lib.ekf_last_error.argtypes = [ctypes.c_void_p]
    lib.ekf_disconnect.argtypes = [ctypes.c_void_p]
    return lib


def serve_session(failures, lib, client, frames, tag: str) -> tuple:
    """A session over ``frames`` through the C client: the served poses
    (r, q, v, matches, map size) a frame and the seconds of the steps."""
    sid = lib.ekf_create(client, b"")
    check(failures, sid > 0, f"{tag}: session created ({sid})")
    h, w = frames[0].shape
    rc = lib.ekf_init(client, sid, frames[0].tobytes(), h, w)
    check(failures, rc == 0, f"{tag}: init ({rc})")
    pose, served = EkfPose(), []
    t0 = time.perf_counter()
    for f in frames[1:]:
        rc = lib.ekf_step(client, sid, f.tobytes(), h, w, ctypes.byref(pose))
        if rc:
            check(failures, False, f"{tag}: step ({rc}, "
                  f"{lib.ekf_last_error(client)})")
            break
        served.append(list(pose.r) + list(pose.q) + list(pose.v)
                      + [pose.matches, pose.map_size])
    seconds = time.perf_counter() - t0
    lib.ekf_release(client, sid)
    return np.asarray(served), seconds


def phase_serve(failures: list) -> dict:
    """SlamServer on the card in a thread on a unix socket, driven by the C
    client; its poses against an in-process SlamEngine's."""
    print("== phase 11: serve", flush=True)
    t_start = time.perf_counter()
    frames = list(live_frames(T_LIVE)[:SERVE_FRAMES])
    lib = client_library()
    cfg = SlamConfig()
    OUT.mkdir(exist_ok=True)
    sock = str(OUT / "ekf.sock")
    server = server_mod.SlamServer(cfg)
    ready = threading.Event()
    thread = threading.Thread(target=server.serve, args=(sock, ready),
                              daemon=True)
    thread.start()
    check(failures, ready.wait(30), "the daemon listens")
    print(f"  SlamServer(SlamConfig()) on {server.device}, {sock}; "
          f"{len(frames)} frames a session", flush=True)
    client = lib.ekf_connect(sock.encode())
    check(failures, bool(client), "the C client connects")
    serve_session(failures, lib, client, frames[:4], "warm-up")
    served, serve_s = serve_session(failures, lib, client, frames,
                                    "session 1")

    engine = SlamEngine(cfg)
    run_sequence(SlamEngine(cfg), frames[:4])                   # warm-up
    engine.init(frames[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [r["position"] + r["orientation"] + r["linear_velocity"]
            + [r["total_matches"], r["n_active"]]
            for r in (engine.step(f) for f in frames[1:])]
    local_s = time.perf_counter() - t0
    check_graph(failures, "the in-process engine", engine.runtime)
    want = np.asarray(want)
    same = served.shape == want.shape and served.tobytes() == want.tobytes()
    gap = (float(np.abs(served - want).max())
           if served.shape == want.shape else float("nan"))
    check(failures, same, f"the served poses equal the in-process "
          f"engine's bit for bit ({len(served)} steps, max gap {gap:.3e})")

    other, _ = serve_session(failures, lib, client, frames[2:8],
                             "session 2")
    check(failures, len(other) == 5 and bool(np.isfinite(other).all())
          and not np.array_equal(other[:, :3], served[:5, :3]),
          "a second session runs on its own (finite poses of its own)")

    pose = EkfPose()
    rc = lib.ekf_step(client, 9999, b"\0" * 16, 4, 4, ctypes.byref(pose))
    err = lib.ekf_last_error(client)
    sid = lib.ekf_create(client, b"")
    rc_bad = lib.ekf_init(client, sid, b"\0" * 16, 4, 4)
    err_bad = lib.ekf_last_error(client)
    h, w = frames[0].shape
    rc_after = lib.ekf_init(client, sid, frames[0].tobytes(), h, w)
    lib.ekf_release(client, sid)
    check(failures, rc == -3 and b"9999" in err and rc_bad == -3
          and b"frame payload" in err_bad and rc_after == 0
          and thread.is_alive(),
          f"a bad session and a bad frame return errors ({err!r}, "
          f"{err_bad!r}) and the daemon keeps serving")
    lib.ekf_disconnect(client)
    server.shutdown()
    thread.join(30)
    check(failures, not thread.is_alive(), "the daemon shuts down")
    Path(sock).unlink(missing_ok=True)
    steps = len(frames) - 1
    out = dict(frames=len(frames), served_identical=same, max_gap=gap,
               ms_per_frame_socket=serve_s / steps * 1e3,
               ms_per_frame_in_process=local_s / steps * 1e3)
    print(f"  ms a step: {out['ms_per_frame_socket']:.3f} through the "
          f"socket, {out['ms_per_frame_in_process']:.3f} in process",
          flush=True)
    out["seconds"] = time.perf_counter() - t_start
    print(f"  serve: {out['seconds']:.1f} s", flush=True)
    return out


def phase_engine_features(live_cfg: SlamConfig) -> dict:
    """Phases 9-11: the NCC matcher, the pose graph with loop closure, and
    the serving daemon."""
    out = {}
    for name, fn in (("ncc", lambda f: phase_ncc(f)),
                     ("loop closure", lambda f: phase_loop(live_cfg, f)),
                     ("serve", phase_serve)):
        failures: list = []
        out[name] = fn(failures)
        end_phase(name, failures)
    return out


# ---------------------------------------------------------------- phase 12

T_BATCH = 101                 # frames of phase 12's main run: init + 100
BATCH_SWEEP = (1, 4, 8, 16)   # streams of the frames/s sweep
SWEEP_WARM, SWEEP_TIMED = 5, 21
BATCH_PROFILED = 10           # batched frames under the profiler
BATCH_REPLAYED = (0, BATCH - 1)   # streams whose live logs replay in f64
# each kernel's launches a frame on the s3 live path, at any B
PER_FRAME = {"predict": 1, "measure": 2, "update": 2, "star": 1, "brief": 1,
             "ransac_support": 1}


def batch_frames(B: int, T: int, hw=LIVE_HW) -> np.ndarray:
    """(B, T, H, W) uint8: stream b slides 1 + b % 3 px a frame over its
    own blob texture (seed 5 + b), so the streams add features on
    different frames."""
    return np.stack([live_frames(T, hw, seed=5 + b, step=1 + b % 3)
                     for b in range(B)])


def to_numpy(recs) -> step_mod.StepRecord:
    return step_mod.StepRecord(*(f.cpu().numpy() for f in recs))


def stream_log(uv0, ok0, slot0, recs, b: int) -> dict:
    """Stream b's injection log (eval/replay.py's format) from the batched
    init's bootstrap features and the batched records (T, B, ...)."""
    log = {"init": [(uv0[b][i], int(slot0[b][i]))
                    for i in range(ok0.shape[1]) if ok0[b][i]],
           "frames": []}
    for t in range(recs.z.shape[0]):
        log["frames"].append({
            "z": recs.z[t, b].astype(np.float64),
            "matched": recs.matched[t, b].copy(),
            "new": [(recs.new_uv[t, b, c], int(recs.new_slot[t, b, c]))
                    for c in range(recs.new_ok.shape[2])
                    if recs.new_ok[t, b, c]]})
    return log


def check_batch_launches(failures, tag: str, launches: dict, steps: int,
                         inits: int) -> None:
    """Each kernel of the s3 live path launched PER_FRAME times a batched
    step (plus once for each of ``inits`` batched inits, STAR and BRIEF),
    and nothing else; init (A) and (B) together, at most once a frame."""
    want = {k: v * steps + (inits if k in ("star", "brief") else 0)
            for k, v in PER_FRAME.items()}
    check(failures, all(launches[k] == v for k, v in want.items()),
          f"{tag}: launches {want} (a batched frame: {PER_FRAME})")
    others = ("measure_quirks", "star_direct", "brief_generic", "sinv",
              "cholsolve")
    check(failures, all(launches[k] == 0 for k in others)
          and launches["init"] == launches["init_augment"]
          and launches["init"] <= steps + inits,
          f"{tag}: init {launches['init']} = init_augment "
          f"{launches['init_augment']} <= {steps + inits}, none of {others}")


def batch_sweep(failures, runtime: SlamRuntime) -> dict:
    """Aggregate stream-frames/s of batched_step at each of BATCH_SWEEP
    over SWEEP_TIMED frames after SWEEP_WARM, twice (the sweep up, then
    down), beside the single-stream step over stream 0's same frames
    (before and after), and the launches a batched frame at each B."""
    T = 1 + SWEEP_WARM + SWEEP_TIMED
    gpu = runtime._tensor(batch_frames(max(BATCH_SWEEP), T))
    sync = torch.cuda.synchronize

    def single() -> float:
        st = runtime.init_step(runtime.make_initial_state(), gpu[0, 0])
        st, _ = scan_runner.scan_frames(runtime, st, gpu[0, 1:1 + SWEEP_WARM])
        sync()
        t0 = time.perf_counter()
        scan_runner.scan_frames(runtime, st, gpu[0, 1 + SWEEP_WARM:])
        sync()
        return SWEEP_TIMED / (time.perf_counter() - t0)

    out = {"single_fps_before": single()}
    for B in BATCH_SWEEP + BATCH_SWEEP[::-1]:
        st = batch_runner.make_batch_states(runtime, B, seeds=range(B))
        st = batch_runner.make_batched_init(runtime)(st, gpu[:B, 0])
        st, _ = batch_runner.scan_batched_sequences(
            runtime, st, gpu[:B, 1:1 + SWEEP_WARM])
        sync()
        reset_launches()
        t0 = time.perf_counter()
        batch_runner.scan_batched_sequences(runtime, st,
                                            gpu[:B, 1 + SWEEP_WARM:])
        sync()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        check_batch_launches(failures, f"sweep B = {B}", launches,
                             SWEEP_TIMED, 0)
        row = out.setdefault(B, dict(stream_fps_runs=[], launches_per_frame={
            k: v / SWEEP_TIMED for k, v in launches.items() if v}))
        row["stream_fps_runs"].append(B * SWEEP_TIMED / seconds)
    out["single_fps_after"] = single()
    single_fps = 0.5 * (out["single_fps_before"] + out["single_fps_after"])
    for B in BATCH_SWEEP:
        row = out[B]
        row["stream_fps"] = float(np.mean(row["stream_fps_runs"]))
        row["x_single"] = row["stream_fps"] / single_fps
    print(f"  frames/s over {SWEEP_TIMED} frames after {SWEEP_WARM}: single"
          f"-stream step {out['single_fps_before']:.2f} (before), "
          f"{out['single_fps_after']:.2f} (after); "
          + "; ".join(f"B = {B}: " + ", ".join(
              f"{v:.2f}" for v in out[B]["stream_fps_runs"])
              + f" stream-frames/s ({out[B]['x_single']:.2f}x the single "
              "stream)" for B in BATCH_SWEEP), flush=True)
    return out


def phase_batch(cfg: SlamConfig, failures: list) -> dict:
    print("== phase 12: batch", flush=True)
    runtime = SlamRuntime(cfg)
    S = T_BATCH - 1
    gpu = runtime._tensor(batch_frames(BATCH, T_BATCH))
    print(f"  {BATCH} streams of {T_BATCH} frames at {LIVE_HW[1]}x"
          f"{LIVE_HW[0]}, stream b sliding 1 + b % 3 px a frame over its own"
          f" texture; {cfg.detector.kind} + {cfg.descriptor.kind}-"
          f"{cfg.descriptor.n_bits}, F = {cfg.max_features}", flush=True)

    # warm-up off the clock: first calls, the custom ops' registration
    st = batch_runner.make_batch_states(runtime, BATCH)
    st = batch_runner.make_batched_init(runtime)(st, gpu[:, 0])
    batch_runner.scan_batched_sequences(runtime, st, gpu[:, 1:6])
    torch.cuda.synchronize()

    # the main path: every launch counter at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    states = batch_runner.make_batch_states(runtime, BATCH,
                                            seeds=range(BATCH))
    states, uv0, ok0, slot0 = batch_runner.batched_init_recorded(
        runtime, states, gpu[:, 0])
    states, recs = batch_runner.scan_batched_sequences(runtime, states,
                                                       gpu[:, 1:])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    recs = to_numpy(recs)
    uv0, ok0, slot0 = (a.cpu().numpy() for a in (uv0, ok0, slot0))
    add_frames = int(recs.new_ok.any(axis=(1, 2)).sum())
    adds_by_stream = recs.new_ok.any(axis=2).sum(axis=0).tolist()
    print(f"  main path: batched init + {S} batched steps in {elapsed:.4f} "
          f"s = {BATCH * T_BATCH / elapsed:.2f} stream-frames/s; launches "
          f"{launches}; frames with an addition: {add_frames} (by stream "
          f"{adds_by_stream})", flush=True)
    check_batch_launches(failures, "main path", launches, S, 1)
    check(failures, launches["init"] >= 1 + add_frames,
          f"init launched on the init and on each of the {add_frames} "
          f"frames where a stream adds ({launches['init']})")
    check(failures, len({tuple(np.nonzero(recs.new_ok.any(axis=2)[:, b])[0])
                         for b in range(BATCH)}) > 1,
          "the streams add features on different frames")
    check(failures, bool(torch.isfinite(states.x).all())
          and bool(torch.isfinite(states.P).all()), "final x and P finite")

    # tracking health per stream
    health = []
    for b in range(BATCH):
        matched = recs.total_matches[:, b].astype(np.int64)
        inl = (recs.li_inliers[:, b] + recs.hi_inliers[:, b]).astype(np.int64)
        health.append(dict(healthy=float(np.mean(inl >= 0.5 * matched)),
                           mean_matched=float(matched.mean()),
                           mean_inliers=float(inl.mean())))
    check(failures, all(h["healthy"] >= 0.9 and h["mean_matched"] >= 20
                        for h in health),
          "tracking healthy on every stream (inliers >= half the matches on "
          ">= 0.9 of frames, mean matched >= 20): "
          + ", ".join(f"{h['healthy']:.3f}/{h['mean_matched']:.1f}"
                      for h in health))

    # host syncs a batched frame, from a state already on the card
    st1 = batch_runner.make_batched_init(runtime)(
        batch_runner.make_batch_states(runtime, BATCH), gpu[:, 0])
    torch.cuda.synchronize()
    n_sync = 20
    sites, sync_s = count_syncs(lambda: batch_runner.scan_batched_sequences(
        runtime, st1, gpu[:, 1:1 + n_sync]))
    syncs = sum(sites.values())
    allowed = {source_line(batch_runner, ".tolist()")}
    print(f"  sync debug run: {n_sync / sync_s:.2f} batched steps/s, "
          f"{syncs} host syncs ({syncs / n_sync:.3f} a batched frame): "
          f"{dict(sites)}", flush=True)
    check(failures, syncs / n_sync <= 1.0 and set(sites) <= allowed,
          f"host syncs a batched frame {syncs / n_sync:.3f} <= 1, all at "
          f"{sorted(allowed)}")

    # each stream against its own single-stream run on the card
    gaps, masks = [], []
    for b in range(BATCH):
        _, rb = scan_runner.run_sequence_on_device(runtime, gpu[b])
        gaps.append(float(np.linalg.norm(
            rb.x_cam[:, 0:3].astype(np.float64)
            - recs.x_cam[:, b, 0:3], axis=1).max()))
        masks.append(float(np.mean([
            np.array_equal(rb.inliers[t], recs.inliers[t, b])
            and np.array_equal(rb.visible[t], recs.visible[t, b])
            for t in range(S)])))
    print(f"  each stream vs its single-stream run on the card: position "
          f"gap max {max(gaps):.3e} m (by stream "
          + ", ".join(f"{g:.2e}" for g in gaps) + "); masks identical on "
          + ", ".join(f"{m:.3f}" for m in masks) + " of frames", flush=True)
    check(failures, max(gaps) <= LIVE_REPLAY_TOL
          and min(masks) >= LIVE_MASKS_SAME,
          f"every stream within {LIVE_REPLAY_TOL} m of its single-stream "
          f"run (largest {max(gaps):.3e}), masks identical on >= "
          f"{LIVE_MASKS_SAME} of frames (least {min(masks):.3f})")

    # streams 0 and B - 1: their live logs replayed on the CPU in float64
    rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                       device="cpu")
    replays = {}
    for b in BATCH_REPLAYED:
        t0 = time.perf_counter()
        _, recs64 = replay.replay_records(
            rt64, stream_log(uv0, ok0, slot0, recs, b))
        agree = against_float64(recs.x_cam[:, b], recs.inliers[:, b],
                                recs.visible[:, b], recs64)
        agree["cpu_s"] = time.perf_counter() - t0
        replays[b] = agree
        print(f"  stream {b}: float64 CPU replay of its live log "
              f"{agree['cpu_s']:.1f} s: deviation max {agree['dev_max']:.3e}"
              f" (frame {agree['worst_frame']}), final "
              f"{agree['dev_final']:.3e}; inlier masks identical on "
              f"{agree['inliers_same']:.3f} of frames, visibility on "
              f"{agree['visible_same']:.3f}", flush=True)
        check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL
              and agree["inliers_same"] >= LIVE_MASKS_SAME
              and agree["visible_same"] >= LIVE_MASKS_SAME,
              f"stream {b}: float64 replay within {LIVE_REPLAY_TOL} m, masks "
              f"identical on >= {LIVE_MASKS_SAME} of frames")

    # streams are independent: stream 1's frames flipped, stream 0 the same
    flipped = gpu[:, :6].clone()
    flipped[1] = flipped[1].flip(-1)
    finals = []
    for seq in (gpu[:, :6], flipped):
        st = batch_runner.make_batched_init(runtime)(
            batch_runner.make_batch_states(runtime, BATCH), seq[:, 0])
        st, _ = batch_runner.scan_batched_sequences(runtime, st, seq[:, 1:])
        finals.append(st)
    check(failures, torch.equal(finals[0].x[0], finals[1].x[0])
          and torch.equal(finals[0].P[0], finals[1].P[0])
          and not torch.equal(finals[0].x[1], finals[1].x[1]),
          "stream 0's x and P bit-identical after 5 batched frames with "
          "stream 1's frames flipped (stream 1's differ)")

    # per-phase host and device ms under the profiler at B = BATCH
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batch_runner.scan_batched_sequences(
            runtime, st1, gpu[:, 1:1 + BATCH_PROFILED])
        torch.cuda.synchronize()
    averages = prof.key_averages()
    phase_ms = phase_times(averages, BATCH_PROFILED, LIVE_PHASE_PREFIX)
    kernels_us = kernel_device_us(averages, BATCH_PROFILED,
                                  BATCH_KERNEL_NAMES)
    dev_ms = device_ms(averages, BATCH_PROFILED)
    print(f"  per-phase ms a batched frame of {BATCH} streams under the "
          "profiler (host, device of PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)
    print_device(dev_ms, kernels_us)

    sweep = batch_sweep(failures, runtime)
    configs = batch_configs(failures)
    return dict(B=BATCH, frames=T_BATCH, launches=launches,
                elapsed_s=elapsed,
                stream_fps=BATCH * T_BATCH / elapsed, add_frames=add_frames,
                adds_by_stream=adds_by_stream, health=health,
                syncs=syncs, syncs_per_frame=syncs / n_sync,
                sync_sites=dict(sites), single_gap_m=gaps,
                single_masks_same=masks, replays=replays,
                phase_ms=phase_ms, kernels_us=kernels_us, device_ms=dev_ms,
                sweep=sweep, configs=configs)


# ------------------------------------------ phase 12: the other configurations

BATCH_NEW = 4                 # streams of each other configuration's run
T_BATCH_NEW = 21              # its frames: init + 20 steps
BATCH_NEW_WARM = 4            # frames of its warm-up run
BATCH_NEW_SYNC = 10           # batched frames of its sync debug run
BATCH_NEW_PROFILED = 2        # batched frames of the S-inverse's profile
# the kernels each frame of a single-stream run launches as often as a
# batched frame of B streams (init (A) and (B) run when any stream adds)
BATCH_PER_FRAME_KERNELS = ("predict", "measure", "measure_quirks", "update",
                           "sinv", "star", "star_direct", "brief",
                           "brief_generic", "cholsolve", "ransac_support")


def large_map_config() -> SlamConfig:
    """The config file of phase 6 (MaxMapSize 960: F = 168, N = 1024),
    sized as SlamEngine sizes it."""
    OUT.mkdir(exist_ok=True)
    path = OUT / "large_map_config.yml"
    path.write_text(LARGE_MAP_CONFIG)
    cfg = load_config(str(path))
    return dataclasses.replace(cfg, max_features=auto_max_features(cfg.ekf))


def batch_new_configs() -> dict:
    """Every configuration the batched step takes beyond the s3 profile,
    at full width with its own defaults: the other front-end profiles
    (phase 8's), NCC (phase 9's), the parity mode on the s3 profile with
    1000 hypotheses, and the large map."""
    out = {f"{d}/{e}": profile_config(d, e) for d, e in PROFILE_PAIRS}
    out["NCC"] = ncc_config()
    out["parity"] = dataclasses.replace(
        SlamConfig(detector=DetectorConfig(kind="STAR")),
        max_hypotheses=1000, **PARITY)
    out["large map"] = large_map_config()
    return out


@contextlib.contextmanager
def vmap_fallbacks(counts: collections.Counter):
    """Count, by op, vmap's per-sample fallbacks (an op with no batching
    rule, run once a stream) while the block runs, from the warning
    functorch gives for each when asked to."""
    enable = torch._C._functorch._set_vmap_fallback_warning_enabled
    enable(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        enable(False)
    for w in caught:
        m = re.search(r"batching rule for (\S+?)\.\s", str(w.message))
        if m:
            counts[m.group(1)] += 1


def check_fallback_counter(failures) -> None:
    """The counter sees a fallback: ``torch.histc`` has no batching rule."""
    counts: collections.Counter = collections.Counter()
    with vmap_fallbacks(counts):
        torch.func.vmap(lambda a: torch.histc(a, 4))(
            torch.rand(3, 8, device="cuda"))
    check(failures, counts.get("aten::histc", 0) >= 1,
          f"the fallback counter sees vmap(torch.histc)'s ({dict(counts)})")


def run_batch_config(failures, name: str, cfg: SlamConfig,
                     gpu: torch.Tensor) -> dict:
    """One configuration through the batched step at B = BATCH_NEW over
    ``gpu`` (B, T, H, W): launches against a single-stream frame's, host
    syncs, each stream against its own single-stream run on the card,
    tracking health, stream-frames/s beside the single stream, vmap's
    fallbacks by op, and for the chain's S-inverse its device launches by
    kernel name."""
    t_start = time.perf_counter()
    runtime = SlamRuntime(cfg)
    B, T = gpu.shape[:2]
    S = T - 1
    print(f"  -- {name}: {B} streams of {T} frames, {cfg.detector.kind} + "
          f"{cfg.descriptor.kind}, matcher {cfg.matcher}, F = "
          f"{cfg.max_features}, N = {cfg.padded_state_dim}, quirks "
          f"{cfg.reference_quirks}, parity visit {cfg.ransac_parity_visit}, "
          f"max_hypotheses {cfg.max_hypotheses}", flush=True)
    fallbacks: collections.Counter = collections.Counter()
    with vmap_fallbacks(fallbacks):
        st = batch_runner.make_batch_states(runtime, B)
        st = batch_runner.make_batched_init(runtime)(st, gpu[:, 0])
        batch_runner.scan_batched_sequences(runtime, st,
                                            gpu[:, 1:BATCH_NEW_WARM])
        torch.cuda.synchronize()

        # the main path: every launch counter at 0 just before, read just
        # after
        reset_launches()
        t0 = time.perf_counter()
        states = batch_runner.make_batch_states(runtime, B, seeds=range(B))
        states = batch_runner.make_batched_init(runtime)(states, gpu[:, 0])
        states, recs = batch_runner.scan_batched_sequences(runtime, states,
                                                           gpu[:, 1:])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
    recs = to_numpy(recs)
    check(failures, bool(torch.isfinite(states.x).all())
          and bool(torch.isfinite(states.P).all()),
          f"{name}: final x and P finite")

    # each stream's own single-stream run on the card: its launches, its
    # time, its trajectory
    gaps, masks, single_s, single_launches = [], [], [], None
    for b in range(B):
        reset_launches()
        t0 = time.perf_counter()
        _, rb = scan_runner.run_sequence_on_device(runtime, gpu[b])
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t0)
        if b == 0:
            single_launches = read_launches()
        gaps.append(float(np.linalg.norm(
            rb.x_cam[:, 0:3].astype(np.float64) - recs.x_cam[:, b, 0:3],
            axis=1).max()))
        masks.append(float(np.mean([
            np.array_equal(rb.inliers[t], recs.inliers[t, b])
            and np.array_equal(rb.visible[t], recs.visible[t, b])
            for t in range(S)])))
    per_frame = {k: launches[k] / S for k in launches if launches[k]}
    same = {k: (launches[k], single_launches[k])
            for k in BATCH_PER_FRAME_KERNELS}
    check(failures, all(a == b for a, b in same.values()),
          f"{name}: each kernel launched as often by {B} batched streams as "
          f"by one stream (batched, single): { {k: v for k, v in same.items() if v[0] or v[1]} }")
    chain = cfg.reference_quirks or not update_kernel.update_kernel_fits(
        cfg.padded_state_dim, 2 * cfg.max_features)
    want_sinv, want_update = (2 * S, 0) if chain else (0, 2 * S)
    check(failures, launches["sinv"] == want_sinv
          and launches["update"] == want_update,
          f"{name}: the S-inverse launched {launches['sinv']} times "
          f"({want_sinv}: once an update phase), the fused update "
          f"{launches['update']} ({want_update})")
    check(failures, 1 <= launches["init"] == launches["init_augment"] <= T,
          f"{name}: init (A) and (B) together on the init and on frames "
          f"where a stream adds ({launches['init']}, at most {T})")

    health = []
    for b in range(B):
        matched = recs.total_matches[:, b].astype(np.int64)
        inl = (recs.li_inliers[:, b] + recs.hi_inliers[:, b]).astype(
            np.int64)
        health.append(dict(healthy=float(np.mean(inl >= 0.5 * matched)),
                           mean_matched=float(matched.mean())))
    check(failures, all(h["healthy"] >= 0.9 and h["mean_matched"] >= 20
                        for h in health),
          f"{name}: tracking healthy on every stream: " + ", ".join(
              f"{h['healthy']:.3f}/{h['mean_matched']:.1f}" for h in health))
    check(failures, max(gaps) <= LIVE_REPLAY_TOL
          and min(masks) >= LIVE_MASKS_SAME,
          f"{name}: every stream within {LIVE_REPLAY_TOL} m of its "
          f"single-stream run (largest {max(gaps):.3e}), masks identical on "
          f">= {LIVE_MASKS_SAME} of frames (least {min(masks):.3f})")

    # host syncs a batched frame, from a state already on the card
    sites, sync_s = count_syncs(lambda: batch_runner.scan_batched_sequences(
        runtime, states, gpu[:, 1:1 + BATCH_NEW_SYNC]))
    syncs = sum(sites.values())
    allowed = {source_line(batch_runner, ".tolist()")}
    check(failures, syncs / BATCH_NEW_SYNC <= 1.0 and set(sites) <= allowed,
          f"{name}: host syncs a batched frame {syncs / BATCH_NEW_SYNC:.3f}"
          f" <= 1, all at {sorted(allowed)} ({dict(sites)})")

    out = dict(B=B, frames=T, elapsed_s=elapsed,
               stream_fps=B * T / elapsed,
               single_fps=T / float(np.mean(single_s)),
               launches=launches, launches_per_frame=per_frame,
               single_launches=single_launches, syncs=syncs,
               syncs_per_frame=syncs / BATCH_NEW_SYNC,
               sync_sites=dict(sites), single_gap_m=gaps,
               single_masks_same=masks, health=health,
               fallbacks=dict(fallbacks))
    if chain:
        # the S-inverse's batched launch set, by kernel name
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            batch_runner.scan_batched_sequences(
                runtime, states, gpu[:, 1:1 + BATCH_NEW_PROFILED])
            torch.cuda.synchronize()
        kern = kernel_device_us(prof.key_averages(), BATCH_NEW_PROFILED,
                                SINV_BATCH_NAMES)
        check(failures, set(kern) == set(SINV_BATCH_NAMES) and all(
            v["calls_per_frame"] == 2 for v in kern.values()),
              f"{name}: each of the S-inverse's six batched kernels twice a "
              "batched frame (" + ", ".join(
                  f"{k} {v['calls_per_frame']:.2f}" for k, v in kern.items())
              + ")")
        out["sinv_kernels_us"] = kern
    out["x_single"] = out["stream_fps"] / out["single_fps"]
    print(f"  {name}: {out['stream_fps']:.2f} stream-frames/s at B = {B} "
          f"({elapsed:.4f} s), single stream {out['single_fps']:.2f} "
          f"frames/s ({out['x_single']:.2f}x); launches a batched frame "
          f"{ {k: round(v, 3) for k, v in per_frame.items()} }; "
          f"{syncs / BATCH_NEW_SYNC:.3f} host syncs a batched frame; vs "
          f"single-stream runs: gap max {max(gaps):.3e} m, masks "
          f"{min(masks):.3f}; vmap fallbacks {dict(fallbacks)}; "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return out


def batch_configs(failures) -> dict:
    """Each configuration of batch_new_configs at B = BATCH_NEW over
    T_BATCH_NEW frames, stream b sliding 1 + b % 3 px a frame over its own
    texture (phase 12's frames)."""
    check_fallback_counter(failures)
    gpu = torch.tensor(batch_frames(BATCH_NEW, T_BATCH_NEW),
                       device="cuda")
    out = {name: run_batch_config(failures, name, cfg, gpu)
           for name, cfg in batch_new_configs().items()}
    total = collections.Counter()
    for v in out.values():
        total.update(v["fallbacks"])
    print(f"  vmap per-sample fallbacks on torch {torch.__version__}, by op "
          f"over every configuration's run: {dict(total) or 'none'}",
          flush=True)
    return out


# ---------------------------------------------------------------- phase 13

T_VIZ = 21                   # frames of the rendered engine run
VIZ3D_EVERY = 10


def phase_viz(cfg: SlamConfig, failures: list) -> dict:
    """The s3 SlamEngine with render, render_debug and viz3d_every over
    T_VIZ frames into chiprun_out/viz: the JAX engine's files, each
    overlay against the port's draw_* applied on the CPU to that frame's
    record, the host syncs a rendered frame, the record's read-back and
    snapshot_from_state against the same function on the CPU."""
    print("== phase 13: viz", flush=True)
    missing = [m for m in ("cv2", "matplotlib")
               if importlib.util.find_spec(m) is None]
    for m in missing:
        print(f"  {m} is not installed on this machine: "
              + ("no overlay is rendered" if m == "cv2"
                 else "no 3D map view is rendered"), flush=True)
    render = "cv2" not in missing
    every = VIZ3D_EVERY if "matplotlib" not in missing else 0
    out_dir = OUT / "viz"
    shutil.rmtree(out_dir, ignore_errors=True)
    frames = live_frames(T_VIZ)
    S = T_VIZ - 1

    def engine_run(path, **kw):
        engine = SlamEngine(cfg, output_path=path, **kw)
        recs = []
        step = engine.runtime.step

        def recorded(state, gray):
            state, rec = step(state, gray)
            recs.append(rec)
            return state, rec

        engine.runtime.step = recorded
        return engine, recs

    run_sequence(engine_run(None)[0], frames[:6])      # warm-up
    torch.cuda.synchronize()
    engine, recs = engine_run(str(out_dir), render=render,
                              render_debug=render, viz3d_every=every)
    t0 = time.perf_counter()
    run_sequence(engine, frames)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    engine.close()
    check_graph(failures, "rendering engine", engine.runtime)
    plain, _ = engine_run(None)
    t0 = time.perf_counter()
    run_sequence(plain, frames)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    files = sorted(str(f.relative_to(out_dir)) for f in out_dir.rglob("*")
                   if f.is_file())
    want = []
    if render:
        want += [f"{i:05d}.png" for i in range(1, S + 1)] + [
            "videoOutput.mp4", "debug/ransacDebug.mp4"] + [
            f"debug/{i:05d}.png" for i in range(1, S + 1)]
    if every:
        want += [f"map3d_{i:05d}.png" for i in range(every, S + 1, every)]
    check(failures, set(want) <= set(files),
          f"the JAX engine's files: {len(want)} expected, "
          f"{len(set(want) & set(files))} written ({len(files)} in all)")

    # each overlay against the port's draw_* on the CPU, on that frame's
    # card record
    differing = 0
    if render:
        import cv2

        from openekfmonoslam_tpu_torch.viz import draw
        for t, rec in enumerate(recs, start=1):
            r = {k: v.cpu().numpy() for k, v in rec._asdict().items()}
            gray = frames[t]
            for name, img in (
                    (f"{t:05d}.png", draw.draw_prediction_overlay(
                        gray, r["pred_uv"], r["pred_S"], r["visible"],
                        r["z"], r["matched"])),
                    (f"debug/{t:05d}.png", draw.draw_ransac_debug(
                        gray, r["z"], r["matched"], r["inliers"],
                        r["new_uv"], r["new_ok"]))):
                differing += not np.array_equal(
                    cv2.imread(str(out_dir / name)), img)
        check(failures, differing == 0,
              f"each of the {2 * S} overlays equals draw_* on the CPU "
              f"applied to its frame's record ({differing} differ)")

    # the record's read-back: the overlays' fields in the summary's copy
    engine2 = SlamEngine(cfg)
    engine2.init(frames[0])
    engine2.state, rec = engine2.runtime.step(engine2.state,
                                              engine2._upload(frames[1]))
    _, drawn = engine2._summary(rec, draw=True)
    same = all(np.array_equal(drawn[k], getattr(rec, k).cpu().numpy())
               for k in engine_mod.DRAW_FIELDS)
    check(failures, same and len(drawn) == len(engine_mod.DRAW_FIELDS),
          "the drawing fields read back in the summary's copy equal the "
          "record's")

    # host syncs a rendered frame against an unrendered one
    def syncs_of(**kw):
        eng, _ = engine_run(str(OUT / "viz_syncs") if kw else None, **kw)
        eng.init(frames[0])
        torch.cuda.synchronize()
        sites, _ = count_syncs(lambda: [eng.step(f) for f in frames[1:]])
        eng.close()
        return sites

    rendered = syncs_of(render=render, render_debug=render,
                        viz3d_every=every)
    unrendered = syncs_of()
    shutil.rmtree(OUT / "viz_syncs", ignore_errors=True)
    n_r, n_u = sum(rendered.values()), sum(unrendered.values())
    n_views = S // every if every else 0
    check(failures, n_r == n_u + n_views,
          f"host syncs: {n_r / S:.3f} a rendered frame against {n_u / S:.3f}"
          f" an unrendered one, {n_views} 3D views at one each "
          f"({dict(rendered)}; {dict(unrendered)})")

    # snapshot_from_state on the card against the CPU, on the final state
    from openekfmonoslam_tpu_torch.viz import viewer3d
    snap_sites, _ = count_syncs(lambda: viewer3d.snapshot_from_state(
        engine.state))
    card = viewer3d.snapshot_from_state(engine.state)
    host = viewer3d.snapshot_from_state(
        type(engine.state)(*(f.cpu() for f in engine.state)))
    err = max(float(np.abs(np.asarray(a, np.float64)
                           - np.asarray(b, np.float64)).max()
                    / max(1.0, float(np.abs(np.asarray(b, np.float64)
                                            ).max())))
              for a, b in zip(card, host))
    check(failures, err <= 1e-5 and sum(snap_sites.values()) == 1,
          f"snapshot_from_state on the card within 1e-5 (relative) of the "
          f"CPU's ({err:.3e}), in one read-back ({dict(snap_sites)})")
    out = dict(frames=T_VIZ, missing=missing, files=len(files),
               fps_rendered=T_VIZ / elapsed, fps_unrendered=T_VIZ / plain_s,
               overlays_differing=differing,
               syncs_per_rendered_frame=n_r / S,
               syncs_per_unrendered_frame=n_u / S,
               sync_sites_rendered=dict(rendered), snapshot_rel_err=err)
    print(f"  {T_VIZ} frames rendered at {out['fps_rendered']:.2f} frames/s "
          f"({out['fps_unrendered']:.2f} unrendered); {len(files)} files; "
          f"{n_r / S:.3f} host syncs a rendered frame, "
          f"{n_u / S:.3f} unrendered", flush=True)
    return out


# ---------------------------------------------------------------- phase 14

T_SHARD = 41                  # frames of the p = 2 and (2, 2) runs
T_SHARD_SHORT = 21            # frames of the NCCL p = 1 and the d x p runs
SHARD_WARM = 4                # frames of each rank's warm-up run
SHARD_SYNC_STEPS = 5          # steps of each rank's sync debug run
SHARD_SYM_TOL = 1e-6          # max |P - P^T| / max |P| after a run
SHARD_JOIN_S = 600.0          # every run's ranks finish within this, or
#                               every worker is killed and the phase fails
SHARD_STREAMS = 2             # phase 12's streams 0 and 1, for d x p
# (name, backend, mesh shape, mesh axes, frames); every rank on cuda:0
SHARD_RUNS = (("p1_nccl", "nccl", (1,), ("p",), T_SHARD_SHORT),
              ("p2", "gloo", (2,), ("p",), T_SHARD),
              ("p2q2", "gloo", (2, 2), ("p", "q"), T_SHARD),
              ("d2p2", "gloo", (2, 2), ("d", "p"), T_SHARD_SHORT))
# each kernel's launches a sharded step (init (A) also on adding frames);
# predict, the fused update and (B) take whole P: their tile forms run
SHARD_PER_STEP = {"measure": 2, "sinv": 2, "star": 1, "brief": 1,
                  "ransac_support": 1,
                  "predict": 0, "update": 0, "init_augment": 0,
                  "measure_quirks": 0, "star_direct": 0, "brief_generic": 0,
                  "cholsolve": 0}


def replicated_digest(state, record) -> str:
    """sha256 of every replicated field of a state and of its record."""
    h = hashlib.sha256()
    for name, t in list(state._asdict().items()) + list(
            record._asdict().items()):
        if name != "P":
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def shard_worker(rank: int, runs: list, frames: dict, out) -> None:
    """One spawned process of phase 14: rank ``rank`` of each run of
    ``runs`` that has that many ranks, one run after another (a run's
    process group is started and destroyed within it).  Each result, or
    the traceback of what failed (after which the process stops), goes to
    ``out``."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    for run in runs:
        if rank >= math.prod(run["shape"]):
            continue
        try:
            res = shard_rank_run(rank, run, frames[run["frames"]])
        except BaseException:
            out.put((run["name"], rank, traceback.format_exc()))
            raise
        out.put((run["name"], rank, res))


def shard_rank_run(rank: int, run: dict, frames: np.ndarray) -> dict:
    """One rank of one run: warm-up, the timed run with every counter at 0
    just before, a sync debug run, and the gathered P's symmetry."""
    t_start = time.perf_counter()
    dp = run["axes"][0] == "d"
    if dp:
        os.environ["LOCAL_WORLD_SIZE"] = str(run["shape"][1])
    world = math.prod(run["shape"])
    dev = run["device"]
    multihost.initialize(f"127.0.0.1:{run['port']}", world, rank,
                         backend=run["backend"], device=dev)
    try:
        rt = SlamRuntime(run["config"], device=dev)
        gpu = rt._tensor(frames)
        T = frames.shape[-3]
        if dp:
            mesh = multihost.make_host_mesh(device=dev)
            init = batch_runner.make_batched_init_2d(rt, mesh)
            step = batch_runner.make_batched_step_2d(rt, mesh)
            srt = step.runtime

            def start():
                states = batch_runner.make_batch_states(
                    rt, SHARD_STREAMS, seeds=range(SHARD_STREAMS), mesh=mesh,
                    p_axis="p")
                return init(states, gpu[:, 0]), None

            def frame(t):
                return gpu[:, t]
        else:
            mesh = (sharding.make_mesh(dev, axis="p")
                    if len(run["shape"]) == 1
                    else sharding.make_mesh_2d(dev, shape=run["shape"],
                                               axes=run["axes"]))
            srt = sharding._sharded_runtime(rt, mesh, *run["axes"])
            step = srt.step

            def start():
                st, uv0, ok0, slot0 = srt.init_step_recorded(
                    srt.make_initial_state(), gpu[0])
                return st, (uv0, ok0, slot0)

            def frame(t):
                return gpu[t]
        comm = srt.tiling.comm
        t_setup = time.perf_counter()

        st, _ = start()                       # warm-up, off the clock
        for t in range(1, SHARD_WARM):
            st, _ = step(st, frame(t))
        torch.cuda.synchronize()
        t_warm = time.perf_counter()

        # the main path: every launch and collective counter at 0 just
        # before, read just after; the collectives also a step apart
        reset_launches()
        comm.reset()
        t0 = time.perf_counter()
        st, boot = start()
        init_comm = comm.summary()
        comm.reset()
        steps, recs, per_step = [], [], []
        for t in range(1, T):
            st, rec = step(st, frame(t))
            per_step.append(comm.summary())
            comm.reset()
            steps.append(st)
            recs.append(rec)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        digests = [replicated_digest(s, r) for s, r in zip(steps, recs)]

        # host syncs a step, by site, from a state already on the card
        st2, _ = start()
        torch.cuda.synchronize()

        def sync_steps():
            s = st2
            for t in range(1, 1 + SHARD_SYNC_STEPS):
                s, _ = step(s, frame(t))

        sites, sync_s = count_syncs(sync_steps)
        t_sync = time.perf_counter()

        # the whole P once, for its symmetry (not a step's collective)
        P_local = st.P
        if dp:
            P_full = sharding.gather_state(
                SlamState(*(f[0] for f in st)), mesh, ("p",)).P
        else:
            P_full = sharding.gather_state(st, mesh, run["axes"]).P
        asym = float((P_full - P_full.T).abs().max() / P_full.abs().max())
        result = dict(
            rank=rank, elapsed_s=elapsed, fps=T / elapsed, launches=launches,
            init_comm=init_comm, per_step=per_step, digests=digests,
            sync_sites=dict(sites), syncs=sum(sites.values()),
            sync_s=sync_s, asym=asym, p_local_shape=list(P_local.shape),
            p_local_bytes=P_local.numel() * P_local.element_size(),
            coordinate=list(mesh.get_coordinate()),
            hp_layout=srt.hp_layout, device=str(P_local.device),
            seconds=dict(setup=t_setup - t_start, warm=t_warm - t_setup,
                         main_and_sync=t_sync - t_warm,
                         gather=time.perf_counter() - t_sync))
        recs = scan_runner.stack_records(recs)
        result["records"] = {k: v.cpu().numpy()
                             for k, v in recs._asdict().items()}
        if boot is not None:
            result["boot"] = [a.cpu().numpy() for a in boot]
        return result
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_runs(runs: list, frames: dict) -> tuple[dict, list]:
    """Every run of ``runs`` on one set of spawned worker processes (as
    many as the largest run has ranks); ({name: {rank: result}}, errors).
    Every process is joined, and killed if it outlives SHARD_JOIN_S."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    world = max(math.prod(r["shape"]) for r in runs)
    want = sum(math.prod(r["shape"]) for r in runs)
    procs = [ctx.Process(target=shard_worker, args=(r, runs, frames, out))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors, n = {r["name"]: {} for r in runs}, [], 0
    deadline = time.monotonic() + SHARD_JOIN_S
    try:
        while n < want and not errors and time.monotonic() < deadline:
            try:
                name, rank, res = out.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    time.sleep(2.0)       # the failing rank's traceback
                    if out.empty():
                        errors.append("a worker exited with "
                                      + str([p.exitcode for p in procs]))
                continue
            if isinstance(res, str):
                errors.append(f"{name}, rank {rank}:\n{res}")
            else:
                got[name][rank] = res
                n += 1
        if n < want and not errors:
            errors.append(f"{want - n} rank results missing after "
                          f"{SHARD_JOIN_S} s")
    finally:
        for p in procs:
            p.join(timeout=5.0 if errors else
                   max(deadline - time.monotonic(), 5.0))
            if p.is_alive():
                p.kill()
                p.join()
    return got, errors


def per_step_comm(per_step: list) -> dict:
    """A run's collectives a step: calls and bytes by kind/axis/site (the
    mean), the most bytes and elements of any step and call."""
    calls, nbytes = collections.Counter(), collections.Counter()
    for s in per_step:
        calls.update(s["calls"])
        nbytes.update(s["bytes"])
    n = max(len(per_step), 1)
    return dict(calls={k: v / n for k, v in calls.items()},
                bytes={k: v / n for k, v in nbytes.items()},
                max_step_bytes=max(s["total_bytes"] for s in per_step),
                mean_step_bytes=sum(s["total_bytes"] for s in per_step) / n,
                max_call_elements=max(s["largest_elements"]
                                      for s in per_step))


def against_run(a, b) -> dict:
    """Records ``a`` against ``b`` (dicts of numpy fields, frames first):
    camera-position gap a frame, shares of frames with identical inlier
    and visibility masks."""
    gap = np.linalg.norm(a["x_cam"][:, 0:3].astype(np.float64)
                         - b["x_cam"][:, 0:3], axis=1)
    same = [float(np.mean([np.array_equal(x, y)
                           for x, y in zip(a[k], b[k])]))
            for k in ("inliers", "visible")]
    return dict(gap_max=float(gap.max()), worst_frame=int(gap.argmax()) + 1,
                inliers_same=same[0], visible_same=same[1])


def single_run(rt: SlamRuntime, frames: np.ndarray) -> tuple[dict, float]:
    """The single-device step over ``frames`` (init + steps), after a
    warm-up: (records as numpy fields, frames/s)."""
    scan_runner.run_sequence_on_device(rt, frames[:SHARD_WARM])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, recs = scan_runner.run_sequence_on_device(rt, frames)
    torch.cuda.synchronize()
    return recs._asdict(), len(frames) / (time.perf_counter() - t0)


def phase_shard(failures: list) -> dict:
    """The large map with P split over torch.distributed ranks that share
    the one card (parallel/sharding.py): p = 1 over NCCL, p = 2 and
    (p, q) = (2, 2) over gloo, and streams x row strips (d, p) = (2, 2)
    through parallel/batch_runner.py's two-axis layout, each against the
    single-device run of the same frames."""
    print("== phase 14: sharded covariance", flush=True)
    cfg = large_map_config()
    N, F = cfg.padded_state_dim, cfg.max_features
    rt = SlamRuntime(cfg)
    frames = live_frames(T_LIVE)[:T_SHARD]
    streams = batch_frames(SHARD_STREAMS, T_BATCH)[:, :T_SHARD_SHORT]
    print(f"  the large map: F = {F}, N = {N}; phase 6's frames, and "
          f"phase 12's streams 0 and 1 for d x p; ranks on "
          f"{torch.cuda.get_device_name(0)}, spawned, sharing cuda:0; "
          f"dense H P from {13 + 6 * F} >= 1024 dims: "
          f"{cfg.state_dim >= 1024}", flush=True)
    single, single_fps = single_run(rt, frames)
    singles = [single_run(rt, streams[b]) for b in range(SHARD_STREAMS)]
    print(f"  single device: {single_fps:.2f} frames/s over {T_SHARD} "
          "frames; streams 0, 1: " + ", ".join(
              f"{s[1]:.2f}" for s in singles) + f" over {T_SHARD_SHORT}",
          flush=True)
    out = {"single_fps": single_fps,
           "single_stream_fps": [s[1] for s in singles], "runs": {}}
    full_p = N * N
    runs = [dict(name=name, backend=backend, shape=shape, axes=axes,
                 frames=f"{'streams' if axes[0] == 'd' else 'live'}{T}",
                 config=cfg, device="cuda:0", port=free_port())
            for name, backend, shape, axes, T in SHARD_RUNS]
    t0 = time.perf_counter()
    results, errors = spawn_runs(runs, {
        f"live{T_SHARD}": frames, f"live{T_SHARD_SHORT}":
        frames[:T_SHARD_SHORT], f"streams{T_SHARD_SHORT}": streams})
    wall = time.perf_counter() - t0
    workers = max(math.prod(r["shape"]) for r in runs)
    check(failures, not errors,
          f"every run's ranks ({', '.join(r['name'] for r in runs)}) ran "
          f"to the end in {wall:.1f} s on {workers} worker processes"
          + ("" if not errors else "\n" + "\n".join(errors)[-6000:]))
    out["wall_s"] = wall
    if errors:
        return out
    for name, backend, shape, axes, T in SHARD_RUNS:
        dp = axes[0] == "d"
        got = results[name]
        r0 = got[0]
        S = T - 1
        print(f"  {name}: seconds by rank (setup, warm-up, main and sync "
              f"runs, gather): " + "; ".join(
                  f"{r} " + ", ".join(f"{v:.1f}" for v in
                                      got[r]["seconds"].values())
                  for r in sorted(got)), flush=True)
        comm = per_step_comm(r0["per_step"])
        print(f"  {name} ({backend}, mesh {dict(zip(axes, shape))}, "
              f"{r0['hp_layout']} H P): {r0['fps']:.2f} frames/s over {T} "
              f"frames (single device "
              f"{single_fps if not dp else singles[0][1]:.2f}); P a rank "
              f"{r0['p_local_shape']} = {r0['p_local_bytes']} B; "
              f"collectives a step: {comm['calls']}; bytes a step "
              f"{comm['bytes']}; mean {comm['mean_step_bytes']:.0f}, max "
              f"{comm['max_step_bytes']} B; largest call "
              f"{comm['max_call_elements']} elements; launches "
              f"{r0['launches']}", flush=True)
        # launches a step: the replicated kernels only
        want = {k: v * S + (1 if k in ("star", "brief") else 0)
                for k, v in SHARD_PER_STEP.items()}
        got_l = r0["launches"]
        adds = int(r0["records"]["new_ok"].reshape(S, -1).any(axis=1).sum())
        check(failures, all(got_l[k] == v for k, v in want.items())
              and 1 <= got_l["init"] <= 1 + adds,
              f"{name}: launches {got_l} (a step: {SHARD_PER_STEP}, init "
              f"(A) on the init and {adds} adding frames)")
        # the ranks of a stream's group launch alike (d x p: a group a
        # stream, each adding on its own frames)
        groups = ([[0, 1], [2, 3]] if dp else [list(got)])
        check(failures, all(got[r]["launches"] == got[g[0]]["launches"]
                            for g in groups for r in g),
              f"{name}: every rank launched as its group's first rank")
        check(failures, comm["max_call_elements"] < full_p
              and comm["max_step_bytes"] < 4 * full_p * 4,
              f"{name}: no collective of N x N = {full_p} elements or more "
              f"(largest {comm['max_call_elements']}), a step's bytes "
              f"{comm['max_step_bytes']} < 4 N^2 x 4 = {4 * full_p * 4}")
        # replicated state bit for bit against the group's first rank
        same = all(got[r]["digests"] == got[g[0]]["digests"]
                   for g in groups for r in g)
        check(failures, same, f"{name}: the replicated state and records "
              f"of every rank equal its group's first rank's, bit for bit, "
              f"on every one of {S} steps")
        syncs = {r: got[r]["syncs"] / SHARD_SYNC_STEPS for r in got}
        print(f"  {name}: host syncs a step by rank {syncs}; rank 0's "
              f"sites {r0['sync_sites']}; max |P - P^T| / max |P| "
              + ", ".join(f"{got[r]['asym']:.3e}" for r in got), flush=True)
        if backend == "nccl":
            check(failures, syncs[0] <= 1.0,
                  f"{name}: at most 1 host sync a step ({syncs[0]:.3f})")
        check(failures, all(got[r]["asym"] <= SHARD_SYM_TOL for r in got),
              f"{name}: max |P - P^T| / max |P| <= {SHARD_SYM_TOL} after "
              f"{T} frames")
        # against the single-device run of the same frames
        if dp:
            cmp = []
            for g in groups:
                b = got[g[0]]["coordinate"][0]
                recs = {k: v[:, 0] for k, v in got[g[0]]["records"].items()}
                cmp.append(against_run(recs, {k: v[:S] for k, v in
                                              singles[b][0].items()}))
        else:
            cmp = [against_run(r0["records"],
                               {k: v[:S] for k, v in single.items()})]
        print(f"  {name} against the single device: " + "; ".join(
            f"gap max {c['gap_max']:.3e} m (frame {c['worst_frame']}), "
            f"masks {c['inliers_same']:.3f}, {c['visible_same']:.3f}"
            for c in cmp), flush=True)
        check(failures, all(c["gap_max"] <= LIVE_REPLAY_TOL
                            and c["inliers_same"] >= LIVE_MASKS_SAME
                            and c["visible_same"] >= LIVE_MASKS_SAME
                            for c in cmp),
              f"{name}: within {LIVE_REPLAY_TOL} m of the single device, "
              f"masks identical on >= {LIVE_MASKS_SAME} of frames")
        res = dict(backend=backend, shape=list(shape), axes=list(axes),
                   frames=T, seconds={r: got[r]["seconds"] for r in got},
                   fps=r0["fps"],
                   fps_by_rank={r: got[r]["fps"] for r in got},
                   launches=got_l, comm=comm, init_comm=r0["init_comm"],
                   p_local_shape=r0["p_local_shape"],
                   p_local_bytes=r0["p_local_bytes"],
                   syncs_per_step=syncs, sync_sites=r0["sync_sites"],
                   asym={r: got[r]["asym"] for r in got},
                   against_single=cmp, hp_layout=r0["hp_layout"])
        if name == "p2":
            # its log (the front end's measurements) replayed in float64
            uv0, ok0, slot0 = r0["boot"]
            recs = step_mod.StepRecord(**{k: v[:, None] for k, v in
                                          r0["records"].items()})
            log = stream_log(uv0[None], ok0[None], slot0[None], recs, 0)
            rt64 = SlamRuntime(dataclasses.replace(cfg, dtype="float64"),
                               device="cpu")
            t0 = time.perf_counter()
            _, recs64 = replay.replay_records(rt64, log)
            cpu_s = time.perf_counter() - t0
            agree = against_float64(r0["records"]["x_cam"],
                                    r0["records"]["inliers"],
                                    r0["records"]["visible"], recs64)
            print(f"  {name}: float64 CPU replay of its log {cpu_s:.1f} s: "
                  f"deviation max {agree['dev_max']:.3e} (frame "
                  f"{agree['worst_frame']}); masks identical on "
                  f"{agree['inliers_same']:.3f}, {agree['visible_same']:.3f}"
                  " of frames", flush=True)
            check(failures, agree["dev_max"] <= LIVE_REPLAY_TOL,
                  f"{name}: float64 replay within {LIVE_REPLAY_TOL} m")
            res["replay"] = dict(cpu_s=cpu_s, **agree)
        out["runs"][name] = res
    return out


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
    if "--profiles-only" in argv:
        # phases 1 and 8 alone: the front-end profiles, no result line
        failures: list = []
        profiles = phase_profiles(failures)
        end_phase("profiles", failures)
        OUT.mkdir(exist_ok=True)
        (OUT / "profiles.json").write_text(json.dumps(profiles, indent=1))
        print(f"profiles only: {time.perf_counter() - T_START:.1f} s",
              flush=True)
        return 0
    if "--batch-only" in argv:
        # phases 1 and 12 alone: B streams through one step; no result line
        failures = []
        batch = phase_batch(live_cfg, failures)
        end_phase("batch", failures)
        OUT.mkdir(exist_ok=True)
        (OUT / "batch.json").write_text(json.dumps(batch, indent=1))
        print(f"batch only: {time.perf_counter() - T_START:.1f} s",
              flush=True)
        return 0
    if "--viz-only" in argv:
        # phases 1 and 13 alone: the rendering options; no result line
        failures = []
        viz = phase_viz(live_cfg, failures)
        end_phase("viz", failures)
        OUT.mkdir(exist_ok=True)
        (OUT / "viz.json").write_text(json.dumps(viz, indent=1))
        print(f"viz only: {time.perf_counter() - T_START:.1f} s", flush=True)
        return 0
    if "--shard-only" in argv:
        # phases 1 and 14 alone: P split over ranks; no result line
        failures = []
        shard = phase_shard(failures)
        end_phase("shard", failures)
        OUT.mkdir(exist_ok=True)
        (OUT / "shard.json").write_text(json.dumps(shard, indent=1))
        print(f"shard only: {time.perf_counter() - T_START:.1f} s",
              flush=True)
        return 0
    if "--engine-features-only" in argv:
        # phases 1 and 9-11 alone: NCC, loop closure, serve; no result line
        features = phase_engine_features(live_cfg)
        OUT.mkdir(exist_ok=True)
        (OUT / "engine_features.json").write_text(
            json.dumps(features, indent=1))
        print(f"engine features only: {time.perf_counter() - T_START:.1f} "
              "s", flush=True)
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
    rows["sinv"]["batch8"] = rows.pop("sinv_batch8_fn")
    time_row("sinv", rows["sinv"])

    failures = []
    parity = phase_parity(cfg, path, failures)
    end_phase("parity", failures)
    failures = []
    profiles = phase_profiles(failures)
    end_phase("profiles", failures)
    features = phase_engine_features(live_cfg)
    failures = []
    batch = phase_batch(live_cfg, failures)
    end_phase("batch", failures)
    failures = []
    viz = phase_viz(live_cfg, failures)
    end_phase("viz", failures)
    failures = []
    shard = phase_shard(failures)
    end_phase("shard", failures)

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
            "launches_parity_engine": parity["engine"]["launches"][name],
            "launches_profiles": {k: v["launches"][name]
                                  for k, v in profiles.items()},
            "launches_ncc": features["ncc"]["launches"][name],
            "launches_loop_closure": features["loop closure"]["launches"][
                name],
            # phase 12: B = 8 streams through one batched step; the row's
            # one launch over 8 streams (phase 2, CUDA graph; null where
            # the kernel has no batched launch)
            "launches_batch": batch["launches"][name],
            # phase 12's runs of the other configurations at B = 4
            "launches_batch_configs": {k: v["launches"][name]
                                       for k, v in batch["configs"].items()},
            # phase 14: the large map with P split over ranks (rank 0's)
            "launches_shard": {k: v["launches"][name]
                               for k, v in shard["runs"].items()},
            "batch8_ms": row["batch8_ms"]})
    extra = ("sinv_spd336", "sinv_masked336", "update_fused_n1024",
             "update_chain_n1024",
             "cholsolve_336x1024", "brief_generic_256", "predict_n1024",
             "floor")
    report.update(kernels=kernels, update_checks=rows["update"]["checks"],
                  path_update_checks=path["path_update"],
                  path={k: path[k] for k in (
                      "fps", "fps_second", "elapsed_s", "syncs", "sync_sites",
                      "phase_ms", "measure_launches_per_call", "add_call",
                      "record_s",
                      "healthy", "mean_matched", "mean_inliers",
                      "replay_vs_recording", "launches")},
                  frames=T, syncs_per_frame=path["syncs"] / T, replay=rep,
                  live={k: v for k, v in live.items()},
                  large_map=large, sinv_path_row=rows["sinv"],
                  other_rows={k: rows[k] for k in extra},
                  cholsolve_checks=rows["cholsolve"]["checks"],
                  parity=parity, profiles=profiles,
                  engine_features=features, batch=batch, viz=viz,
                  shard=shard,
                  seconds=time.perf_counter() - T_START)
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
          f"{pe['syncs_per_frame']:.3f}", flush=True)
    nc, lc, sv = (features[k] for k in ("ncc", "loop closure", "serve"))
    print(f"ncc: frames/s {nc['fps']:.2f} over {nc['frames']} frames, host "
          f"syncs/frame {nc['syncs_per_frame']:.3f}; loop closure: frames/s "
          f"{lc['fps']:.2f} over {lc['frames']} frames, {len(lc['closures'])}"
          f" closures, endpoint {lc['raw_endpoint_err']:.4f} -> "
          f"{lc['corrected_endpoint_err']:.4f} m; serve: "
          f"{sv['ms_per_frame_socket']:.3f} ms a step through the socket",
          flush=True)
    sw = batch["sweep"]
    print(f"batch: {BATCH} streams {batch['stream_fps']:.2f} stream-frames/s"
          f" over {T_BATCH} frames, host syncs/batched frame "
          f"{batch['syncs_per_frame']:.3f}; stream-frames/s "
          + ", ".join(f"B = {B} {sw[B]['stream_fps']:.2f}"
                      for B in BATCH_SWEEP)
          + f" (single stream {sw['single_fps_before']:.2f}, "
          f"{sw['single_fps_after']:.2f})", flush=True)
    print(f"batch, B = {BATCH_NEW} over {T_BATCH_NEW} frames: " + "; ".join(
        f"{k} {v['stream_fps']:.2f} stream-frames/s (single stream "
        f"{v['single_fps']:.2f})" for k, v in batch["configs"].items())
        + f"; viz: {viz['fps_rendered']:.2f} frames/s rendered, "
        f"{viz['syncs_per_rendered_frame']:.3f} syncs a rendered frame",
        flush=True)
    print(f"shard (the large map, ranks sharing the card): " + "; ".join(
        f"{k} {v['fps']:.2f} frames/s, {v['comm']['mean_step_bytes']:.0f} B"
        " of collectives a step" for k, v in shard["runs"].items())
        + f" (single device {shard['single_fps']:.2f})", flush=True)
    print("profiles: " + "; ".join(
        f"{k} {v['fps']:.2f} frames/s over {v['frames']} frames, BRIEF "
        f"{v['launches']['brief'] / v['frames']:.2f} a frame"
        for k, v in profiles.items())
        + f"; {time.perf_counter() - T_START:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
