#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repository root; needs one CUDA
                                 # device and the CUDA toolkit (nvcc)

Phases, each of which passes or raises (the script then exits non-zero):

  1. build    compile csrc/*.cu for sm_90a (one nvcc per source, in
              parallel) into build/torch_kernels/ and load the library;
  2. kernels  each hand-written kernel at the main path's shapes (N = 640,
              F = 96, 2F = 192, C = 96) against its plain PyTorch version
              run in float64 on the card, plus the update's S^-1 against a
              float64 Cholesky inverse, the no-use bit-exact pass-through
              and the symmetry of P' (the update also on the path's own
              frame-T/2 data, in phase 3); then each kernel's device time (CUDA
              graph of 200 launches), its eager time, the plain version's
              time and its bound;
  3. path     SlamRuntime(SlamConfig()) on the card at full s3 width: a
              closed-loop synthetic scene records an injection log (about
              160 points, a smooth camera path, 1 px noise, 5% outliers),
              then the log is replayed through the replay entry point
              (eval/replay.py run_uploaded) with every launch counter set
              to 0 just before and read just after, which gives frames/s;
              then two more replays: one counts host syncs per frame
              under PyTorch's sync debug mode, one takes each phase's
              host and device ms from torch.profiler's ranges;
  4. replay   the same log through the port on the CPU in float64 (the
              plain path), held against the card's float32 trajectory.

The line before the last is one JSON object with a row per kernel; the
last line is {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
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

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.engine.step import PHASE_PREFIX, SlamRuntime
from openekfmonoslam_tpu_torch.eval import replay
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter import measure as meas_mod
from openekfmonoslam_tpu_torch.filter import predict as pred_mod
from openekfmonoslam_tpu_torch.filter.state import dim_active_mask
from openekfmonoslam_tpu_torch.ops import (cuda_lib, init_kernel,
                                           measure_kernel, predict_kernel,
                                           sinv, update_kernel)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

KERNELS = {
    "predict": dict(module=predict_kernel,
                    source="openekfmonoslam_tpu_torch/csrc/predict.cu",
                    replaces="openekfmonoslam_tpu/ops/predict_kernel.py:48"),
    "measure": dict(module=measure_kernel,
                    source="openekfmonoslam_tpu_torch/csrc/measure.cu",
                    replaces="openekfmonoslam_tpu/ops/measure_kernel.py:44"),
    "update": dict(module=update_kernel,
                   source="openekfmonoslam_tpu_torch/csrc/update.cu",
                   replaces="openekfmonoslam_tpu/ops/update_kernel.py:73"),
    "init": dict(module=init_kernel,
                 source="openekfmonoslam_tpu_torch/csrc/init.cu",
                 replaces="openekfmonoslam_tpu/ops/init_kernel.py:48"),
}

T_FRAMES = 220          # frames of the path (>= 200)
GRAPH_REPS = 200        # kernel launches per timed CUDA graph
EAGER_REPS = 200        # eager kernel launches per timing
PLAIN_REPS = 50         # plain-version calls per timing

# bounds of the kernel checks (float32 kernel vs float64 plain version)
TOL = {
    "predict_x": 1e-6, "predict_P": 1e-4,
    "measure_rtol": 1e-6,            # plus 1e-6 * max(|a|, 1) absolute
    "update_x": 5e-5, "update_P": 5e-4, "update_sym": 1e-5,
    "sinv_rel": 1e-4,
    "init_feats": 1e-5, "init_J1": 2e-2, "init_J2": 1e-4,
}
# float32 card trajectory vs the float64 CPU replay of the same log: the
# camera-position deviation on every frame (metres; about ten times the
# largest seen on the H100 over 220 frames, 9.8e-7), and the share of
# frames whose inlier and visibility masks must be identical
REPLAY_TOL = 1e-5
REPLAY_MASKS_SAME = 0.99


class PhaseError(RuntimeError):
    pass


def check(failures: list, ok: bool, what: str) -> None:
    print(("  pass " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def end_phase(name: str, failures: list) -> None:
    if failures:
        raise PhaseError(f"phase {name} failed: " + "; ".join(failures))
    print(f"phase {name}: ok", flush=True)


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


def phase_times(prof, frames: int) -> dict:
    """{phase: {"host_ms", "device_ms"}} a frame from the profiler ranges
    that step_injected opens around its phases: the host's wall time inside
    each range, and the device time of the PyTorch kernels launched in it.
    The hand-written kernels are launched through ctypes, outside any
    PyTorch op, and the profiler does not count them in a range: their
    times are the kernel table's."""
    out = {}
    for e in prof.key_averages():
        if (e.key.startswith(PHASE_PREFIX)
                and e.device_type == torch.autograd.DeviceType.CPU):
            out[e.key[len(PHASE_PREFIX):]] = {
                "host_ms": e.cpu_time_total / 1e3 / frames,
                "device_ms": e.device_time_total / 1e3 / frames}
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


def check_update(failures, tag, P, x, HP, Sfull, uv, z, use, pe) -> dict:
    """The update kernel against its float64 plain version and its S^-1
    against a float64 Cholesky inverse; returns the errors."""
    x_k, P_k, Sinv_k = update_kernel.joint_update_cuda(P, x, HP, Sfull, uv,
                                                       z, use, pe)
    d = [a.double() for a in (P, x, HP, Sfull, uv, z)]
    x_t, P_t = update_kernel.update_plain(*d, use, pe)
    S64 = _masked_S(d[3], use, pe)
    inv64 = sinv.spd_inverse(S64)
    eig = torch.linalg.eigvalsh(S64)
    e = {"x": max_abs(x_k, x_t), "P": max_abs(P_k, P_t),
         "sym": max_abs(P_k, P_k.T),
         "sinv_rel": max_abs(Sinv_k, inv64) / float(inv64.abs().max()),
         "cond_S": float(eig.max() / eig.min()),
         "used_rows": int(use.sum()) * 2}
    check(failures, e["x"] <= TOL["update_x"],
          f"update[{tag}] x err {e['x']:.3e} <= {TOL['update_x']}")
    check(failures, e["P"] <= TOL["update_P"],
          f"update[{tag}] P err {e['P']:.3e} <= {TOL['update_P']}")
    check(failures, e["sym"] <= TOL["update_sym"],
          f"update[{tag}] max|P'-P'^T| {e['sym']:.3e} <= {TOL['update_sym']}")
    check(failures, e["sinv_rel"] <= TOL["sinv_rel"],
          f"update[{tag}] S^-1 rel err {e['sinv_rel']:.3e} <= "
          f"{TOL['sinv_rel']} (cond(S) {e['cond_S']:.3e})")
    return e


def phase_kernels(cfg: SlamConfig, camera, dev=torch.device("cuda", 0)
                  ) -> dict:
    """Each kernel against its float64 plain version, then its times."""
    print("== phase 2: kernels", flush=True)
    N, F, C = cfg.padded_state_dim, cfg.max_features, cfg.max_features
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    failures: list = []
    rows: dict = {}

    # ---- predict
    Pp, xp = (torch.tensor(a, **f32) for a in _spd_state(rng, N))
    lin, ang = cfg.ekf.linear_accel_sd ** 2, cfg.ekf.angular_accel_sd ** 2
    x_k, P_k = predict_kernel.predict(Pp, xp, 1.0, lin, ang)
    x_t, P_t = predict_kernel.predict_plain(Pp.double(), xp.double(), 1.0,
                                            lin, ang)
    ex, eP = max_abs(x_k, x_t), max_abs(P_k, P_t)
    check(failures, ex <= TOL["predict_x"],
          f"predict x err {ex:.3e} <= {TOL['predict_x']}")
    check(failures, eP <= TOL["predict_P"],
          f"predict P err {eP:.3e} <= {TOL['predict_P']}")
    check(failures, torch.equal(P_k[13:, 13:], Pp[13:, 13:]),
          "predict P[13:, 13:] passes through bit-exact")
    check(failures, torch.equal(P_k, P_k.T), "predict P' exactly symmetric")
    macs = 2 * 13 * 13 * (N - 13) + 13 * 13 * 2 * (13 * 13 + 13)
    rows["predict"] = dict(
        max_abs_err=max(ex, eP),
        bytes=4 * (2 * N * N + 2 * N), flops=2 * macs,
        kernel=lambda: predict_kernel.predict(Pp, xp, 1.0, lin, ang),
        plain=lambda: predict_kernel.predict_plain(Pp, xp, 1.0, lin, ang))

    # ---- measure
    feats, is_xyz, active, cam7 = _measure_scene(rng, F)
    feats, cam7 = torch.tensor(feats, **f32), torch.tensor(cam7, **f32)
    is_xyz = torch.tensor(is_xyz, device=dev)
    active = torch.tensor(active, device=dev)
    got = measure_kernel.measure(camera, cam7, feats, is_xyz, active)
    ref = measure_kernel.measure_plain(camera, cam7.double(), feats.double(),
                                       is_xyz, active)
    check(failures, torch.equal(got[3], ref[3]),
          f"measure visibility equal ({int(ref[3].sum())} of {F} visible)")
    m = ref[3]
    err = 0.0
    for name, a, b in zip(("uv", "Hc7", "Hf"), ref[:3], got[:3]):
        a, b = a[m], b[m].double()
        lim = TOL["measure_rtol"] * (a.abs() + max(float(a.abs().max()), 1.0))
        worst = float(((b - a).abs() / lim).max())
        err = max(err, max_abs(a, b))
        check(failures, worst <= 1.0,
              f"measure {name} within rtol 1e-6 (worst {worst:.3f} of the "
              f"bound, abs err {max_abs(a, b):.3e})")
    rows["measure"] = dict(
        max_abs_err=err,
        bytes=4 * (7 + 6 * F) + 2 * F + 4 * (2 + 14 + 12) * F + F,
        flops=600 * F,
        kernel=lambda: measure_kernel.measure(camera, cam7, feats, is_xyz,
                                              active),
        plain=lambda: measure_kernel.measure_plain(camera, cam7, feats,
                                                   is_xyz, active))

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
    # the work the function needs on this run's data: only the Mu used rows
    # of HP and S carry data; S^-1 (Mu^3 multiply-adds), W = S^-1 HP, the
    # downdate D = HP^T W once (D^T is the same numbers) and dx = W^T res
    Mu = int(use.sum()) * 2
    rows["update"] = dict(
        max_abs_err=max(e["x"], e["P"]), checks=e,
        bytes=4 * (2 * N * N + 2 * N + Mu * N + Mu * Mu + 4 * F) + F,
        flops=2 * Mu ** 3 + 2 * Mu * Mu * N + 2 * Mu * N * N + 2 * Mu * N,
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
    end_phase("kernels (checks)", failures)

    for name, row in rows.items():
        row["ms"] = graph_ms(row["kernel"])
        row["eager_ms"] = events_ms(row["kernel"], EAGER_REPS)
        row["plain_ms"] = events_ms(row["plain"], PLAIN_REPS)
        row["bound_ms"], row["bound_by"] = bound_ms(row["bytes"],
                                                    row["flops"])
        print(f"  {name}: {row['ms'] * 1e3:.2f} us/launch on the device "
              f"(eager {row['eager_ms'] * 1e3:.2f} us), plain "
              f"{row['plain_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
              f"({row['bytes']} B, {row['flops']} flop)", flush=True)
        del row["kernel"], row["plain"]
    return rows


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
    for spec in KERNELS.values():
        spec["module"].LAUNCHES.reset()
    t0 = time.perf_counter()
    state, records = replay.run_uploaded(runtime, ulog)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: spec["module"].LAUNCHES.count
                for name, spec in KERNELS.items()}
    fps = T_FRAMES / elapsed
    print(f"  main path: {T_FRAMES} frames in {elapsed:.4f} s = "
          f"{fps:.2f} frames/s (bootstrap included)", flush=True)
    print(f"  launches: {launches}", flush=True)

    # the same replay once more under PyTorch's sync debug mode, counting
    # the host syncs by the line that caused them
    sync_sites: collections.Counter = collections.Counter()

    def on_warning(message, category, filename, lineno, *rest):
        if "synchronizing CUDA operation" in str(message):
            sync_sites[f"{Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        replay.run_uploaded(runtime, ulog)
        torch.cuda.synchronize()
        elapsed2 = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum(sync_sites.values())
    print(f"  second replay (sync debug mode): {T_FRAMES / elapsed2:.2f} "
          f"frames/s, {syncs} host syncs ({syncs / T_FRAMES:.3f} per "
          f"frame): {dict(sync_sites)}", flush=True)

    # and once more under torch.profiler, for the time of each phase
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay.run_uploaded(runtime, ulog)
        torch.cuda.synchronize()
    phase_ms = phase_times(prof, T_FRAMES)
    print("  per-phase ms/frame under the profiler (host, device of "
          "PyTorch's kernels): "
          + ", ".join(f"{k} {v['host_ms']:.4f} {v['device_ms']:.4f}"
                      for k, v in phase_ms.items()), flush=True)

    T = T_FRAMES
    check(failures, launches["predict"] == T, f"predict launches {T}")
    check(failures, launches["measure"] == 2 * T, f"measure launches {2 * T}")
    check(failures, launches["update"] == 2 * T, f"update launches {2 * T}")
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
                phase_ms=phase_ms, record_s=record_s,
                sync_sites=dict(sync_sites),
                healthy=healthy, mean_matched=float(matched.mean()),
                mean_inliers=float(inl.mean()),
                replay_vs_recording=same, path_update=path_update)


# ----------------------------------------------------------------- phase 4

def phase_replay(path: dict, failures: list) -> dict:
    print("== phase 4: float64 CPU replay", flush=True)
    cfg64 = SlamConfig(dtype="float64")
    rt64 = SlamRuntime(cfg64, device="cpu")
    t0 = time.perf_counter()
    _, recs64 = replay.replay_records(rt64, path["log"])
    cpu_s = time.perf_counter() - t0
    gpu = np.stack([r.x_cam.double().cpu().numpy()
                    for r in path["records"]])
    ref = np.stack([r.x_cam.numpy() for r in recs64])
    sigma = np.array([math.sqrt(max(float(torch.trace(r.P_cam[0:3, 0:3])),
                                    0.0)) for r in recs64])
    dev = np.linalg.norm(gpu[:, 0:3] - ref[:, 0:3], axis=1)
    same_inliers = np.array([
        bool(torch.equal(a.inliers.cpu(), b.inliers))
        for a, b in zip(path["records"], recs64)])
    same_visible = np.array([
        bool(torch.equal(a.visible.cpu(), b.visible))
        for a, b in zip(path["records"], recs64)])
    worst = int(np.argmax(dev))
    print(f"  CPU float64 replay {cpu_s:.1f} s; camera-position deviation "
          f"max {dev.max():.3e}, mean {dev.mean():.3e}, final {dev[-1]:.3e}"
          f"; f64 sigma_r final {sigma[-1]:.3e}", flush=True)
    print(f"  inlier masks identical on {same_inliers.mean():.3f} of frames, "
          f"visibility on {same_visible.mean():.3f}", flush=True)
    check(failures, bool((dev <= REPLAY_TOL).all()),
          f"deviation <= {REPLAY_TOL} on every frame (worst frame "
          f"{worst + 1}: {dev[worst]:.3e})")
    check(failures, same_inliers.mean() >= REPLAY_MASKS_SAME,
          f"inlier masks identical on >= {REPLAY_MASKS_SAME} of frames")
    check(failures, same_visible.mean() >= REPLAY_MASKS_SAME,
          f"visibility masks identical on >= {REPLAY_MASKS_SAME} of frames")
    return dict(cpu_s=cpu_s, dev_max=float(dev.max()),
                dev_mean=float(dev.mean()), dev_final=float(dev[-1]),
                sigma_final=float(sigma[-1]),
                inliers_same=float(same_inliers.mean()),
                visible_same=float(same_visible.mean()),
                dev_per_frame=dev.tolist(), sigma_per_frame=sigma.tolist())


# ------------------------------------------------------------------- main

def main() -> int:
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
    camera = cam_mod.Camera.from_calibration(cfg.camera)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = phase_kernels(cfg, camera)

    failures: list = []
    path = phase_path(cfg, failures)
    end_phase("path", failures)
    failures = []
    rep = phase_replay(path, failures)
    end_phase("replay", failures)

    T = T_FRAMES
    kernels = []
    for name, spec in KERNELS.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": path["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "eager_ms": row["eager_ms"],
            "launches_per_frame": path["launches"][name] / T})
    report.update(kernels=kernels, update_checks=rows["update"]["checks"],
                  path_update_checks=path["path_update"],
                  path={k: path[k] for k in (
                      "fps", "fps_second", "elapsed_s", "syncs", "sync_sites",
                      "phase_ms",
                      "record_s",
                      "healthy", "mean_matched", "mean_inliers",
                      "replay_vs_recording", "launches")},
                  frames=T, syncs_per_frame=path["syncs"] / T, replay=rep)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"frames/s {path['fps']:.2f} over {T} frames, host syncs/frame "
          f"{path['syncs'] / T:.3f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
