#!/usr/bin/env python3
"""Where the predict and measure kernels spend their time on the card.

    python3 tools/small_kernel_clocks.py    # from the repository root;
                                            # needs one CUDA device and nvcc
    python3 tools/small_kernel_clocks.py --before OLD
        # also the kernels of another checkout OLD of the repository (its
        # csrc/predict.cu and csrc/measure.cu as of the one-role predict
        # and the unmasked measure), held against this tree's bit for bit

Builds instrumented copies of csrc/predict.cu and csrc/measure.cu into
build/torch_kernels/clocks/, with the stage marks of csrc/common.cuh
defined: lane 0 of every warp records clock64 once a stage's result is
computed.  The copies run on phase 2's inputs of chip_smoke.py (N = 640
and 1024; F = 96) and the script prints each stage's cycles a warp, mean
and max, by the role of the warp's block:

  predict   the corner block: prologue (the motion model's scalars), F
            (its entries and the barrier that publishes them), Qc and
            P00 F^T with x'[0:13], the corner; strip blocks: prologue, F,
            staging (the strip loads' arrival), strips; copy blocks:
            loads, stores;
  measure   trig (with the slot loads), Newton, the Jacobians staged in
            shared memory, the block's coalesced stores; and the Newton
            loop's mean iterations before its exit over 200 scenes of
            phase 2's kind.

With --before OLD, OLD's two kernels get the same marks at text anchors
(its predict: prologue, F/Qc, staging, the row loop; its measure: trig,
Newton, and the Jacobians with their stores, which interleave there), and
are built as they are too: their outputs (P', x'; uv, Hc7 and Hf masked as
OLD's caller masks them) are held against this tree's kernels' bit for bit,
on phase 2's inputs and on 300 random ones of each kernel, and their
device us a launch (CUDA graphs of 200) print beside this tree's.
It also counts the device kernels a call of
filter/measure.predict_measurements launches under torch.profiler, in
this tree and in OLD (a subprocess with OLD's package on the path).

The card's name and power limit are printed first, and the empty
kernel's graph us a launch (the per-launch floor).  Results also go to
chiprun_out/small_kernel_clocks.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SLOTS = 8
CLOCK_WARPS = 8192
COUNT_CALLS = 20          # profiled calls of predict_measurements
ITER_SCENES = 200         # scenes for the Newton loop's iteration count

HEAD = f'''
#define EKF_STAGE_CLOCKS
#include <cstdint>
#include <cuda_runtime.h>
__device__ long long ekf_clk[{CLOCK_WARPS}][{SLOTS}];
#define EKF_WARP_ID (((blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x \\
                      + threadIdx.x) >> 5)
#define EKF_MARK(slot, dep) do {{ \\
    asm volatile("" :: "f"((float)(dep)) : "memory"); \\
    if ((threadIdx.x & 31) == 0) ekf_clk[EKF_WARP_ID][slot] = clock64(); \\
}} while (0)
#define EKF_NOTE(slot, v) do {{ \\
    if ((threadIdx.x & 31) == 0) ekf_clk[EKF_WARP_ID][slot] = (long long)(v); \\
}} while (0)
extern "C" int ekf_clocks(long long* host, int warps) {{
    return (int)cudaMemcpyFromSymbol(host, ekf_clk,
                                     (size_t)warps * {SLOTS} * 8);
}}
extern "C" int ekf_clocks_clear() {{
    static long long zero[{CLOCK_WARPS}][{SLOTS}];
    return (int)cudaMemcpyToSymbol(ekf_clk, zero, sizeof(zero));
}}
'''

# the marks of the earlier kernels, at text anchors: (anchor, text put
# before it, text put after it); each anchor must occur once
OLD_MARKS = {
    "predict.cu": [
        ("    const int tid = threadIdx.x;\n", "", "    EKF_MARK(0, 0.0f);\n"),
        ("    // F and Qc, one entry per thread", "    EKF_MARK(1, 0.0f);\n",
         ""),
        ("        sQ[i][j] = q;\n    }\n    __syncthreads();\n", "",
         "    EKF_MARK(2, 0.0f);\n"),
        ("    const int j = j0 + tid;\n", "    EKF_MARK(3, 0.0f);\n", ""),
        ("        P_out[o] = v;\n    }\n", "", "    EKF_MARK(4, 0.0f);\n"),
    ],
    "measure.cu": [
        ("    if (f >= F) return;\n", "", "    EKF_MARK(0, 0.0f);\n"),
        ("    const float cth = cosf(theta), sth = sinf(theta);\n", "",
         "    EKF_MARK(1, cph + sph + cth + sth);\n"),
        ("    // final step: gp", "    EKF_MARK(2, rd);\n    EKF_NOTE(5, 10);\n",
         ""),
        ("    vis_out[f] = (active[f] != 0) && fov && img;\n", "",
         "    EKF_MARK(4, 0.0f);\n"),
    ],
}
PREDICT_STAGES = {1: "prologue", 2: "F", 3: "staging (loads)",
                  4: "strips"}
CORNER_STAGES = {1: "prologue", 2: "F", 3: "x', Qc and P00 F^T",
                 4: "corner"}
COPY_STAGES = {3: "loads", 4: "stores"}
OLD_COPY_STAGES = {1: "prologue", 2: "F/Qc", 3: "staging", 4: "row loop"}
MEASURE_STAGES = {1: "trig", 2: "Newton", 3: "Jacobians, staged",
                  4: "stores"}
OLD_MEASURE_STAGES = {1: "trig", 2: "Newton", 4: "Jacobians and stores"}


def old_source(name: str, text: str) -> str:
    """An earlier kernel's source with the stage marks at its anchors."""
    for anchor, before, after in OLD_MARKS[name]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} not found once")
        text = text.replace(anchor, before + anchor + after)
    return text


def build(tag: str, source: str, csrc: Path, clocks: bool) -> ctypes.CDLL:
    """One kernel source into its own library (with the marks' head when
    ``clocks``), with the launchers' ctypes signatures set."""
    from openekfmonoslam_tpu_torch.ops import cuda_lib

    out = cuda_lib.BUILD_DIR / "clocks"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{tag}.cu"
    cu.write_text((HEAD if clocks else "") + source)
    so = out / f"lib{tag}.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(csrc),
                    str(cu), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("ekf_predict", "ekf_measure"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = cuda_lib._SIGNATURES[name]
            fn.restype = ctypes.c_int
    if clocks:
        lib.ekf_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ekf_clocks_clear.argtypes = []
    return lib


def _ok(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def read_clocks(lib, warps: int) -> np.ndarray:
    buf = (ctypes.c_longlong * (warps * SLOTS))()
    torch.cuda.synchronize()
    _ok(lib.ekf_clocks(buf, warps), "ekf_clocks")
    return np.array(buf, dtype=np.int64).reshape(warps, SLOTS)


def stage_cycles(clk: np.ndarray, stages: dict) -> dict:
    """{stage: {"mean", "max"}} cycles a warp from slot 0 through the
    slots of ``stages``, over the warps that recorded them all; plus the
    whole warp."""
    need = [0] + list(stages)
    rows = clk[(clk[:, need] != 0).all(axis=1)]
    if not len(rows):
        return {}
    out, prev = {}, rows[:, 0]
    for slot, name in stages.items():
        d = rows[:, slot] - prev
        prev = rows[:, slot]
        out[name] = {"mean": float(d.mean()), "max": int(d.max())}
    total = prev - rows[:, 0]
    out["warp"] = {"mean": float(total.mean()), "max": int(total.max()),
                   "warps": int(len(rows))}
    return out


# ------------------------------------------------------------- inputs

def phase2_inputs(dev, N: int):
    """phase 2's predict and measure inputs (chip_smoke.py phase_kernels:
    one generator, seed 0, the state first)."""
    import chip_smoke

    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=dev)
    P, x = (torch.tensor(a, **f32) for a in chip_smoke._spd_state(rng, N))
    feats, is_xyz, active, cam7 = chip_smoke._measure_scene(rng, 96)
    return (P, x), (torch.tensor(cam7, **f32), torch.tensor(feats, **f32),
                    torch.tensor(is_xyz, device=dev),
                    torch.tensor(active, device=dev))


def predict_call(lib, P, x, lin, ang):
    P_out, x_out = torch.empty_like(P), torch.empty_like(x)
    from openekfmonoslam_tpu_torch.ops import cuda_lib

    def launch():
        _ok(lib.ekf_predict(P.data_ptr(), x.data_ptr(), P_out.data_ptr(),
                            x_out.data_ptr(), P.shape[0], 1.0, lin, ang,
                            cuda_lib.stream_of(P)), "ekf_predict")
    return launch, (x_out, P_out)


def measure_call(lib, camera, cam7, feats, is_xyz, active, hc_cols: int,
                 quirks: bool = False):
    from openekfmonoslam_tpu_torch.ops import cuda_lib

    F, dev = feats.shape[0], feats.device
    uv = torch.empty((F, 2), device=dev)
    hc = torch.empty((F, 2, hc_cols), device=dev)
    hf = torch.empty((F, 2, 6), device=dev)
    vis = torch.empty((F,), dtype=torch.bool, device=dev)
    cam = cuda_lib.CamParams.from_camera(camera)

    def launch():
        _ok(lib.ekf_measure(cam7.data_ptr(), feats.data_ptr(),
                            is_xyz.data_ptr(), active.data_ptr(),
                            uv.data_ptr(), hc.data_ptr(), hf.data_ptr(),
                            vis.data_ptr(), F, int(quirks),
                            ctypes.byref(cam), cuda_lib.stream_of(feats)),
            "ekf_measure")
    return launch, (uv, hc, hf, vis)


def mask_like_old_caller(uv, Hc7, Hf, visible, is_xyz):
    """The earlier caller's masking (filter/measure.py before the kernel
    wrote it), in float32 on the card."""
    F = Hc7.shape[0]
    vis = visible[:, None, None].to(Hc7.dtype)
    Hc = torch.cat([Hc7 * vis, torch.zeros((F, 2, 6), device=Hc7.device)],
                   dim=-1)
    first3 = torch.arange(6, device=Hf.device) < 3
    Hf = Hf * vis * (first3[None, :] | ~is_xyz[:, None])[:, None, :].to(
        Hf.dtype)
    return torch.where(visible[:, None], uv, torch.zeros_like(uv)), Hc, Hf


# ------------------------------------------------------------- stages

def predict_roles(N: int, old: bool) -> list:
    """The role of each warp's block: the new kernel's 1-D grid (the
    corner block, the top and left strip blocks of LINE_THREADS threads a
    line, then the copy blocks; 8 warps a block) or the earlier one's 2-D
    grid of 128 x 16 tiles (4 warps a block)."""
    import re

    from openekfmonoslam_tpu_torch.ops import cuda_lib

    if old:
        gx, gy = -(-N // 128), -(-N // 16)
        roles = []
        for lin in range(gx * gy):
            bx, by = lin % gx, lin // gx
            role = "strip" if (bx == 0 or by == 0) else "copy only"
            roles += [role] * 4
        return roles
    line_threads = int(re.search(
        r"constexpr int LINE_THREADS = (\d+);",
        (cuda_lib.CSRC / "predict.cu").read_text()).group(1))
    n_strip = -(-line_threads * (N - 13) // 256)
    vec = 4 if N % 4 == 0 and N >= 16 else 1
    c0 = 16 if vec == 4 else 13
    copy_v = (N - 13) * ((N - c0) // vec)
    n_copy = -(-copy_v // (256 * 16 // vec))
    return (["corner"] * 8 + ["top strip"] * (8 * n_strip)
            + ["left strip"] * (8 * n_strip) + ["copy"] * (8 * n_copy))


def predict_stages(lib, P, x, lin, ang, old: bool) -> dict:
    N = P.shape[0]
    launch, _ = predict_call(lib, P, x, lin, ang)
    for _ in range(5):
        launch()
    _ok(lib.ekf_clocks_clear(), "clear")
    launch()
    roles = predict_roles(N, old)
    clk = read_clocks(lib, len(roles))
    out = {}
    for role in dict.fromkeys(roles):
        rows = clk[[r == role for r in roles]]
        if old:
            stages = OLD_COPY_STAGES
        else:
            stages = {"copy": COPY_STAGES, "corner": CORNER_STAGES}.get(
                role, PREDICT_STAGES)
        st = stage_cycles(rows, stages)
        if st:
            out[role] = st
    return out


def measure_stages(lib, camera, inputs, old: bool) -> dict:
    launch, _ = measure_call(lib, camera, *inputs, hc_cols=7 if old else 13)
    for _ in range(5):
        launch()
    _ok(lib.ekf_clocks_clear(), "clear")
    launch()
    F = inputs[1].shape[0]
    clk = read_clocks(lib, -(-F // 32))
    return stage_cycles(clk, OLD_MEASURE_STAGES if old else MEASURE_STAGES)


def newton_iterations(lib, camera, dev) -> dict:
    """The Newton loop's iterations before its exit, a warp, over
    ITER_SCENES scenes of phase 2's kind at F = 96."""
    import chip_smoke

    its = []
    f32 = dict(dtype=torch.float32, device=dev)
    for seed in range(ITER_SCENES):
        feats, is_xyz, active, cam7 = chip_smoke._measure_scene(
            np.random.default_rng(1000 + seed), 96)
        launch, _ = measure_call(
            lib, camera, torch.tensor(cam7, **f32),
            torch.tensor(feats, **f32), torch.tensor(is_xyz, device=dev),
            torch.tensor(active, device=dev), hc_cols=13)
        _ok(lib.ekf_clocks_clear(), "clear")
        launch()
        its += read_clocks(lib, 3)[:, 5].tolist()
    its = np.array(its)
    return {"mean": float(its.mean()), "min": int(its.min()),
            "max": int(its.max()), "warps": int(len(its)),
            "share_full_10": float(np.mean(its == 10))}


def random_agreement(old_plain: dict, camera, dev, trials: int = 300
                     ) -> dict:
    """How many of ``trials`` random inputs give this tree's kernels and
    OLD's different bits: predict on phase 2's P with camera states near
    rest (a near-identity quaternion, angular velocities from 1e-5 to
    1e-1 a frame), measure (both variants, OLD's outputs masked as its
    caller masked them) on scenes of 96 slots with bearings all round,
    inverse depths from 0 to 3, XYZ, zeroed and inactive slots."""
    from openekfmonoslam_tpu_torch.ops import measure_kernel, predict_kernel

    rng = np.random.default_rng(12)
    f32 = dict(dtype=torch.float32, device=dev)
    P = phase2_inputs(dev, 640)[0][0]
    out = {"predict": 0, "measure": 0, "measure_quirks": 0,
           "trials": trials}
    for _ in range(trials):
        x = rng.normal(0, 1e-3, 640)
        q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.01, 4)
        x[3:7] = q / np.linalg.norm(q)
        x[10:13] = rng.normal(0, 1.0, 3) * 10.0 ** rng.uniform(-5, -1)
        xt = torch.tensor(x, **f32)
        launch, got = predict_call(old_plain["predict"], P, xt, 1e-4, 1e-4)
        launch()
        want = predict_kernel.predict(P, xt, 1.0, 1e-4, 1e-4)
        out["predict"] += not all(torch.equal(a, b)
                                  for a, b in zip(got, want))
        F = 96
        qc = rng.normal(size=4)
        cam7 = np.concatenate([rng.normal(0, 1.0, 3), qc / np.linalg.norm(qc)])
        feats = np.zeros((F, 6))
        feats[:, 0:3] = cam7[:3] + rng.normal(0, 1.0, (F, 3))
        feats[:, 3] = rng.uniform(-np.pi, np.pi, F)
        feats[:, 4] = rng.uniform(-1.5, 1.5, F)
        feats[:, 5] = rng.uniform(0.0, 3.0, F)
        is_xyz = rng.random(F) < 0.3
        feats[is_xyz, 0:3] = cam7[:3] + rng.normal(0, 3, (is_xyz.sum(), 3))
        feats[is_xyz, 3:] = 0
        feats[rng.random(F) < 0.1] = 0.0
        args = (torch.tensor(cam7, **f32), torch.tensor(feats, **f32),
                torch.tensor(is_xyz, device=dev),
                torch.tensor(rng.random(F) < 0.8, device=dev))
        for quirks, key in ((False, "measure"), (True, "measure_quirks")):
            launch, o = measure_call(old_plain["measure"], camera, *args,
                                     hc_cols=7, quirks=quirks)
            launch()
            want = mask_like_old_caller(*o, args[2]) + (o[3],)
            got = measure_kernel.measure(camera, *args, quirks=quirks)
            out[key] += not all(torch.equal(a, b)
                                for a, b in zip(got, want))
    return out


# ------------------------------------------------------------- launches

def count_measure_launches(root: Path) -> float:
    """Device kernels (with copies and memsets) a call of
    predict_measurements on a fresh s3 state, under torch.profiler, with
    the package of ``root``."""
    sys.path.insert(0, str(root))
    from torch.profiler import ProfilerActivity, profile

    from openekfmonoslam_tpu_torch.config import SlamConfig
    from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
    from openekfmonoslam_tpu_torch.filter import measure as meas_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    rt = SlamRuntime(SlamConfig())
    state = rt.make_initial_state()
    for _ in range(3):
        meas_mod.predict_measurements(state, rt.camera)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(COUNT_CALLS):
            meas_mod.predict_measurements(state, rt.camera)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / COUNT_CALLS


def count_in_subprocess(root: Path) -> float:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--count-launches",
         str(root)], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(root)), cwd=str(root))
    return float(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------- main

def main(argv: list) -> int:
    if "--count-launches" in argv:
        print(count_measure_launches(
            Path(argv[argv.index("--count-launches") + 1])))
        return 0
    if not torch.cuda.is_available():
        print("small_kernel_clocks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from openekfmonoslam_tpu_torch.config import SlamConfig
    from openekfmonoslam_tpu_torch.core.camera import Camera
    from openekfmonoslam_tpu_torch.ops import (cuda_lib, measure_kernel,
                                               predict_kernel)

    smi = chip_smoke.smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = SlamConfig()
    camera = Camera.from_calibration(cfg.camera)
    lin, ang = cfg.ekf.linear_accel_sd ** 2, cfg.ekf.angular_accel_sd ** 2
    lib = cuda_lib.library()
    floor_us = chip_smoke.graph_ms(
        lambda: lib.call("ekf_noop", torch.cuda.current_stream().cuda_stream)
    ) * 1e3
    print(f"empty kernel: {floor_us:.2f} us a launch (CUDA graph of 200)",
          flush=True)
    csrc = cuda_lib.CSRC
    new = {k: build(f"new_{k}", (csrc / f"{k}.cu").read_text(), csrc, True)
           for k in ("predict", "measure")}
    report = {"card": smi, "floor_us": floor_us, "after": {}, "before": {}}
    old_root = (Path(argv[argv.index("--before") + 1]).resolve()
                if "--before" in argv else None)
    if old_root is not None:
        old_csrc = old_root / "openekfmonoslam_tpu_torch" / "csrc"
        texts = {k: (old_csrc / f"{k}.cu").read_text()
                 for k in ("predict", "measure")}
        old = {k: build(f"old_{k}", old_source(f"{k}.cu", t), old_csrc, True)
               for k, t in texts.items()}
        old_plain = {k: build(f"oldplain_{k}", t, old_csrc, False)
                     for k, t in texts.items()}

    meas = phase2_inputs(dev, 640)[1]
    for N in (640, 1024):
        P, x = phase2_inputs(dev, N)[0]
        row = report["after"][f"predict_n{N}"] = {
            "stages": predict_stages(new["predict"], P, x, lin, ang, False),
            "us": chip_smoke.graph_ms(
                lambda: predict_kernel.predict(P, x, 1.0, lin, ang)) * 1e3}
        row["instrumented_us"] = chip_smoke.graph_ms(
            predict_call(new["predict"], P, x, lin, ang)[0]) * 1e3
        if old_root is None:
            continue
        launch, got = predict_call(old_plain["predict"], P, x, lin, ang)
        launch()
        want = predict_kernel.predict(P, x, 1.0, lin, ang)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        report["before"][f"predict_n{N}"] = {
            "stages": predict_stages(old["predict"], P, x, lin, ang, True),
            "us": chip_smoke.graph_ms(launch) * 1e3,
            "bit_identical_to_after": same}
    for quirks in (False, True):
        key = "measure_quirks" if quirks else "measure"
        row = report["after"][key] = {
            "us": chip_smoke.graph_ms(
                lambda: measure_kernel.measure(camera, *meas,
                                               quirks=quirks)) * 1e3}
        if not quirks:
            row["stages"] = measure_stages(new["measure"], camera, meas,
                                           False)
            row["newton_iterations"] = newton_iterations(new["measure"],
                                                         camera, dev)
        if old_root is None:
            continue
        launch, got = measure_call(old_plain["measure"], camera, *meas,
                                   hc_cols=7, quirks=quirks)
        launch()
        masked = mask_like_old_caller(*got, meas[2])
        want = measure_kernel.measure(camera, *meas, quirks=quirks)
        same = (all(torch.equal(a, b) for a, b in zip(masked, want[:3]))
                and torch.equal(got[3], want[3]))
        report["before"][key] = {"us": chip_smoke.graph_ms(launch) * 1e3,
                                 "bit_identical_to_after": same}
        if not quirks:
            report["before"][key]["stages"] = measure_stages(
                old["measure"], camera, meas, True)
    if old_root is not None:
        report["random_inputs_differing"] = random_agreement(
            old_plain, camera, dev)
        print(f"random inputs whose bits differ from OLD's: "
              f"{report['random_inputs_differing']}", flush=True)
    report["after"]["predict_measurements_launches"] = \
        count_measure_launches(ROOT)
    if old_root is not None:
        report["before"]["predict_measurements_launches"] = \
            count_in_subprocess(old_root)

    for side in ("before", "after"):
        for name, row in report[side].items():
            if not isinstance(row, dict):
                print(f"{side} {name}: {row:.2f}", flush=True)
                continue
            line = f"{side} {name}: {row['us']:.2f} us a launch"
            if "bit_identical_to_after" in row:
                line += (", bit-identical to this tree's: "
                         f"{row['bit_identical_to_after']}")
            if "instrumented_us" in row:
                line += f" (instrumented {row['instrumented_us']:.2f})"
            print(line, flush=True)
            stages = row.get("stages", {})
            groups = stages.items() if "warp" not in stages else [
                ("all warps", stages)]
            for role, st in groups:
                print(f"  {role}: " + ", ".join(
                    f"{k} {v['mean']:.0f} ({v['max']})"
                    for k, v in st.items() if k != "warp")
                    + f"; warp {st['warp']['mean']:.0f} "
                    f"({st['warp']['max']}), {st['warp']['warps']} warps",
                    flush=True)
            if "newton_iterations" in row:
                print(f"  Newton iterations a warp: {row['newton_iterations']}",
                      flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "small_kernel_clocks.json").write_text(json.dumps(report,
                                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
