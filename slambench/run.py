"""Run one cell of the benchmark once (see BENCHMARK.json):

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It loads the program, makes the cell's frames
from the seed, bootstraps and warms up (set-up), then drives the cell's
entry closed loop for ``--seconds`` (``--trace 0``: the end-to-end
metrics) or for the traffic's ``trace_steps`` calls under the profiler
(``--trace 1``: the per-layer metrics), and last checks what the timed
path produced against the plain reference (reference/check.py).  The last
line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

# One host thread for the process's CPU math, set before numpy and torch
# load: the timed path's host work is Python dispatch, and idle OpenMP
# workers spinning beside it made runs of the same code differ by 20-40%.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slambench import drivers, trace  # noqa: E402
from slambench.reference import check  # noqa: E402
from slambench.reference.ekf import Params  # noqa: E402
from slambench.reference.vision import FrontEnd  # noqa: E402

# modules that may not be loaded in the process that prints a result:
# JAX and the JAX package (compared by whole top-level name: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "openekfmonoslam_tpu")


class Refused(RuntimeError):
    """The run cannot give a result on this machine."""


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def reader(name: str):
    """The per-layer metric ``name``'s reader (metrics/<name>.py)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float:
    """The q-th percentile of all samples, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def machine_line(device) -> str:
    cpu = "unknown CPU"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return (f"host: {cpu}, {os.cpu_count()} cores visible, "
            f"{len(os.sched_getaffinity(0))} usable; torch {torch.__version__}"
            f", CUDA {torch.version.cuda}; {device_name(device)}")


def device_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"


def judge(cfg: dict, kept: dict, limits: dict) -> dict:
    """The compared numbers, each {"value", "limit"}, from the samples the
    driver kept (reference/check.py)."""
    p = Params.from_config(cfg)
    front = FrontEnd(cfg)
    clock = [time.perf_counter()]
    state_gap, P_gap, wrong = 0.0, 0.0, []
    fe = check.FrontResult()
    for b in kept["bootstrap"]:
        dx, dP, w = check.check_bootstrap(p, b["after"], b["uv"], b["ok"],
                                          b["slot"])
        state_gap, P_gap = max(state_gap, dx), max(P_gap, dP)
        wrong += [f"bootstrap of stream {b['stream']}: {x}" for x in w]
        r = check.check_bootstrap_front(front, p, b["gray"], b["after"],
                                        b["uv"], b["ok"], b["slot"])
        for k in ("cand_off", "cand_edges", "desc_bits"):
            setattr(fe, k, getattr(fe, k) + getattr(r, k))
    clock.append(time.perf_counter())
    pred_gap, knife, followed = 0.0, 0, 0
    for prog in kept["frames"]:
        at = f"frame {prog.record['t']} of stream {prog.record['stream']}"
        r = check.check_step(p, prog)
        clock.append(time.perf_counter())
        wrong += [f"{at}: {w}" for w in r.wrong]
        if r.knife:
            knife += 1
            print(f"knife edge at {at}: " + "; ".join(r.knife), flush=True)
        if r.followed:
            followed += 1
            state_gap = max(state_gap, r.state_gap)
            P_gap = max(P_gap, r.P_gap)
        pred_gap = max(pred_gap, r.pred_gap)
        f = check.check_front(front, p, prog)
        if f.cand_off or f.desc_bits:
            print(f"front end at {at}: {f.cand_off} candidates and "
                  f"{f.desc_bits} descriptor bits off", flush=True)
        for k in ("dz_sum", "alike", "match_off", "cand_off", "cand_edges",
                  "desc_bits"):
            setattr(fe, k, getattr(fe, k) + getattr(f, k))
        clock.append(time.perf_counter())
    for w in wrong:
        print(f"wrong decision: {w}", flush=True)
    n = len(kept["frames"])
    d = np.diff(clock)
    print(f"compared: {len(kept['bootstrap'])} bootstraps and {n} frames, "
          f"{followed} followed, {knife} knife edges, {fe.cand_edges} "
          f"candidates tied; largest prediction "
          f"gap {pred_gap:.3e} px; reference seconds: bootstraps "
          f"{d[0]:.2f}, filter {d[1::2].sum():.2f}, front end "
          f"{d[2::2].sum():.2f}", flush=True)
    values = {"state_gap": state_gap, "P_gap": P_gap,
              "wrong": float(len(wrong)),
              "z_gap": fe.dz_sum / fe.alike if fe.alike else 0.0,
              "match_off": float(fe.match_off),
              "cand_off": float(fe.cand_off),
              "desc_bits": float(fe.desc_bits),
              "followed_share": followed / n if n else 0.0}
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def passes(compared: dict) -> bool:
    ok = True
    for k, c in compared.items():
        if k == "followed_share":
            ok &= c["value"] >= c["limit"]
        else:
            ok &= math.isfinite(c["value"]) and c["value"] <= c["limit"]
    return ok


def main(argv=None, device: str = "cuda") -> int:
    """One run; ``device`` "cpu" skips the look for a card (the tests
    drive the rest of a run on the CPU that way)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, cfg, traffic = load_cell(args.workload)
    limits = json.loads((HERE / "limits" / f"{cell['config']}.json"
                         ).read_text())
    cuda = torch.device(device).type == "cuda"
    if cuda:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            raise Refused(f"the cell needs {cell['chips']} CUDA device(s); "
                          f"this machine has {have}")
        torch.cuda.reset_peak_memory_stats()
    print(machine_line(device), flush=True)
    t_ready = time.perf_counter()
    drv = drivers.make(traffic["entry"], cfg, traffic, args.seed, device)
    t_frames = time.perf_counter()
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s:.3f} s: imports and the card "
          f"{t_ready - T_START:.3f}, textures {t_frames - t_ready:.3f}, "
          f"{drv.setup_line}", flush=True)

    out = {}
    if args.trace:
        n = int(traffic["trace_steps"])
        tr = trace.traced(lambda: drv.run_steps(n), drv.settle, drv.n_state,
                          drv.n_slots)
        print("host syncs by site: " + json.dumps(dict(tr.syncs)),
              flush=True)
        metrics = {}
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        attempted, failed = tr.frames, drv.failed
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        out["breakdown"] = tr.breakdown()
    else:
        samples, frames = drv.window(args.seconds)
        attempted, failed = frames, drv.failed
        if not samples:
            raise Refused("no frame completed inside the window")
        metrics = {
            "setup_s": {"value": setup_s, "unit": "s"},
            "frames_per_s": {"value": frames / args.seconds,
                             "unit": "frames/s"},
            "frame_ms_p95": {"value": percentile(samples, 95) * 1e3,
                             "unit": "ms"}}
        print(f"window: {len(samples)} calls, {frames} frames; frame ms "
              f"median {statistics.median(samples) * 1e3:.4f}, p95 "
              f"{metrics['frame_ms_p95']['value']:.4f}; tracking: "
              f"{drv.health()}", flush=True)
        extra = {}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": device_name(device), "count": cell["chips"],
              "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                    if cuda else 0), **extra}

    kept = drv.collect()
    drv.close()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    compared = judge(cfg, kept, limits)
    print(f"reference: {time.perf_counter() - t:.1f} s", flush=True)
    correct = passes(compared) and failed == 0

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"refused: loaded in this process: {loaded}", file=sys.stderr)
        return 3
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device, **out,
           "compared": compared}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        sys.exit(2)
