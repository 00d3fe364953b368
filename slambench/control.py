"""The readings the limits of reference/check.py are set from, for one cell,
in one process on the card:

    python3 slambench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 4 [--faults all|<name>,<name>...]

For each seed it sets the cell up, runs its window for ``--seconds`` and
reads the compared numbers of the program's frames; for the first
``--control-seeds`` it also reads them with the control in the program's
place (the reference in float32 with TF32 products, ``check.control``),
and with ``--faults`` with each of the named faults (or all) that a run
of this cell can have planted in the program (``FAULTS``).  One JSON line
a reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

from slambench import drivers, run  # noqa: E402
from slambench.reference import check  # noqa: E402
from slambench.reference.ekf import Params  # noqa: E402


@contextlib.contextmanager
def unchanged_state():
    """Each step hands back the state it was given (its record as made)."""
    from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
    from openekfmonoslam_tpu_torch.parallel import batch_runner as br

    step, batched = SlamRuntime.step, br.batched_step

    def broken(self, state, gray):
        return state, step(self, state, gray)[1]

    def broken_batched(runtime, states, grays):
        return states, batched(runtime, states, grays)[1]

    SlamRuntime.step, br.batched_step = broken, broken_batched
    try:
        yield
    finally:
        SlamRuntime.step, br.batched_step = step, batched


@contextlib.contextmanager
def moved_pose(metres: float = 1e-3):
    """Each step's pose is moved by ``metres`` along x where it is made."""
    from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
    from openekfmonoslam_tpu_torch.parallel import batch_runner as br

    step, batched = SlamRuntime.step, br.batched_step

    def move(state):
        x = state.x.clone()
        x[..., 0] += metres
        return state._replace(x=x)

    def broken(self, state, gray):
        state, rec = step(self, state, gray)
        return move(state), rec

    def broken_batched(runtime, states, grays):
        states, rec = batched(runtime, states, grays)
        return move(states), rec

    SlamRuntime.step, br.batched_step = broken, broken_batched
    try:
        yield
    finally:
        SlamRuntime.step, br.batched_step = step, batched


@contextlib.contextmanager
def half_the_batch():
    """Only the first half of the streams is stepped: the others' states
    come back as they went in."""
    from openekfmonoslam_tpu_torch.filter.state import SlamState
    from openekfmonoslam_tpu_torch.parallel import batch_runner as br

    batched = br.batched_step

    def broken(runtime, states, grays):
        new, rec = batched(runtime, states, grays)
        half = states.x.shape[0] // 2
        keep = torch.arange(states.x.shape[0], device=states.x.device) < half
        return SlamState(*(torch.where(
            keep.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new, states))), rec

    br.batched_step = broken
    try:
        yield
    finally:
        br.batched_step = batched


@contextlib.contextmanager
def moved_candidates():
    """Each new-feature candidate is moved one pixel along x where it is
    detected."""
    from openekfmonoslam_tpu_torch.engine.step import SlamRuntime

    detect = SlamRuntime.detect_candidates

    def broken(self, *args, **kwargs):
        uv, desc, valid = detect(self, *args, **kwargs)
        one = torch.tensor([1.0, 0.0], dtype=uv.dtype, device=uv.device)
        return uv + valid[..., None].to(uv.dtype) * one, desc, valid

    SlamRuntime.detect_candidates = broken
    try:
        yield
    finally:
        SlamRuntime.detect_candidates = detect


@contextlib.contextmanager
def moved_descriptors():
    """Every descriptor is taken one pixel to the right of its keypoint
    where it is made (the map's and the frame's alike, so matching still
    holds)."""
    from openekfmonoslam_tpu_torch.vision.frontend import Frontend

    describe = Frontend.describe

    def broken(self, aux, yx):
        one = torch.tensor([0, 1], dtype=yx.dtype, device=yx.device)
        return describe(self, aux, yx + one)

    Frontend.describe = broken
    try:
        yield
    finally:
        Frontend.describe = describe


FAULTS = {"unchanged_state": unchanged_state, "moved_pose": moved_pose,
          "half_the_batch": half_the_batch,
          "moved_candidates": moved_candidates,
          "moved_descriptors": moved_descriptors}


def readings(name: str, cfg: dict, traffic: dict, seed: int,
             seconds: float, limits: dict, device: str, fault=None,
             with_control: bool = False) -> list[dict]:
    """The compared numbers of one run of the cell (and of the control on
    the same frames)."""
    drv = drivers.make(traffic["entry"], cfg, traffic, seed, device)
    with fault() if fault else contextlib.nullcontext():
        drv.setup()
        drv.window(seconds)
    kept = drv.collect()
    drv.close()
    out = [dict(workload=name, seed=seed, side="program" if not fault
                else f"fault:{fault.__name__}",
                **{k: v["value"] for k, v in
                   run.judge(cfg, kept, limits).items()})]
    if with_control:
        p = Params.from_config(cfg)
        kept["frames"] = [check.control(p, cfg, prog)
                           for prog in kept["frames"]]
        out.append(dict(workload=name, seed=seed, side="control",
                        **{k: v["value"] for k, v in
                           run.judge(cfg, kept, limits).items()}))
    return out


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--faults", default="",
                    help="'all' or names of FAULTS, comma-separated")
    args = ap.parse_args(argv)
    _, cell, cfg, traffic = run.load_cell(args.workload)
    limits = json.loads((HERE / "limits" / f"{cell['config']}.json"
                         ).read_text())
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        for r in readings(args.workload, cfg, traffic, seed, args.seconds,
                          limits, device,
                          with_control=i < args.control_seeds):
            print(json.dumps(r), flush=True)
        if i < args.control_seeds:
            for name, fault in FAULTS.items():
                if name == "half_the_batch" and traffic["entry"] != "batch":
                    continue
                if args.faults != "all" and name not in args.faults.split(
                        ","):
                    continue
                for r in readings(args.workload, cfg, traffic, seed,
                                  args.seconds, limits, device, fault):
                    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
