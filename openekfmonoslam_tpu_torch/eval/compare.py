"""Compare two runs' trajectories: ATE / RPE / scale between output.yml
(or records.jsonl) dumps (the port's copy of the JAX package's
eval/compare.py, over the port's trajectory and result_reader).

The reference's evaluation story is diffing runs against its MATLAB
implementation via resultReader-exported series (State::showWithMatlab
Format, resultReader/main.cpp:82-163).  This tool is the direct interface:

    python -m openekfmonoslam_tpu_torch.eval.compare runA/output.yml runB/output.yml

Prints ATE RMSE (after Umeyama similarity alignment -- monocular scale is
arbitrary), RPE RMSE, per-run scale factors, and match-count deltas.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from openekfmonoslam_tpu_torch.eval import trajectory
from openekfmonoslam_tpu_torch.eval.result_reader import read_output_yml


def load_records(path: str) -> list:
    if path.endswith(".jsonl"):
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    return read_output_yml(path)


def compare(path_a: str, path_b: str) -> dict:
    ra = load_records(path_a)
    rb = load_records(path_b)
    n = min(len(ra), len(rb))
    pa = trajectory.positions_from_records(ra[:n])
    pb = trajectory.positions_from_records(rb[:n])
    va = trajectory.velocities_from_records(ra[:n])
    vb = trajectory.velocities_from_records(rb[:n])
    out = {
        "frames_compared": n,
        "ate_rmse_aligned": trajectory.ate_rmse(pa, pb, align=True),
        "ate_rmse_raw": trajectory.ate_rmse(pa, pb, align=False),
        "rpe_rmse": trajectory.rpe_rmse(pa, pb),
        "scale_factor_a": trajectory.scale_factor(va),
        "scale_factor_b": trajectory.scale_factor(vb),
        "mean_matches_a": float(np.mean([r["total_matches"]
                                         for r in ra[:n]])),
        "mean_matches_b": float(np.mean([r["total_matches"]
                                         for r in rb[:n]])),
    }
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    result = compare(argv[0], argv[1])
    for k, v in result.items():
        print(f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
