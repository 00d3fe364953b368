"""A short run of a cell on the card, untraced and traced: the result line
holds what the contract asks, ``correct`` comes out true, and each
per-layer metric a cell lists is read (the readers find the kernels by the
names the profiler gives them).  Skipped without a CUDA device; run on
the card with ``python -m pytest -m cuda slambench/tests``."""

import json

import pytest
import torch

from slambench import run


def result(capsys, argv):
    assert run.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["s3-live-1cam", "map960-live-1cam"])
def test_cell_on_the_card(capsys, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = result(capsys, ["--workload", cell, "--seed", str(2 ** 31 + 7),
                          "--seconds", "3", "--trace", "0"])
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"setup_s", "frames_per_s",
                                   "frame_ms_p95"}
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    traced = result(capsys, ["--workload", cell, "--seed", str(2 ** 31 + 8),
                             "--seconds", "3", "--trace", "1"])
    assert traced["correct"], traced["compared"]
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    assert set(traced["metrics"]) == want
    assert 0 < traced["device"]["busy_s"] < traced["device"]["window_s"]
