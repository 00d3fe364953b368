"""Every file BENCHMARK.json names is there and loads, and the harness and
its reference load neither JAX nor the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from slambench import drivers, run
from slambench.reference.ekf import Params
from slambench.reference.vision import FrontEnd

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAFFIC_KEYS = {"why", "entry", "frame_hw", "texture_period", "pan_px",
                "warmup_frames", "check_frames", "trace_steps"}
LIMIT_KEYS = {"state_gap", "P_gap", "wrong", "z_gap", "match_off",
              "cand_off", "desc_bits", "followed_share"}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"]
    sc = drivers.slam_config(cfg)
    p = Params.from_config(cfg)
    assert (p.n_slots, p.n_state) == (sc.max_features, sc.padded_state_dim)
    FrontEnd(cfg)
    limits = json.loads((ROOT / "slambench" / "limits"
                         / f"{conf['name']}.json").read_text())
    assert set(limits) == LIMIT_KEYS


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    bench, c, cfg, traffic = run.load_cell(cell["name"])
    assert c == cell
    assert traffic["entry"] == "batch" or len(traffic["pan_px"]) == 1


@pytest.mark.parametrize("path", sorted(
    (ROOT / "slambench" / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_traffic_file_loads(path):
    traffic = json.loads(path.read_text())
    assert set(traffic) == TRAFFIC_KEYS
    assert traffic["entry"] in ("engine", "batch")
    assert traffic["texture_period"] >= traffic["frame_hw"][1]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(run.reader(metric["name"]))
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric["workloads"]) <= names


def test_nothing_of_jax_loaded():
    """Import the harness, its reference and the port in a fresh process,
    and look at sys.modules by whole top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import slambench.run, slambench.drivers, slambench.trace\n"
        "import slambench.reference.check, slambench.reference.vision\n"
        "import openekfmonoslam_tpu_torch.engine.engine\n"
        "import openekfmonoslam_tpu_torch.parallel.batch_runner\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & set(slambench.run.FORBIDDEN))\n"
        "print(bad)\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stdout


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "slambench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "openekfmonoslam_tpu" not in text, path
