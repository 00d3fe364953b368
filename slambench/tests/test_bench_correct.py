"""``correct`` on the CPU: a sound run passes, and a run with the timed
path broken underneath fails, once for each fault a cell can have; the
control (the reference in float32 with TF32 products in the program's
place) fails too.  The look for a card is skipped (``device="cpu"``); the
frames are the cells' own, with fewer warm-up frames."""

import json

import pytest

from slambench import control, run

SEED = 2 ** 31 + 12345


@pytest.fixture
def small(monkeypatch):
    load = run.load_cell

    def small_cell(name):
        bench, cell, cfg, traffic = load(name)
        calls = 16 if traffic["entry"] == "engine" else 2
        return bench, cell, cfg, dict(traffic, warmup_frames=3,
                                      check_frames=calls)

    monkeypatch.setattr(run, "load_cell", small_cell)


def result(capsys, cell, seconds=3.0, fault=None, lines=None):
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds",
            str(seconds), "--trace", "0"]
    with fault() if fault else control.contextlib.nullcontext():
        assert run.main(argv, device="cpu") == 0
    out = capsys.readouterr().out.strip().splitlines()
    if lines is not None:
        lines.extend(out)
    return json.loads(out[-1])


def test_sound_run_is_correct(small, capsys):
    out = result(capsys, "s3-live-1cam")
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"
    assert out["compared"]["followed_share"]["value"] >= 0.75


@pytest.mark.parametrize("fault", ["unchanged_state", "moved_pose",
                                   "moved_candidates", "moved_descriptors"])
def test_broken_step_is_not_correct(small, capsys, fault):
    out = result(capsys, "s3-live-1cam", fault=control.FAULTS[fault])
    assert not out["correct"], out["compared"]


def test_half_the_batch_is_not_correct(small, capsys):
    lines = []
    out = result(capsys, "s3-batch-8cam", seconds=10,
                 fault=control.FAULTS["half_the_batch"], lines=lines)
    assert not out["correct"], out["compared"]
    # every stream of each kept call is compared, and each bootstrap
    said = next(x for x in lines if x.startswith("compared: "))
    assert said.startswith("compared: 8 bootstraps and 16 frames"), said


def test_control_is_not_correct(small):
    _, cell, cfg, traffic = run.load_cell("s3-live-1cam")
    limits = json.loads((run.HERE / "limits" / f"{cell['config']}.json"
                         ).read_text())
    prog, ctrl = control.readings("s3-live-1cam", cfg, traffic, SEED, 3.0,
                                  limits, "cpu", with_control=True)
    assert prog["side"] == "program" and ctrl["side"] == "control"

    def ok(r):
        return run.passes({k: {"value": r[k], "limit": v}
                           for k, v in limits.items()})

    assert ok(prog), prog
    assert not ok(ctrl), ctrl

