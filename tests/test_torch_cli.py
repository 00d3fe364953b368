"""The port's CLI (``python -m openekfmonoslam_tpu_torch.cli``) on the CPU
(``--device cpu``), over a directory of synthetic PNG frames: interactive
and scan modes, checkpoint and resume, and the output files read back by
the JAX package's result reader.  The port's copies of the numpy-only eval
modules are held against the JAX ones on the same records."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from openekfmonoslam_tpu.eval import result_reader as jrr
from openekfmonoslam_tpu.eval import trajectory as jtraj
from openekfmonoslam_tpu.io import sources as jsources
from openekfmonoslam_tpu_torch import cli
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine, run_sequence
from openekfmonoslam_tpu_torch.eval import result_reader as trr
from openekfmonoslam_tpu_torch.eval import trajectory as ttraj
from openekfmonoslam_tpu_torch.io import sources as tsources
from openekfmonoslam_tpu_torch.io.sources import FileSequenceSource
from test_torch_live import make_frames

CONFIG = """%YAML:1.0
RunConfiguration:
  ExtendedKalmanFilter: "EKF"
  FeatureDetector: "STAR"
  DescriptorExtractor: "BRIEF"
  CameraCalibration: "TestCam"
ExtendedKalmanFilter:
  EKF:
    MinMatchesPerImage: "12"
    DetectNewFeaturesImageAreasDivideTimes: "1"
FeatureDetector:
  STAR:
    Type: "STAR"
    ResponseThreshold: "8"
DescriptorExtractor:
  BRIEF:
    Type: "BRIEF"
    BytesLength: "32"
CameraCalibration:
  TestCam:
    PixelsX: "160"
    PixelsY: "120"
    FX: "120.0"
    FY: "120.0"
    K1: "0.0"
    K2: "0.0"
    CX: "80.0"
    CY: "60.0"
    DX: "0.01"
    DY: "0.01"
    PixelErrorX: "1.0"
    PixelErrorY: "1.0"
    AngularVisionX: "45.0"
    AngularVisionY: "35.0"
"""
ARGS = ["--max-features", "24", "--progress", "0", "--device", "cpu"]
VALUES = ("position", "orientation", "linear_velocity", "angular_velocity",
          "covariance_cam")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    frames = d / "frames"
    frames.mkdir()
    for i, f in enumerate(make_frames(), start=1):
        Image.fromarray(f).save(frames / f"{i:05d}.png")
    config = d / "config.yml"
    config.write_text(CONFIG)
    return dict(dir=d, frames=str(frames), config=str(config))


def read_jsonl(path):
    return [json.loads(line) for line in open(path)]


def strip(records):
    return [{k: v for k, v in r.items() if k != "wall_time_s"}
            for r in records]


@pytest.fixture(scope="module")
def interactive(files):
    out = files["dir"] / "interactive"
    cli.main([files["config"], files["frames"], str(out), *ARGS])
    return dict(out=out, records=read_jsonl(out / "records.jsonl"))


def test_interactive_writes_the_artifacts(interactive):
    out = interactive["out"]
    for name in ("records.jsonl", "log.txt", "output.yml",
                 "cameraPositions.m", "timesCpu.m", "scaleFactor.m"):
        assert (out / name).exists(), name
    assert len(interactive["records"]) == 6
    assert all(r["total_matches"] >= 8 for r in interactive["records"])


def test_cli_records_equal_the_engine_run(files, interactive):
    engine = SlamEngine(files["config"], device="cpu", max_features=24)
    recs = run_sequence(engine, FileSequenceSource(files["frames"], 1, 99))
    assert strip(recs) == strip(interactive["records"])


def test_output_yml_reads_back_through_the_jax_reader(interactive):
    loaded = jrr.read_output_yml(str(interactive["out"] / "output.yml"))
    recs = interactive["records"]
    assert len(loaded) == len(recs)
    for got, want in zip(loaded, recs):
        for k in VALUES:
            assert got[k] == want[k], k
        for k in ("frame", "total_matches", "li_inliers", "hi_inliers",
                  "n_xyz", "n_inverse_depth", "n_active"):
            assert got[k] == want[k], k


def test_eval_copies_equal_the_jax_modules(interactive, tmp_path):
    recs = interactive["records"]
    assert ttraj.summarize(recs) == jtraj.summarize(recs)
    trr.write_output_yml(recs, str(tmp_path / "port.yml"))
    jrr.write_output_yml(recs, str(tmp_path / "jax.yml"))
    assert (tmp_path / "port.yml").read_text() == \
        (tmp_path / "jax.yml").read_text()
    assert trr.read_output_yml(str(tmp_path / "port.yml")) == \
        jrr.read_output_yml(str(tmp_path / "port.yml"))
    assert trr.emit_matlab_report(recs, str(tmp_path / "p")) == \
        jrr.emit_matlab_report(recs, str(tmp_path / "j"))
    for name in ("cameraPositions.m", "cameraOrientations.m", "timesCpu.m"):
        assert (tmp_path / "p" / name).read_text() == \
            (tmp_path / "j" / name).read_text()


def test_scan_mode_matches_interactive(files, interactive):
    out = files["dir"] / "scan"
    cli.main([files["config"], files["frames"], str(out), "--mode", "scan",
              "--phase-timing", *ARGS])
    x_cam = np.load(out / "x_cam.npy")
    recs = interactive["records"]
    np.testing.assert_array_equal(x_cam[:, 0:3],
                                  [r["position"] for r in recs])
    loaded = jrr.read_output_yml(str(out / "output.yml"))
    assert [r["total_matches"] for r in loaded] == [
        r["total_matches"] for r in recs]
    assert loaded[0]["phase_times_source"] == "measured"
    assert sum(loaded[0]["phase_times_us"].values()) > 0


def test_checkpoint_every_then_resume(files, interactive):
    first = files["dir"] / "first"
    cli.main([files["config"], files["frames"], str(first), "--end", "4",
              "--checkpoint-every", "3", *ARGS])
    ckpt = first / "checkpoint.npz"
    assert ckpt.exists()
    resumed = files["dir"] / "resumed"
    cli.main([files["config"], files["frames"], str(resumed), "--begin", "5",
              "--resume", str(ckpt), *ARGS])
    recs = read_jsonl(resumed / "records.jsonl")
    assert [r["frame"] for r in recs] == [4, 5, 6]
    assert strip(recs) == strip(interactive["records"][3:])


@pytest.mark.parametrize("flags,what", [
    (["--keyframe-every", "2"], "graph"), (["--matcher", "ncc"], "ncc")])
def test_keyframe_every_and_the_ncc_matcher_run(files, capsys, flags, what):
    """--keyframe-every (the pose graph) and --matcher ncc (PATCH
    descriptors) run on the CPU as the JAX CLI's options do."""
    out = files["dir"] / f"opt_{what}"
    cli.main([files["config"], files["frames"], str(out), "--end", "5",
              *flags, *ARGS])
    recs = read_jsonl(out / "records.jsonl")
    assert [r["frame"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["position"]).all() for r in recs)
    assert "fps" in capsys.readouterr().out
    if what == "ncc":
        assert sum(r["total_matches"] for r in recs) > 0


def test_the_card_is_the_default_device(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([files["config"], files["frames"], "--progress", "0"])


class FakeClock:
    """A wall clock that advances 0.05 s a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.05
        return self.t


@pytest.mark.parametrize("kind", ["file", "on_demand"])
def test_frame_sources_equal_the_jax_ones(files, kind):
    def frames(mod):
        if kind == "file":
            src = mod.FileSequenceSource(files["frames"], 2, 6)
        else:
            src = mod.FileSequenceOnDemandSource(
                files["frames"], 1, 7, frame_rate=30.0, clock=FakeClock())
        return list(src)

    got, want = frames(tsources), frames(jsources)
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
