"""The port's engine API (``SlamEngine``, its checkpoint, relocalization
and phase timing) end to end against the JAX package's ``SlamEngine``.

Both engines run the live test's configuration (tests/test_torch_live.py:
STAR + BRIEF-256 at 160x120, ``max_features=24``, float64) over its nudged
frames: ``init``, 6 ``step``s, then two featureless frames that lose
tracking and trigger relocalization (``relocalize_after=2``), then three
more textured frames.  Every record's state, velocities and 13x13
covariance corner agree to 1e-9 and every counter is identical
(``wall_time_s`` excluded).  Checkpoints written after step 3 cross
between the packages in both directions and continue 3 steps to the same
records.  One JAX engine serves every comparison, so its step compiles
once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openekfmonoslam_tpu import config as jcfg
from openekfmonoslam_tpu.engine import engine as jeng
from openekfmonoslam_tpu.eval import result_reader as jrr
from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch.engine import checkpoint as tckpt
from openekfmonoslam_tpu_torch.engine import engine as teng
from openekfmonoslam_tpu_torch.filter import state as tstate
from test_torch_live import H, W, make_config, make_frames

CKPT_AT = 3
VALUES = ("position", "orientation", "linear_velocity", "angular_velocity",
          "covariance_cam")
COUNTERS = ("frame", "total_matches", "li_inliers", "hi_inliers",
            "n_active", "n_visible", "n_xyz", "n_inverse_depth")


def sequence(frames):
    """The step frames: 6 textured, 2 featureless (tracking lost), 3
    textured again."""
    flat = np.full((H, W), 128, np.uint8)
    return list(frames[1:]) + [flat, flat] + [frames[6], frames[5],
                                              frames[4]]


def assert_records_agree(got, want, tol=1e-9):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert set(g) - {"wall_time_s"} == set(w) - {"wall_time_s"}, t
        for k in COUNTERS:
            assert g[k] == w[k], (k, t)
        assert g.get("relocalized") == w.get("relocalized"), t
        for k in VALUES:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol,
                                       err_msg=f"{k} record {t}")


def run(engine, frames, steps, ckpt_path=None):
    engine.init(frames[0])
    for k, f in enumerate(steps):
        engine.step(f)
        if ckpt_path is not None and k + 1 == CKPT_AT:
            engine.save_checkpoint(str(ckpt_path))
    return engine


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    frames = make_frames()
    steps = sequence(frames)
    jc, tc = make_config(jcfg), make_config(tcfg)
    je = run(jeng.SlamEngine(jc, relocalize_after=2), frames, steps,
             tmp / "jax.npz")
    te = run(teng.SlamEngine(tc, relocalize_after=2, device="cpu",
                             output_path=str(tmp / "out")),
             frames, steps, tmp / "port.npz")
    jrecs = list(je.records)
    # the JAX engine resumes the port's file (reusing its compiled step)
    je.resume(str(tmp / "port.npz"))
    for f in steps[CKPT_AT:2 * CKPT_AT]:
        je.step(f)
    return dict(frames=frames, steps=steps, tmp=tmp, jc=jc, tc=tc,
                jrecs=jrecs, trecs=te.records, te=te,
                j_from_port=je.records[len(jrecs):])


def test_engine_records_match_jax(runs):
    assert_records_agree(runs["trecs"], runs["jrecs"])
    recs = runs["trecs"]
    assert all(r["total_matches"] >= 8 for r in recs[:6])
    assert sum(bool(r.get("relocalized")) for r in recs) >= 1


def test_relocalization_takes_the_same_frames(runs):
    def frames_of(recs):
        return [r["frame"] for r in recs if r.get("relocalized")]

    assert frames_of(runs["trecs"]) == frames_of(runs["jrecs"])
    assert frames_of(runs["trecs"])[0] == 8       # the second flat frame


def test_engine_state_access(runs):
    te = runs["te"]
    assert te.state_vector.shape == (te.config.padded_state_dim,)
    assert te.covariance.shape == (te.config.padded_state_dim,) * 2
    np.testing.assert_array_equal(te.camera_position, te.state_vector[:3])
    assert te.frame_index == len(runs["steps"]) == len(te.records)
    assert te.relocalizations >= 1


def test_phase_timed_engine_matches_jax(runs):
    jt = run(jeng.SlamEngine(runs["jc"], phase_timing=True), runs["frames"],
             runs["steps"][:4])
    tt = run(teng.SlamEngine(runs["tc"], phase_timing=True, device="cpu"),
             runs["frames"], runs["steps"][:4])
    for recs in (jt.records, tt.records):
        for r in recs:
            assert set(r["phase_times_us"]) == set(jrr.PHASE_KEYS)
            assert all(v > 0 for v in r["phase_times_us"].values())
            assert r["phase_times_source"] == "measured"
    strip = [{k: v for k, v in r.items() if not k.startswith("phase_")}
             for r in tt.records]
    assert_records_agree(strip, [{k: v for k, v in r.items()
                                  if not k.startswith("phase_")}
                                 for r in jt.records])
    assert_records_agree(strip, runs["trecs"][:4], tol=0.0)


def test_port_resumes_a_jax_checkpoint(runs):
    te = teng.SlamEngine(runs["tc"], device="cpu")
    te.resume(str(runs["tmp"] / "jax.npz"))
    assert te.frame_index == CKPT_AT
    for f in runs["steps"][CKPT_AT:2 * CKPT_AT]:
        te.step(f)
    assert_records_agree(te.records, runs["jrecs"][CKPT_AT:2 * CKPT_AT])


def test_jax_resumes_a_port_checkpoint(runs):
    assert_records_agree(runs["j_from_port"],
                         runs["trecs"][CKPT_AT:2 * CKPT_AT])


def test_port_resumes_its_own_checkpoint_bit_for_bit(runs):
    te = teng.SlamEngine(runs["tc"], device="cpu")
    te.resume(str(runs["tmp"] / "port.npz"))
    for f in runs["steps"][CKPT_AT:2 * CKPT_AT]:
        te.step(f)
    assert_records_agree(te.records, runs["trecs"][CKPT_AT:2 * CKPT_AT],
                         tol=0.0)


def test_checkpoint_file_is_the_jax_layout(runs):
    with np.load(runs["tmp"] / "port.npz") as port, \
            np.load(runs["tmp"] / "jax.npz") as jax_file:
        assert set(port.files) == set(jax_file.files)
        for f in port.files:
            assert port[f].dtype == jax_file[f].dtype, f
            assert port[f].shape == jax_file[f].shape, f
    like = teng.SlamEngine(runs["tc"], device="cpu").state
    st = tckpt.load_checkpoint(str(runs["tmp"] / "port.npz"), like=like)
    assert st.descriptors.dtype == torch.int32 and st.x.dtype == torch.float64
    with pytest.raises(ValueError, match="shape"):
        small = dataclasses.replace(runs["tc"], max_features=8)
        tckpt.load_checkpoint(str(runs["tmp"] / "port.npz"),
                              like=tstate.make_initial_state(
                                  small, torch.float64, "cpu"))


def test_output_files(runs):
    te = runs["te"]
    te.close()
    out = runs["tmp"] / "out"
    lines = (out / "records.jsonl").read_text().splitlines()
    assert len(lines) == len(te.records)
    assert (out / "log.txt").read_text().startswith("seed: 0\n")
    loaded = jrr.read_output_yml(str(out / "output.yml"))
    assert [r["total_matches"] for r in loaded] == [
        r["total_matches"] for r in te.records]


S3_MAP_960 = """%YAML:1.0
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


def test_config_file_sizes_the_large_map_in_both_packages(tmp_path):
    path = tmp_path / "config.yml"
    path.write_text(S3_MAP_960)
    j = jeng.SlamEngine(str(path)).config
    t = teng.SlamEngine(str(path), device="cpu").config
    assert (j.max_features, j.padded_state_dim) == (168, 1024)
    assert (t.max_features, t.padded_state_dim) == (168, 1024)
    assert (t.detector.kind, t.detector.nonmax_radius,
            t.descriptor.n_bits) == ("STAR", 2, 256)


def test_keyframe_every_builds_the_pose_graph_on_the_engine_device():
    engine = teng.SlamEngine(make_config(tcfg), device="cpu",
                             keyframe_every=5, keyframe_capacity=8)
    graph = engine.pose_graph
    assert graph.capacity == (8, 32)
    assert graph.node_r.device == torch.device("cpu")
    assert graph.node_r.dtype == torch.float32        # as in JAX
    assert engine.loop_closer is not None


@pytest.mark.parametrize("method,args", [
    ("corrected_trajectory", ()), ("optimize_pose_graph", ()),
    ("add_loop_closure", (0, 1, np.zeros(3), np.array([1.0, 0, 0, 0])))])
def test_pose_graph_methods_raise(method, args):
    """Without a pose graph (keyframe_every=0) each method raises what the
    JAX engine's raises; with one it runs."""
    engine = teng.SlamEngine(make_config(tcfg), device="cpu")
    with pytest.raises(RuntimeError) as got:
        getattr(engine, method)(*args)
    with pytest.raises(RuntimeError) as want:
        getattr(jeng.SlamEngine(make_config(jcfg)), method)(*args)
    assert str(got.value) == str(want.value)
    engine = teng.SlamEngine(make_config(tcfg), device="cpu",
                             keyframe_every=1, keyframe_capacity=4)
    frames = make_frames()
    engine.init(frames[0])
    engine.step(frames[1])
    engine.step(frames[2])
    getattr(engine, method)(*args)
    assert int(engine.pose_graph.n_nodes) == 2
    assert int(engine.pose_graph.n_edges) == (
        2 if method == "add_loop_closure" else 1)
