"""The live step's CUDA graph (``engine/step_graph.py``).

On the CPU: the rule that picks eager, capture or replay (the CPU, the
sharded runtime, a thread that collects spans and a key's first call run
eagerly), the grouped copies and the rebuilding of a prefix from its kept
tensors, the recorder's ``replayed`` counter, the ``step.replay`` span's
place in ``spans.py``'s list, and the benchmark's reader of it
(``slambench/metrics/step.replay_share.py``).

On the card (marked ``cuda``, skipped without one): the replayed step
against the eager one, frame by frame from the same states over 60
640x480 frames of the s3 and the large-map configurations, the parity
mode and the FAST and NCC profiles, each with frames that add and frames
that convert (bit for bit where the eager step repeats itself bit for
bit, else within ``slambench/limits/``; the 60 follow 70 eager frames, as
these pans convert from about frame 70 on); that no state or record a
step returns shares storage with the next step's or with the graph's
buffers, and stays as it was over 10 later steps; one capture a key; and
the launch counts of replayed frames equal the eager frames'.  This module
imports no JAX; on a machine without it run the card's tests as

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py
"""

import collections
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openekfmonoslam_tpu_torch import spans
from openekfmonoslam_tpu_torch.config import DescriptorConfig, SlamConfig
from openekfmonoslam_tpu_torch.engine import step_graph
from openekfmonoslam_tpu_torch.engine.engine import SlamEngine
from openekfmonoslam_tpu_torch.engine.step import (Prefix, SlamRuntime,
                                                   StepRecord)
from openekfmonoslam_tpu_torch.ops import cuda_lib
from openekfmonoslam_tpu_torch.parallel.sharding import ShardedRuntime
from slambench import drivers, run
from slambench.frames import PanSource
from slambench.trace import Interval, Trace

ROOT = Path(__file__).resolve().parent.parent
MS = 1_000_000      # ns


def small_config(**kw) -> SlamConfig:
    return SlamConfig(max_features=16, max_keypoints=96, max_hypotheses=16,
                      **kw)


def small_frames(n: int) -> list:
    src = PanSource(5, 120, 160, 1024, 2)
    return [np.array(src.frame(t)) for t in range(n)]


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    spans.disable()
    spans.drain()


# ---------------------------------------------------------------- the CPU

def test_cpu_runtime_steps_eagerly():
    rt = SlamRuntime(small_config(), device="cpu")
    frames = small_frames(4)
    st = rt.init_step(rt.make_initial_state(), frames[0])
    for f in frames[1:]:
        assert rt._step_mode(st, rt._tensor(f)) == ("eager", None)
        st, _ = rt.step(st, f)
        assert rt.replayed is False
    assert rt._graphs.captures == {}


def _shapes_only():
    """A CPU state and frame: what the rule reads of them is shapes."""
    rt = SlamRuntime(small_config(), device="cpu")
    return rt.make_initial_state(), torch.zeros((120, 160), dtype=torch.uint8)


def test_first_call_of_a_key_is_eager_the_second_captures():
    # a runtime for the card, built here: the rule touches no device
    rt = SlamRuntime(small_config(), device="cuda")
    st, gray = _shapes_only()
    key = step_graph.step_key(st, gray)
    assert rt._step_mode(st, gray) == ("eager", key)
    assert rt._step_mode(st, gray) == ("capture", key)
    other = torch.zeros((240, 320), dtype=torch.uint8)
    assert rt._step_mode(st, other)[0] == "eager"
    assert rt._step_mode(st, other)[0] == "capture"
    # another state shape is another key
    wide = st._replace(P=torch.zeros(st.P.shape[0] + 4, st.P.shape[1] + 4))
    assert rt._step_mode(wide, gray)[0] == "eager"


def test_collecting_spans_runs_eagerly_and_notes_no_key():
    rt = SlamRuntime(small_config(), device="cuda")
    st, gray = _shapes_only()
    assert not spans.collecting()
    with spans.collect():
        assert spans.collecting()
        for _ in range(3):
            assert rt._step_mode(st, gray) == ("eager", None)
    assert not spans.collecting()
    # the key's first call is still to come
    assert rt._step_mode(st, gray)[0] == "eager"
    assert rt._step_mode(st, gray)[0] == "capture"


def test_sharded_runtime_steps_eagerly():
    assert SlamRuntime.step_graphs is True
    assert ShardedRuntime.step_graphs is False
    # the rule reads the class alone: a sharded runtime built without a
    # tiling
    rt = ShardedRuntime.__new__(ShardedRuntime)
    SlamRuntime.__init__(rt, small_config(), device="cuda")
    st, gray = _shapes_only()
    for _ in range(3):
        assert rt._step_mode(st, gray) == ("eager", None)


def test_grouped_copy_and_kept_tensors_round_trip():
    rt = SlamRuntime(small_config(), device="cpu")
    st = rt.make_initial_state()
    rec = StepRecord(*([None, None] + [torch.full((3,), k)
                                       for k in range(14)]))
    prefix = Prefix(st, rec, torch.tensor([1, 5], dtype=torch.int32),
                    None, {}, None)
    kept = step_graph._kept(prefix)
    assert len(kept) == len(st) + 14
    groups = step_graph._dtype_groups(kept)
    assert sorted(i for g in groups for i in g) == list(range(len(kept)))
    assert all(len({kept[i].dtype for i in g}) == 1 for g in groups)
    fresh = [torch.empty_like(t) for t in kept]
    step_graph._copy(fresh, kept, groups)
    back = step_graph._with_kept(prefix, fresh)
    assert back.record.x_cam is None and back.record.P_cam is None
    assert back.ask is prefix.ask
    for a, b in zip((*back.state, *back.record[2:]),
                    (*st, *rec[2:])):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != \
            b.untyped_storage().data_ptr()


def test_recorder_counts_replayed():
    frames = small_frames(4)
    eng = SlamEngine(small_config(), device="cpu")
    eng.init(frames[0])
    eng.step(frames[1])
    assert "replayed" not in eng.records[-1]
    spans.enable()
    for f in frames[2:]:
        eng.step(f)
    spans.disable()
    assert [r["replayed"] for r in eng.records[1:]] == [0, 0]


def test_step_replay_in_the_span_list():
    doc = spans.__doc__
    assert "step.replay" in doc
    # listed under engine.step, beside the phases
    assert doc.index("engine.step ") < doc.index("step.replay") \
        < doc.index("step.<phase> x 7")
    assert "step.replay" not in spans.PHASES


def _trace(host, steps):
    return Trace(steps, steps, (0, 100 * MS), [], host,
                 collections.Counter(), [], 640, 96, {})


def test_replay_share_reader():
    read = run.reader("step.replay_share")

    def calls(n, replayed):
        host = []
        for k in range(n):
            t = k * 10 * MS
            host.append(Interval("engine.step", t, t + 8 * MS))
            if k < replayed:
                host.append(Interval("step.replay", t + MS, t + 2 * MS))
            host.append(Interval("step.mapman", t + 2 * MS, t + 3 * MS))
        return host

    assert read(_trace(calls(60, 60), 60)) == pytest.approx(100.0)
    assert read(_trace(calls(60, 45), 60)) == pytest.approx(75.0)
    # the parent's program opens no step.replay: nothing to read
    assert read(_trace(calls(60, 0), 60)) is None
    assert read(_trace([], 0)) is None


def test_replay_share_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = bench["per_layer"][-1]
    assert m == {"name": "step.replay_share", "unit": "%",
                 "better": "higher", "source": "program_span",
                 "layer": "step", "moves": "frames_per_s",
                 "workloads": ["s3-live-1cam", "map960-live-1cam"]}


# -------------------------------------------------------------- the card

T = 60      # steps compared
LEAD = 70   # eager steps before them: the pans convert from about 70 on


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def bench_config(name: str) -> SlamConfig:
    cfg = json.loads((ROOT / "slambench" / "configs" / f"{name}.json")
                     .read_text())
    return drivers.slam_config(cfg)


CONFIGS = {
    "s3": lambda: bench_config("s3_star_brief"),
    "map960": lambda: bench_config("map960_star_brief"),
    "parity": lambda: dataclasses.replace(
        bench_config("s3_star_brief"), reference_quirks=True,
        ransac_parity_visit=True, max_hypotheses=1000),
    "fast": SlamConfig,
    "ncc": lambda: SlamConfig(matcher="ncc",
                              descriptor=DescriptorConfig(kind="PATCH")),
}
LIMITS = {"s3": "s3_star_brief", "map960": "map960_star_brief",
          "parity": "s3_star_brief", "fast": "s3_star_brief",
          "ncc": "s3_star_brief"}


def card_frames(dev, n: int = LEAD + T + 1) -> torch.Tensor:
    src = PanSource(11, 480, 640, 4096, 2)
    return torch.from_numpy(np.stack([src.frame(t) for t in range(n)])
                            ).to(dev)


def eager_run(rt, frames, lead: int = 0):
    """init and eager steps over ``frames``: [(state before, state after,
    record)] of the steps after the first ``lead``."""
    st = rt.init_step(rt.make_initial_state(), frames[0])
    out = []
    with spans.collect():
        for f in frames[1:]:
            new, rec = rt.step(st, f)
            out.append((st, new, rec))
            st = new
    return out[lead:]


def fields(state, rec) -> dict:
    return {**{f"state.{k}": v for k, v in state._asdict().items()},
            **{f"record.{k}": v for k, v in rec._asdict().items()}}


def limit_of(name: str, limits: dict) -> float:
    """The limit a field is held to where the eager step does not repeat
    itself bit for bit (slambench/limits/: state, covariance, pixels)."""
    field = name.split(".")[1]
    if field in ("P", "P_cam", "pred_S"):
        return limits["P_gap"]
    if field in ("z", "pred_uv", "new_uv"):
        return limits["z_gap"]
    if field in ("x", "x_cam", "patch_pose"):
        return limits["state_gap"]
    return 0.0      # masks, counts, slots, descriptors: no decision moves


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replay_equals_eager(dev, name):
    rt = SlamRuntime(CONFIGS[name](), device=dev)
    limits = json.loads((ROOT / "slambench" / "limits"
                         / f"{LIMITS[name]}.json").read_text())
    frames = card_frames(dev)
    ref = eager_run(rt, frames, LEAD)
    frames = frames[LEAD:]
    added = converted = 0
    modes = []
    repeat = collections.Counter()
    for t, (before, after, rec) in enumerate(ref):
        with spans.collect():
            again = fields(*rt.step(before, frames[t + 1]))
        got = fields(*rt.step(before, frames[t + 1]))
        modes.append(rt.replayed)
        want = fields(after, rec)
        for k, w in want.items():
            a, g = again[k], got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if torch.equal(a, w):
                repeat["bits"] += 1
                assert torch.equal(g, w), (name, t, k)
            else:
                repeat["close"] += 1
                gap = float((g.double() - w.double()).abs().max())
                assert gap <= limit_of(k, limits), (name, t, k, gap)
        added += int(rec.new_ok.sum())
        converted += int((after.is_xyz & ~before.is_xyz).sum())
    # a key's first call eager, every later one by the graph
    assert modes == [False] + [True] * (T - 1)
    assert added > 0 and converted > 0, (added, converted)
    assert list(rt._graphs.captures.values()) == [1]
    print(f"{name}: {added} features added, {converted} conversions; "
          f"fields equal bit for bit where the eager step repeats itself "
          f"{repeat['bits']}, within the limits {repeat['close']}")


@pytest.mark.cuda
def test_returned_tensors_alias_nothing(dev):
    rt = SlamRuntime(bench_config("s3_star_brief"), device=dev)
    frames = card_frames(dev, 32)
    st = rt.init_step(rt.make_initial_state(), frames[0])
    steps = []
    for f in frames[1:]:
        new, rec = rt.step(st, f)
        steps.append((st, new, rec))
        st = new
    (g,) = rt._graphs._graphs.values()
    static = {t.untyped_storage().data_ptr() for t in g.inputs + g.kept}

    def storages(state, rec):
        return {t.untyped_storage().data_ptr()
                for t in fields(state, rec).values()}

    for k in range(1, len(steps)):
        mine = storages(*steps[k][1:])
        assert not mine & static, k
        assert not mine & storages(*steps[k - 1][1:]), k
    # frame 5's state and record, and the state it began from, are as they
    # were after 10 later steps (frames 6 to 15)
    kept = {k: v.clone() for k, v in fields(*steps[4][1:]).items()}
    kept_in = [v.clone() for v in steps[4][0]]
    st = steps[4][1]
    for f in frames[6:16]:
        st, _ = rt.step(st, f)
    torch.cuda.synchronize()
    for k, v in fields(*steps[4][1:]).items():
        assert torch.equal(v, kept[k]), k
    for a, b in zip(steps[4][0], kept_in):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_capture_a_key(dev):
    rt = SlamRuntime(bench_config("s3_star_brief"), device=dev)
    frames = card_frames(dev, 21)
    st = rt.init_step(rt.make_initial_state(), frames[0])
    for f in frames[1:]:
        st, _ = rt.step(st, f)
    assert list(rt._graphs.captures.values()) == [1]
    # phase timing between the replays captures nothing new
    with spans.collect():
        st, _ = rt.step(st, frames[1])
    st, _ = rt.step(st, frames[2])
    assert rt.replayed
    assert list(rt._graphs.captures.values()) == [1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["s3", "map960", "parity"])
def test_replayed_launch_counts_equal_eager(dev, name):
    rt = SlamRuntime(CONFIGS[name](), device=dev)
    frames = card_frames(dev, 21)
    ref = eager_run(rt, frames)

    def counts(replay: bool):
        for c in cuda_lib.COUNTERS:
            c.reset()
        for t, (before, _, _) in enumerate(ref):
            if replay:
                rt.step(before, frames[t + 1])
            else:
                with spans.collect():
                    rt.step(before, frames[t + 1])
        return {c.name: c.count for c in cuda_lib.COUNTERS}

    counts(True)            # the first call and the capture
    eager, replayed = counts(False), counts(True)
    assert rt.replayed
    assert replayed == eager
    assert eager["ransac_support"] == len(ref)
