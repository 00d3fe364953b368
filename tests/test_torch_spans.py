"""The port's spans (``openekfmonoslam_tpu_torch/spans.py``): the tree of
names one engine step, one NCC step and one batched step (B = 2) open
under ``torch.profiler``, the recorder's stamps against their profiler
twins, a span that builds no ``record_function`` while nothing records,
and the step's map counts in the engine's record, on
tests/test_torch_live.py's 160x120 STAR + BRIEF configuration.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openekfmonoslam_tpu_torch import config as tcfg
from openekfmonoslam_tpu_torch import spans
from openekfmonoslam_tpu_torch.engine.engine import MAP_COUNTS, SlamEngine
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
from openekfmonoslam_tpu_torch.parallel import batch_runner as br

import test_torch_live as live

# each span's parent (None: outermost) on the single-stream engine path
TREE = {
    "engine.step": None,
    "engine.upload": "engine.step",
    **{p: "engine.step" for p in spans.PHASES},
    "read.summary": "engine.step",
    "engine.record": "engine.step",
    **{f"match.{c}": "step.match" for c in (
        "precompute", "gate", "detect", "describe", "nn", "subpixel",
        "ncc")},
    **{f"ransac.{c}": "step.ransac" for c in (
        "hypotheses", "support", "pick")},
    **{c: "step.mapman" for c in (
        "mapman.maintain", "mapman.convert", "read.add", "mapman.detect",
        "mapman.add")},
    "batch.upload": None,
}
ADDING = {"mapman.detect", "mapman.add"}


@pytest.fixture(scope="module")
def frames():
    return live.make_frames()


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    spans.disable()
    spans.drain()


def profiled(fn):
    """``fn()`` under the profiler: [(name, start ns, end ns)] of the
    spans it opened, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the session's first range sets up the profiler's thread state
        # inside its enter (100-250 us here); let that be another's
        with torch.profiler.record_function("warm-up"):
            pass
        fn()
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in TREE or e.name().startswith("step.")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def parents(ranges):
    """(name, the name of the shortest range around it or None)."""
    out = []
    for i, (name, s, e) in enumerate(ranges):
        around = [r for j, r in enumerate(ranges)
                  if j != i and r[1] <= s and e <= r[2]
                  and (r[2] - r[1]) > (e - s)]
        out.append((name, min(around, key=lambda r: r[2] - r[1])[0]
                    if around else None))
    return out


def adding_engine(frames, **kw):
    """An engine bootstrapped on frame 0; with the frames that add
    features in the first steps (the live configuration adds on frame
    2)."""
    eng = SlamEngine(live.make_config(tcfg), device="cpu", **kw)
    eng.init(frames[0])
    return eng


def test_engine_step_span_tree(frames):
    eng = adding_engine(frames)
    ranges = profiled(lambda: [eng.step(f) for f in frames[1:3]])
    assert all(r.get("total_matches", 0) > 0 for r in eng.records)
    got = parents(ranges)
    for name, parent in got:
        assert TREE[name] == parent, (name, parent)
    names = collections.Counter(n for n, _ in got)
    assert names["engine.step"] == 2
    for name in TREE:
        if name in ("match.ncc", "batch.upload"):
            assert names[name] == 0, name
        elif name in ADDING:
            assert names[name] >= 1, name
        else:
            assert names[name] == 2, name


def test_ncc_step_span_tree():
    rng = np.random.default_rng(3)
    big = np.kron(rng.integers(0, 255, (40, 44)),
                  np.ones((4, 4))).astype(np.uint8)
    shots = [big[20:140, 20 + i:148 + i] for i in range(2)]
    cfg = tcfg.SlamConfig(
        max_features=16, max_keypoints=96, max_hypotheses=16,
        matcher="ncc", descriptor=tcfg.DescriptorConfig(kind="PATCH",
                                                        patch_radius=5),
        ncc_search_radius=6, ncc_min_corr=0.6)
    rt = SlamRuntime(cfg, device="cpu")
    st = rt.init_step(rt.make_initial_state(), shots[0])
    got = dict(parents(profiled(lambda: rt.step(st, shots[1]))))
    assert got["match.ncc"] == "step.match"
    assert got["match.precompute"] == got["match.gate"] == "step.match"
    for c in ("detect", "describe", "nn", "subpixel"):
        assert f"match.{c}" not in got
    assert got["step.match"] is None


def test_batched_step_span_tree(frames):
    rt = SlamRuntime(live.make_config(tcfg), device="cpu")
    both = np.stack([frames[:3], frames[:3]])
    st = br.make_batched_init(rt)(br.make_batch_states(rt, 2), both[:, 0])
    step = br.make_batched_step(rt)

    def run():
        s = st
        for t in (1, 2):
            s, _ = step(s, both[:, t])

    got = parents(profiled(run))
    names = collections.Counter(n for n, _ in got)
    for name, parent in got:
        if name in spans.PHASES:
            assert parent is None, name
        else:
            assert TREE[name] == parent, (name, parent)
    assert names["batch.upload"] == 2
    for name in TREE:
        if name.split(".")[0] in ("match", "ransac", "mapman", "read") \
                and name not in ("match.ncc", "read.summary"):
            assert names[name] >= 1, name
    assert names["engine.step"] == names["read.summary"] == 0


def test_recorder_stamps_meet_their_profiler_twins(frames):
    eng = adding_engine(frames)
    eng.step(frames[1])
    spans.enable()
    ranges = profiled(lambda: eng.step(frames[2]))
    got = spans.drain()
    assert len(got) == len(ranges) > 20
    twins = collections.defaultdict(list)
    for name, s, e in ranges:
        twins[name].append((s, e))
    for span in sorted(got, key=lambda x: x.t0_ns):
        s, e = twins[span.name].pop(0)
        assert abs(span.t0_ns - s) < 50_000, span
        assert abs(span.t1_ns - e) < 50_000, span
    # the tree again, from the recorder's depths and frame tags
    depth = {s.name: s.depth for s in got}
    assert depth["engine.step"] == 0
    assert depth["step.match"] == depth["read.summary"] == 1
    assert depth["match.nn"] == depth["read.add"] == 2
    assert {s.frame for s in got} == {eng.records[-1]["frame"]}


def test_span_off_builds_no_record_function(frames, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(*args, **kw):
        made.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = adding_engine(frames)
    made.clear()
    eng.step(frames[1])
    eng.step(frames[2])
    assert made == []
    with spans.span("engine.step"):
        pass
    assert made == []
    profiled(lambda: eng.step(frames[3]))
    assert "engine.step" in made and "match.nn" in made


def test_recorder_buffer_and_collect(monkeypatch):
    with spans.collect() as got:
        with spans.span("a", frame=7):
            with spans.span("b"):
                pass
        with spans.span("c"):
            pass
    assert [(s.name, s.depth, s.frame) for s in got] == [
        ("b", 1, 7), ("a", 0, 7), ("c", 0, -1)]
    assert spans.drain() == []        # collect() leaves the recorder alone
    monkeypatch.setattr(spans, "CAPACITY", 2)
    spans.enable()
    for name in "xyz":
        with spans.span(name):
            pass
    assert spans.dropped() == 1
    assert [s.name for s in spans.drain()] == ["x", "y"]
    assert spans.drain() == [] and spans.dropped() == 0
    spans.disable()
    with spans.span("off"):
        pass
    assert spans.drain() == []


def test_phase_times_from_spans():
    fake = [spans.Span(p, 1, 1, 1000 * k, 1000 * k + 500 + k)
            for k, p in enumerate(spans.PHASES * 2)]
    fake.insert(3, spans.Span("match.nn", 2, 1, 0, 10**6))
    times = spans.phase_times_us(fake)
    assert len(times) == 2
    assert times[0] == [0.5 + k / 1e3 for k in range(7)]
    assert times[1] == [0.5 + k / 1e3 for k in range(7, 14)]


def test_map_counts_in_the_record(frames):
    eng = adding_engine(frames)
    seen = []
    step = eng.runtime.step

    def kept(state, gray):
        new, rec = step(state, gray)
        seen.append((state, new, rec))
        return new, rec

    eng.runtime.step = kept
    eng.step(frames[1])
    assert not set(MAP_COUNTS) & set(eng.records[-1])
    spans.enable()
    for f in frames[2:]:
        eng.step(f)
    spans.disable()
    recs = eng.records
    added_any = 0
    for k in range(1, len(recs)):
        r, prev = recs[k], recs[k - 1]
        before, after, rec = seen[k]
        new_ok = rec.new_ok.numpy()
        slots = rec.new_slot.numpy()[new_ok]
        assert r["added"] == int(new_ok.sum())
        # slots freed, and slots freed then taken again by an addition
        was, now = before.active.numpy(), after.active.numpy()
        assert r["removed"] == int((was & ~now).sum()) + int(was[slots].sum())
        assert r["n_active"] == prev["n_active"] + r["added"] - r["removed"]
        assert r["converted"] == int(
            (after.is_xyz.numpy() & ~before.is_xyz.numpy()).sum())
        assert r["converted"] <= 1
        assert r["n_xyz"] - prev["n_xyz"] <= r["converted"]
        added_any += r["added"]
    assert added_any > 0


def test_phase_timed_records_carry_no_map_counts(frames):
    eng = adding_engine(frames, phase_timing=True)
    eng.step(frames[1])
    r = eng.records[-1]
    assert r["phase_times_source"] == "measured"
    assert not set(MAP_COUNTS) & set(r)
    assert spans.drain() == []
