"""The readers of the program's spans on hand-made traces: the engine's
own host time, the time blocked at the program's reads, and map
management on the calls that add; each reads nothing where the program
opens no such span."""

import collections

import pytest

from slambench import run
from slambench.trace import PHASES, Interval, Trace

MS = 1_000_000      # ns


def trace(host, steps=2):
    return Trace(steps, steps, (0, 100 * MS), [], list(host),
                 collections.Counter(), [], 640, 96, {})


def frame(at, adds=False):
    """One engine call at ``at`` ms: engine.step of 20 ms, the seven
    phases 1 ms each from at + 2 (mapman 5 ms, holding read.add and on an
    adding call mapman.add), read.summary 0.5 ms at at + 15."""
    t = at * MS
    host = [Interval("engine.step", t, t + 20 * MS),
            Interval("engine.upload", t, t + MS)]
    for k, name in enumerate(PHASES[:-1]):
        host.append(Interval(name, t + (2 + k) * MS, t + (3 + k) * MS))
    m = t + 8 * MS
    host += [Interval("step.mapman", m, m + 5 * MS),
             Interval("mapman.maintain", m, m + MS),
             Interval("read.add", m + MS, m + MS + MS // 4),
             Interval("read.summary", t + 15 * MS, t + 15 * MS + MS // 2),
             Interval("engine.record", t + 16 * MS, t + 17 * MS)]
    if adds:
        host.append(Interval("mapman.add", m + 2 * MS, m + 4 * MS))
    return host


def test_engine_host_ms():
    tr = trace(frame(0) + frame(30))
    # 20 ms a call less 6 phases of 1 ms and mapman's 5
    assert run.reader("engine.host_ms")(tr) == pytest.approx(9.0)


def test_engine_host_ms_clips_the_phases_to_the_call():
    host = frame(0)
    host.append(Interval("step.predict", 19 * MS, 25 * MS))
    tr = trace(host, steps=1)
    assert run.reader("engine.host_ms")(tr) == pytest.approx(8.0)


def test_read_wait_ms():
    tr = trace(frame(0) + frame(30))
    assert run.reader("step.read_wait_ms")(tr) == pytest.approx(0.75)


def test_mapman_add_ms_reads_the_calls_that_add():
    second = frame(30, adds=True)
    mapman = next(i for i in second if i.name == "step.mapman")
    mapman.end += 7 * MS                          # this call's is 12 ms
    tr = trace(frame(0) + second)
    assert run.reader("mapman.add_ms")(tr) == pytest.approx(12.0)
    # the mean over the adding calls alone; step.mapman_ms over all calls
    assert run.reader("step.mapman_ms")(tr) == pytest.approx(8.5)


def test_nothing_read_without_the_spans():
    """A program that opens only the seven phases (as before the spans)
    gives none of the three."""
    host = [i for i in frame(0) + frame(30, adds=True)
            if i.name in PHASES]
    tr = trace(host)
    for name in ("engine.host_ms", "step.read_wait_ms", "mapman.add_ms"):
        assert run.reader(name)(tr) is None, name
    assert run.reader("mapman.add_ms")(trace(frame(0) + frame(30))) is None
