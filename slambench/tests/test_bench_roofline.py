"""The roofline counts against a hand-worked case, and the readers on a
hand-made trace."""

import collections

import pytest

from slambench import roofline, run
from slambench.trace import Interval, Trace


def test_update_counts_by_hand():
    # N = 640, F = 96, 40 used slots (80 rows)
    N, F, M = 640, 96, 80
    nbytes = 4 * (2 * 640 * 640 + 2 * 640 + 80 * 640 + 80 * 80 + 4 * 96) + 96
    assert roofline.update_bytes(N, F, M) == nbytes == 3_513_952
    flops = 2 * (80 ** 3 / 6 + 80 * 80 * 640 / 2 + 80 * 640 * 640 / 2
                 + 80 * 80 / 2 + 80 * 640)
    assert roofline.update_flops(N, M) == pytest.approx(flops)
    # bytes bound it: 3.51 MB at 3.35 TB/s is 1.049 us, 33.4 MFLOP at
    # 67 TFLOP/s is 0.554 us
    assert roofline.bound_s(nbytes, flops) == pytest.approx(
        3_513_952 / 3.35e12)


def test_sinv_counts_by_hand():
    assert roofline.sinv_bytes(336) == 903_168
    assert roofline.sinv_flops(120) == 1_728_000
    assert roofline.bound_s(903_168, 1_728_000) == pytest.approx(
        903_168 / 3.35e12)


def trace(device, used, n_state=640, n_slots=96, steps=2, frames=2,
          window=(0, 10_000_000), host=(), syncs=None, ops=None):
    return Trace(steps, frames, window, list(device), list(host),
                 collections.Counter(syncs or {}), used, n_state, n_slots,
                 dict(ops or {}))


def kernel(name, start, dur):
    return Interval(name, start, start + dur, "kernel")


def test_update_roofline_reader():
    # two steps, each with two updates (li 80 rows, hi 0), each update
    # taking 100 us over its three kernels
    dev = []
    for s in range(4):
        t = s * 1_000_000
        dev += [kernel("update_factor(float const*)", t, 40_000),
                kernel("update_solve", t + 40_000, 30_000),
                kernel("update_downdate", t + 70_000, 30_000)]
    tr = trace(dev, [[(80, 0)], [(80, 0)]])
    least = 2 * (roofline.bound_s(roofline.update_bytes(640, 96, 80),
                                  roofline.update_flops(640, 80))
                 + roofline.bound_s(roofline.update_bytes(640, 96, 0), 0))
    assert run.reader("update_roofline")(tr) == pytest.approx(
        100 * least / 400e-6)
    assert run.reader("sinv_roofline")(tr) is None


def test_idle_share_and_busy_ms():
    dev = [kernel("a", 0, 1_000_000), kernel("b", 500_000, 1_000_000),
           Interval("Memcpy HtoD", 5_000_000, 5_500_000, "gpu_memcpy")]
    tr = trace(dev, [], window=(0, 10_000_000))
    # busy: [0, 1.5 ms] and [5, 5.5 ms] = 2 ms of 10
    assert run.reader("device.idle_share")(tr) == pytest.approx(80.0)
    assert run.reader("device.busy_ms")(tr) == pytest.approx(1.0)


def test_launches_count_only_what_the_step_launched():
    # two steps; host ops 1-3 begin inside the step's ranges (3 is a
    # range itself, the link of a kernel launched by ctypes), op 4 in the
    # harness's frame range around them (its pose read), op 5 outside
    host = [Interval("slambench.frame", 0, 9_000_000),
            Interval("step.match", 1_000_000, 2_000_000),
            Interval("step.mapman", 4_000_000, 6_000_000)]
    ops = {1: 1_100_000, 2: 4_100_000, 3: 4_000_000, 4: 7_000_000,
           5: 9_500_000}
    dev = [Interval("k1", 1_200_000, 1_300_000, "kernel", 1),
           Interval("k1b", 1_300_000, 1_400_000, "kernel", 1),
           Interval("update_solve", 6_500_000, 6_600_000, "kernel", 3),
           Interval("Memcpy HtoD", 4_200_000, 4_300_000, "gpu_memcpy", 2),
           Interval("copy", 7_200_000, 7_300_000, "kernel", 4),
           Interval("k5", 9_600_000, 9_700_000, "kernel", 5),
           Interval("unlinked", 1_500_000, 1_600_000, "kernel", 0)]
    tr = trace(dev, [], host=host, ops=ops)
    assert run.reader("batch.launches_per_step")(tr) == pytest.approx(1.5)
    # no launch from inside a step's range: nothing to read
    assert run.reader("batch.launches_per_step")(
        trace(dev, [], host=host[:1], ops=ops)) is None


def test_host_readers_and_syncs():
    host = [Interval("step.match", 0, 2_000_000),
            Interval("step.mapman", 2_000_000, 5_000_000),
            Interval("slambench.frame", 0, 6_000_000)]
    tr = trace([kernel("k", 0, 10)], [], host=host, steps=2, frames=2,
               syncs={"step.py:1": 2, "engine.py:2": 2})
    assert run.reader("step.host_ms")(tr) == pytest.approx(2.5)
    assert run.reader("step.mapman_ms")(tr) == pytest.approx(1.5)
    assert run.reader("engine.syncs_per_frame")(tr) == pytest.approx(2.0)


def test_breakdown_attributes_gaps_to_the_innermost_range():
    host = [Interval("slambench.frame", 0, 10_000_000),
            Interval("step.mapman", 6_000_000, 9_000_000)]
    dev = [kernel("k1(int)", 0, 1_000_000), kernel("k2", 5_000_000,
                                                   1_000_000)]
    b = trace(dev, [], host=host).breakdown()
    ops = dict(b["device_ops"])
    assert ops == {"k1": pytest.approx(1e-3), "k2": pytest.approx(1e-3)}
    gaps = dict(b["idle_gaps"])
    # 1-5 ms inside the frame only; 6-10 ms: midpoint 8 ms in mapman
    assert gaps["slambench.frame"] == pytest.approx(4e-3)
    assert gaps["step.mapman"] == pytest.approx(4e-3)


def test_kernel_names_as_the_profiler_gives_them():
    from slambench.trace import short_name
    assert short_name("void sinv_flags<false>(float const*, int)") \
        == "sinv_flags<false>"
    assert short_name("update_factor_batched(float*)") \
        == "update_factor_batched"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::CUDAFunctor_add<float>>(int)") \
        == "vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
    dev = [kernel("void sinv_factor<false>(float*)", 0, 50_000),
           kernel("void (anonymous namespace)::sinv_solve<false>(float*)",
                  50_000, 50_000)]
    tr = trace(dev, [[(120, 0)]], n_state=1024, n_slots=168, steps=1)
    least = (roofline.bound_s(roofline.sinv_bytes(336), 120 ** 3)
             + roofline.bound_s(roofline.sinv_bytes(336), 0))
    assert run.reader("sinv_roofline")(tr) == pytest.approx(
        100 * least / 100e-6)
