"""The end-to-end arithmetic: the rate is every frame completed inside the
window over the window's seconds, and the tail is taken over every
sample, not over medians of chunks."""

import time

import numpy as np

from slambench import drivers, run

TRAFFIC = {"frame_hw": [8, 8], "texture_period": 16, "pan_px": [1, 2, 3],
           "check_frames": 0}


class Fake(drivers.Driver):
    """Calls that take a fixed pattern of times, each completing every
    stream's frame."""

    def __init__(self, pattern):
        super().__init__({}, TRAFFIC, 1, "cpu")
        self.pattern = pattern
        self.calls = 0

    def call(self, keep, training=False):
        time.sleep(self.pattern[self.calls % len(self.pattern)])
        self.calls += 1
        return len(self.sources)


def test_rate_counts_frames_completed_inside_the_window():
    d = Fake([0.01])
    samples, frames = d.window(0.5)
    # the call in flight at the close is not counted
    assert d.calls == len(samples) // 3 + 1
    assert frames == len(samples) == 3 * (d.calls - 1)
    rate = frames / 0.5
    assert 0.5 * 3 / 0.0105 * 0.8 < rate <= 3 / 0.01


def test_p95_over_all_samples():
    samples = [0.1 if i % 10 == 9 else 0.01 for i in range(100)]
    assert run.percentile(samples, 95) * 1e3 == np.percentile(
        np.asarray(samples), 95) * 1e3
    # 10 slow samples in 100: the p95 lies among them, where a median of
    # chunks of 20 would not see them
    assert run.percentile(samples, 95) > 0.05
    chunks = [np.median(samples[i:i + 20]) for i in range(0, 100, 20)]
    assert max(chunks) < 0.05


def test_slow_calls_show_in_the_tail():
    d = Fake([0.005] * 9 + [0.05])
    samples, _ = d.window(1.0)
    assert run.percentile(samples, 95) >= 0.045
    assert run.percentile(samples, 50) < 0.01


def test_sample_is_uniform_over_the_window_and_fixed_by_the_seed():
    def draw(seed):
        d = Fake([0.0])
        d.seed = seed
        d.pick = np.random.default_rng((seed, 1 << 20))
        d.traffic = dict(TRAFFIC, check_frames=16)
        kept = []
        for i in range(3000):
            at = d._offer()
            if at is not None:
                d._store(at, i)
        return sorted(d.kept)

    a, b = draw(5), draw(5)
    assert a == b and len(a) == 16 and len(set(a)) == 16
    assert draw(6) != a
    # a uniform sample of 3000 calls: some from each third, over many seeds
    thirds = np.zeros(3)
    for seed in range(40):
        for i in draw(seed):
            thirds[i // 1000] += 1
    assert thirds.min() > 0.25 * thirds.sum()
