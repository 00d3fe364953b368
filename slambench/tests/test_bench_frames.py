"""The frame source: the same seed gives the same frames, and the pan never
runs out."""

import numpy as np

from slambench.frames import PanSource, blob_texture


def test_same_seed_same_frames():
    a = PanSource((2 ** 31 + 5, 0), 48, 64, 256, 2)
    b = PanSource((2 ** 31 + 5, 0), 48, 64, 256, 2)
    c = PanSource((2 ** 31 + 6, 0), 48, 64, 256, 2)
    for t in (0, 1, 17, 10 ** 6):
        assert np.array_equal(a.frame(t), b.frame(t))
    assert not np.array_equal(a.frame(0), c.frame(0))


def test_pan_never_runs_out_and_wraps():
    s = PanSource((7, 1), 48, 64, 256, 3)
    for t in (0, 85, 86, 10 ** 9):
        f = s.frame(t)
        assert f.shape == (48, 64) and f.dtype == np.uint8
    # the period brings the same window back
    assert np.array_equal(s.frame(0), s.frame(256))
    # a frame across the seam is the texture's columns taken modulo its width
    x = (3 * 85) % 256
    cols = (x + np.arange(64)) % 256
    assert np.array_equal(s.frame(85), s.texture[:, :256][:, cols])


def test_texture_is_periodic_in_x():
    """No blob is cut at the seam: a blob drawn across it continues on the
    other side, so column 0 follows column w-1 as any other pair does."""
    tex = blob_texture(np.random.default_rng(3), 96, 200)
    assert tex.shape == (96, 200) and tex.dtype == np.uint8
    bright = tex >= 60
    assert bright.mean() > 0.05
    # a bright run ending at the last column goes on at column 0 as often as
    # a bright pair of neighbouring columns occurs elsewhere
    seam = np.mean(bright[:, -1] & bright[:, 0])
    inner = np.mean(bright[:, :-1] & bright[:, 1:])
    assert seam > 0.5 * inner
