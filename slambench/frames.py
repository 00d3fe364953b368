"""The frames of a traffic mix: a window sliding over a blob texture that
repeats along x, so the pan never runs out.

The texture is a dark noisy background with bright square blobs of 2-12 px
(many STAR responses above the s3 threshold of 30), drawn with x taken
modulo the texture's width, so that its columns continue across the seam.
A frame is a view of the texture, extended once by the frame's width: no
pixel is copied or computed while the window runs.
"""

from __future__ import annotations

import numpy as np


def blob_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w) uint8, periodic in x; one blob per 80 pixels."""
    img = rng.integers(0, 30, (h, w)).astype(np.uint8)
    n = h * w // 80
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    rs = rng.integers(1, 7, n)
    vals = rng.integers(60, 256, n).astype(np.uint8)
    for y, x, r, v in zip(ys.tolist(), xs.tolist(), rs.tolist(),
                          vals.tolist()):
        cols = np.arange(x - r, x + r) % w
        img[max(y - r, 0):y + r, cols] = v
    return img


class PanSource:
    """Frame t is the (h, w) window of a periodic texture at column
    ``(start + pan * t) mod period``."""

    def __init__(self, seed: int, h: int, w: int, period: int, pan: int,
                 start: int = 0):
        if period < w:
            raise ValueError(f"texture period {period} below frame width {w}")
        tex = blob_texture(np.random.default_rng(seed), h, period)
        self.texture = np.concatenate([tex, tex[:, :w]], axis=1)
        self.h, self.w, self.period = h, w, period
        self.pan, self.start = pan, start

    def frame(self, t: int) -> np.ndarray:
        x = (self.start + self.pan * t) % self.period
        return self.texture[:, x:x + self.w]
