"""Frame sources (port of io/sources.py: ``to_gray`` and the synthetic
``SlidingWindowSource``; the file, video and camera sources come with the
CLI).  A source is an iterator of (H, W) uint8 grayscale numpy arrays.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

_LUMA = np.asarray([0.299, 0.587, 0.114], dtype=np.float32)


def to_gray(frame: np.ndarray) -> np.ndarray:
    """RGB(A)/gray uint8 -> gray uint8 (OpenCV luma weights)."""
    if frame.ndim == 2:
        return frame
    rgb = frame[..., :3].astype(np.float32)
    return (rgb @ _LUMA).astype(np.uint8)


class SlidingWindowSource:
    """Slide a (h, w) window across one still image: a known
    pure-translation input for testing (SlidingWindowImageGenerator.cpp)."""

    def __init__(self, still: np.ndarray, window_hw: tuple,
                 step_xy: tuple = (2, 0), n_frames: int = 100):
        self.still = to_gray(still)
        self.window_hw = window_hw
        self.step_xy = step_xy
        self.n_frames = n_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        h, w = self.window_hw
        sx, sy = self.step_xy
        H, W = self.still.shape
        for i in range(self.n_frames):
            x = min(i * sx, W - w)
            y = min(i * sy, H - h)
            yield self.still[y:y + h, x:x + w]
