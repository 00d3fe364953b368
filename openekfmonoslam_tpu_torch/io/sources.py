"""Frame sources (port of io/sources.py), mirroring the reference's
ImageGenerator hierarchy.  A source is an iterator of (H, W) uint8
grayscale numpy arrays; exhaustion signals end-of-stream.

  * FileSequenceSource         %05d-numbered frames in [begin, end]
                               (FileSequenceImageGenerator.cpp:61-97)
  * FileSequenceOnDemandSource the same, with wall-clock real-time frame
                               skipping (FileSequenceOnDemandImageGenerator
                               .cpp:67-115)
  * VideoFileSource            cv2.VideoCapture wrapper
                               (VideoFileImageGenerator.cpp:76-113)
  * CameraSource               live capture device
                               (CameraImageGenerator.cpp:52-71)
  * SlidingWindowSource        synthetic pure-translation sequence from one
                               still (SlidingWindowImageGenerator.cpp:65-81)

PIL and cv2 are imported where a source reads a file or a device.  The
CLI reads a directory through the native loader (io/native_loader.py)
where its shared library loads, and through FileSequenceSource otherwise.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

_LUMA = np.asarray([0.299, 0.587, 0.114], dtype=np.float32)


def to_gray(frame: np.ndarray) -> np.ndarray:
    """RGB(A)/gray uint8 -> gray uint8 (OpenCV luma weights)."""
    if frame.ndim == 2:
        return frame
    rgb = frame[..., :3].astype(np.float32)
    return (rgb @ _LUMA).astype(np.uint8)


class FileSequenceSource:
    """Numbered image files: ``<dir>/<prefix>%0<digits>d.<ext>``."""

    def __init__(self, directory: str, begin: int, end: int,
                 ext: str = "png", prefix: str = "", digits: int = 5):
        self.directory = directory
        self.begin = begin
        self.end = end
        self.ext = ext
        self.prefix = prefix
        self.digits = digits

    def path(self, i: int) -> str:
        name = f"{self.prefix}{i:0{self.digits}d}.{self.ext}"
        return os.path.join(self.directory, name)

    def __len__(self) -> int:
        return self.end - self.begin + 1

    def __iter__(self) -> Iterator[np.ndarray]:
        from PIL import Image
        for i in range(self.begin, self.end + 1):
            p = self.path(i)
            if not os.path.exists(p):
                return
            yield to_gray(np.asarray(Image.open(p)))


class FileSequenceOnDemandSource(FileSequenceSource):
    """Real-time simulation: frames are *skipped* according to the wall
    clock elapsed between pulls times the nominal frame rate
    (FileSequenceOnDemandImageGenerator.cpp:67-115) -- a slow consumer
    sees the sequence advance as if it were a live camera.
    """

    def __init__(self, directory: str, begin: int, end: int,
                 frame_rate: float, ext: str = "png", prefix: str = "",
                 digits: int = 5, clock=None):
        super().__init__(directory, begin, end, ext, prefix, digits)
        self.frame_rate = frame_rate
        import time as _time
        self._clock = clock if clock is not None else _time.perf_counter

    def __iter__(self) -> Iterator[np.ndarray]:
        from PIL import Image
        i = self.begin
        last = self._clock()
        while i <= self.end:
            p = self.path(i)
            if not os.path.exists(p):
                return
            yield to_gray(np.asarray(Image.open(p)))
            now = self._clock()
            # advance by elapsed-time * fps; a faster-than-fps consumer
            # re-reads the current frame, exactly like the reference
            # (framesToSetForward may be 0, FileSequenceOnDemand...cpp:76)
            skip = int((now - last) * self.frame_rate)
            i += skip
            if skip > 0:
                last = now


class VideoFileSource:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2
        cap = cv2.VideoCapture(self.path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield to_gray(frame[..., ::-1])   # BGR -> RGB -> gray
        finally:
            cap.release()


class CameraSource:
    def __init__(self, device: int = 0, max_frames: Optional[int] = None):
        self.device = device
        self.max_frames = max_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        import cv2
        cap = cv2.VideoCapture(self.device)
        n = 0
        try:
            while self.max_frames is None or n < self.max_frames:
                ok, frame = cap.read()
                if not ok:
                    return
                yield to_gray(frame[..., ::-1])
                n += 1
        finally:
            cap.release()


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
