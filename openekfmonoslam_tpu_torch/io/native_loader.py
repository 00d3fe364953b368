"""ctypes binding for the native C++ frame loader (port of
io/native_loader.py, over native/frameloader.cpp).

Multithreaded libpng decode and grayscale with bounded prefetch: frames
come back as (H, W) uint8 numpy arrays in sequence order while later
frames decode in the background.  The shared library is the prebuilt
``native/lib/libframeloader.so`` (tools/build_native.sh builds it); where
it does not load, ``available()`` is False and the CLI reads frames
through ``io.sources.FileSequenceSource`` (PIL), as the JAX CLI does.
Host-side decoding only: nothing here touches the GPU.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "lib", "libframeloader.so")
_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
        lib.frameloader_create.restype = ctypes.c_void_p
        lib.frameloader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.frameloader_get.restype = ctypes.c_long
        lib.frameloader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.frameloader_count.restype = ctypes.c_int
        lib.frameloader_count.argtypes = [ctypes.c_void_p]
        lib.frameloader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the shared library loads."""
    try:
        _load_lib()
        return True
    except OSError:
        return False


class NativeFrameLoader:
    """Decode-ahead loader over an explicit path list; ``get(i)`` is frame
    i, or None for a file that is missing or does not decode and for an
    index out of range."""

    def __init__(self, paths: Sequence[str], n_threads: int = 0,
                 window: int = 192, max_bytes: int = 4 << 20):
        lib = _load_lib()
        joined = b"\0".join(p.encode() for p in paths) + b"\0"
        self._lib = lib
        self._handle = lib.frameloader_create(joined, len(paths), n_threads,
                                              window)
        if not self._handle:
            raise RuntimeError("frameloader_create failed")
        self._n = len(paths)
        self._max_bytes = max_bytes

    def __len__(self) -> int:
        return self._n

    def get(self, i: int) -> Optional[np.ndarray]:
        buf = np.empty(self._max_bytes, dtype=np.uint8)
        w = ctypes.c_int()
        h = ctypes.c_int()
        n = self._lib.frameloader_get(
            self._handle, i,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._max_bytes, ctypes.byref(w), ctypes.byref(h))
        if n == 0:
            return None
        return buf[:n].reshape(h.value, w.value).copy()

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self._n):
            frame = self.get(i)
            if frame is None:
                return
            yield frame

    def close(self):
        if self._handle:
            self._lib.frameloader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def file_sequence_paths(directory: str, begin: int, end: int,
                        ext: str = "png", prefix: str = "",
                        digits: int = 5) -> list[str]:
    """``<directory>/<prefix>%0<digits>d.<ext>`` for begin..end."""
    return [os.path.join(directory, f"{prefix}{i:0{digits}d}.{ext}")
            for i in range(begin, end + 1)]
