"""Dense BRIEF bit-planes as one CUDA kernel (``csrc/brief.cu``).

Replaces the TPU kernel ``_brief_kernel`` / ``dense_planes_pallas``
(openekfmonoslam_tpu/ops/brief_kernel.py:43,110): the 8 int32 bit-planes
of the smoothed image's interior, each bit one compare between two of the
64 shared sample points.  The TPU grid rounds the row count down
(``ih // bh``) and only a shape gate hides it; this grid rounds up, so
every interior row and column is written, at any shape.

Bound on the H100: memory.  At 640x480 with half = 16 the function reads
the 1.2 MB smoothed image once and writes eight 448x608 planes (8.7 MB),
about 3.0 us at 3.35 TB/s; its 256 compares and 256 bit-inserts a pixel
take about 2.1 us at 67 T operations/s.  Design: a block stages its 32x16
output tile with a halo of ``half`` in shared memory (12 KB at half = 16)
and each thread makes its 256 compares from there, both offsets of a pair
read from shared memory as one broadcast.

``dense_planes`` is the wrapper: a CPU tensor runs ``dense_planes_plain``
(vision/brief.py ``dense_descriptors_shared``), a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openekfmonoslam_tpu_torch.ops import cuda_lib
from openekfmonoslam_tpu_torch.vision import brief

LAUNCHES = cuda_lib.LaunchCounter("brief")


class BriefPattern(NamedTuple):
    """A shared-point pattern on the host, and on the device that uses it
    (uploaded once, so a frame copies nothing to the device)."""

    points: np.ndarray          # (P, 2) int32 dy, dx
    pairs: np.ndarray           # (n_bits, 2) int32 indices into points
    half: int                   # largest |offset|: the planes' crop
    points_t: torch.Tensor      # points on ``device``
    pairs_t: torch.Tensor       # pairs on ``device``

    @classmethod
    def make(cls, points, pairs, device) -> "BriefPattern":
        points = np.ascontiguousarray(points, dtype=np.int32)
        pairs = np.ascontiguousarray(pairs, dtype=np.int32)
        if points.ndim != 2 or points.shape[1] != 2 or pairs.ndim != 2 \
                or pairs.shape[1] != 2 or pairs.shape[0] % 32 \
                or pairs.min() < 0 or pairs.max() >= points.shape[0]:
            raise ValueError("BRIEF pattern: points (P, 2) and pairs "
                             "(32 k, 2) of indices into points")
        return cls(points, pairs, brief.pattern_half(points),
                   torch.as_tensor(points, device=device),
                   torch.as_tensor(pairs, device=device))


def dense_planes_plain(smoothed: torch.Tensor, pattern: BriefPattern):
    return brief.dense_descriptors_shared(smoothed, pattern.points,
                                          pattern.pairs)


def dense_planes_cuda(smoothed: torch.Tensor, pattern: BriefPattern):
    """The same planes from one launch of the CUDA kernel."""
    smoothed = smoothed.contiguous()
    cuda_lib.check_cuda_inputs("brief", {
        "smoothed": smoothed, "points": pattern.points_t,
        "pairs": pattern.pairs_t})
    h, w = smoothed.shape
    half = pattern.half
    ih, iw = h - 2 * half, w - 2 * half
    if ih < 1 or iw < 1:
        raise ValueError(f"brief: a {h}x{w} image has no interior at "
                         f"half {half}")
    n_bits = pattern.pairs.shape[0]
    out = torch.empty((n_bits // 32, ih, iw), dtype=torch.int32,
                      device=smoothed.device)
    cuda_lib.library().call(
        "ekf_brief", smoothed.data_ptr(), h, w, half,
        pattern.points_t.data_ptr(), pattern.pairs_t.data_ptr(), n_bits,
        out.data_ptr(), cuda_lib.stream_of(smoothed))
    LAUNCHES.hit()
    return tuple(out.unbind(0))


def dense_planes(smoothed: torch.Tensor, pattern: BriefPattern):
    """W8-tuple of (ih, iw) int32 bit-planes: plain version on the CPU, the
    kernel on CUDA."""
    if smoothed.device.type == "cpu":
        return dense_planes_plain(smoothed, pattern)
    return dense_planes_cuda(smoothed, pattern)
