"""Dense BRIEF bit-planes as one CUDA kernel (``csrc/brief.cu``).

Replaces the TPU kernel ``_brief_kernel`` / ``dense_planes_pallas``
(openekfmonoslam_tpu/ops/brief_kernel.py:43,110): the bit-planes of the
smoothed image's interior, each bit one compare between two of the
pattern's sample points.  The TPU grid rounds the row count down
(``ih // bh``) and only a shape gate hides it; this grid rounds up, so
every interior row and column is written, at any shape.

Bound on the H100: memory.  At 640x480 with the shipped pattern (256 bits,
half = 16) the function reads the 1.2 MB smoothed image once and writes
eight 448x608 planes (8.7 MB), about 3.0 us at 3.35 TB/s; its 256
compares and 256 bit-inserts a pixel take about 2.1 us at 67 T
operations/s.

Two variants of one design: a block stages its 64x16 output tile with a
halo of ``half`` in shared memory, one thread a column, and writes each
word of a pixel as soon as it is made.
  * ``s256``, the pattern every shipped config uses
    (``make_shared_pattern(256, 33, 7)``): the kernel is a template over
    the compile-time tables of ``csrc/brief_pattern.cuh`` (written by
    ``pattern_header``), so a thread loads its pixel's 64 distinct
    samples into registers (64 shared-memory loads) and makes its 256
    compares on registers.
  * ``generic``, any other pattern of up to 512 bits: the per-bit pair of
    tile offsets is a ``__grid_constant__`` kernel parameter (constant
    bank), so a bit costs two shared-memory loads at uniform offsets.
The wrapper picks the variant from the pattern.

``dense_planes`` is the wrapper: a CPU tensor runs ``dense_planes_plain``
(vision/brief.py ``dense_descriptors_shared``), a CUDA tensor launches the
kernel or raises.

B streams stacked on a leading axis take one launch (the stream is a
grid index; each stream's bits are its single launch's), which the
batched step (parallel/batch_runner.py) reaches under ``torch.func.vmap``
through the wrapper's custom op (ops/batched.py).

Regenerate the pattern header with

    python -m openekfmonoslam_tpu_torch.ops.brief_kernel
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from openekfmonoslam_tpu_torch.ops import batched, cuda_lib
from openekfmonoslam_tpu_torch.vision import brief

LAUNCHES = cuda_lib.LaunchCounter("brief")                 # s256 variant
GENERIC_LAUNCHES = cuda_lib.LaunchCounter("brief_generic")

# the pattern compiled into the s256 variant (config.py DescriptorConfig
# defaults: BytesLength 32, patch 33, seed 7)
SHIPPED = dict(n_bits=256, patch_size=33, seed=7)
HEADER = cuda_lib.CSRC / "brief_pattern.cuh"
# mirrors of csrc/brief.cu: a block's output tile, and the generic
# variant's largest pattern
TILE_W, TILE_H = 64, 16
MAX_BITS = 512


@functools.lru_cache(maxsize=None)
def shipped_pattern() -> tuple[np.ndarray, np.ndarray]:
    return brief.make_shared_pattern(**SHIPPED)


def pattern_header() -> str:
    """The text of ``csrc/brief_pattern.cuh``: the shipped pattern as
    compile-time tables."""
    points, pairs = shipped_pattern()
    half = brief.pattern_half(points)

    def table(rows, per_line):
        cells = [f"{{{a}, {b}}}" for a, b in rows]
        return "\n".join("        " + ", ".join(cells[i:i + per_line]) + ","
                         for i in range(0, len(cells), per_line))

    return f"""\
// Generated by `python -m openekfmonoslam_tpu_torch.ops.brief_kernel` from
// vision/brief.py make_shared_pattern(n_bits={SHIPPED['n_bits']}, \
patch_size={SHIPPED['patch_size']}, seed={SHIPPED['seed']});
// do not edit.  tests/test_torch_frontend_kernels.py checks that it matches.
#pragma once

struct ShippedPattern {{
    static constexpr int half = {half};
    static constexpr int n_points = {len(points)};
    static constexpr int n_bits = {len(pairs)};
    // (dy, dx) of each sample point
    static constexpr signed char point[{len(points)}][2] = {{
{table(points, 8)}
    }};
    // (i1, i2) of each bit: bit j of word w is pair 32 w + j, set when
    // sample i1 < sample i2
    static constexpr unsigned char pair[{len(pairs)}][2] = {{
{table(pairs, 8)}
    }};
}};
"""


class BriefPattern(NamedTuple):
    """A shared-point pattern on the host, and on the device that uses it
    (uploaded once, so a frame copies nothing to the device)."""

    points: np.ndarray          # (P, 2) int32 dy, dx
    pairs: np.ndarray           # (n_bits, 2) int32 indices into points
    half: int                   # largest |offset|: the planes' crop
    points_t: torch.Tensor      # points on ``device``
    pairs_t: torch.Tensor       # pairs on ``device``
    variant: str                # "s256" (the compiled pattern) or "generic"
    tile_offsets: np.ndarray    # (n_bits, 2) int32: the generic variant's
    #                             pair of offsets into the staged tile

    @classmethod
    def make(cls, points, pairs, device) -> "BriefPattern":
        points = np.ascontiguousarray(points, dtype=np.int32)
        pairs = np.ascontiguousarray(pairs, dtype=np.int32)
        if points.ndim != 2 or points.shape[1] != 2 or pairs.ndim != 2 \
                or pairs.shape[1] != 2 or pairs.shape[0] % 32 \
                or pairs.min() < 0 or pairs.max() >= points.shape[0]:
            raise ValueError("BRIEF pattern: points (P, 2) and pairs "
                             "(32 k, 2) of indices into points")
        half = brief.pattern_half(points)
        sp, sq = shipped_pattern()
        shipped = np.array_equal(points, sp) and np.array_equal(pairs, sq)
        return cls(points, pairs, half,
                   torch.as_tensor(points, device=device),
                   torch.as_tensor(pairs, device=device),
                   "s256" if shipped else "generic",
                   tile_offsets(points, pairs, half))


def tile_offsets(points, pairs, half: int) -> np.ndarray:
    """(n_bits, 2) int32: each bit's two samples as offsets from the
    pixel's centre in the generic variant's staged tile (row stride
    TILE_W + 2 half)."""
    flat = points[:, 0] * (TILE_W + 2 * half) + points[:, 1]
    return np.ascontiguousarray(flat[pairs], dtype=np.int32)


def dense_planes_plain(smoothed: torch.Tensor, pattern: BriefPattern):
    return brief.dense_descriptors_shared(smoothed, pattern.points,
                                          pattern.pairs)


def dense_planes_cuda(smoothed: torch.Tensor, pattern: BriefPattern,
                      variant: str | None = None):
    """The same planes from one launch of the CUDA kernel: the pattern's
    own variant, or ``variant`` ("generic" takes any pattern).  B streams'
    images stacked (B, h, w) give the planes stacked, (B, W8, ih, iw),
    from the same one launch; one image gives the W8-tuple."""
    cuda_lib.check_cuda_inputs("brief", {
        "smoothed": smoothed.contiguous(), "points": pattern.points_t,
        "pairs": pattern.pairs_t})
    variant = variant or pattern.variant
    n_bits = pattern.pairs.shape[0]
    if variant == "s256" and pattern.variant != "s256":
        raise ValueError("brief: the s256 variant takes only the shipped "
                         f"pattern {SHIPPED}")
    if variant not in ("s256", "generic") or n_bits > MAX_BITS:
        raise ValueError(f"brief: variant {variant!r} with {n_bits} bits "
                         f"(the generic variant takes up to {MAX_BITS})")
    out = _launch(smoothed, variant, pattern.half, pattern.tile_offsets)
    return out if out.dim() == 4 else tuple(out.unbind(0))


def _launch(smoothed: torch.Tensor, variant: str, half: int,
            offsets: np.ndarray) -> torch.Tensor:
    """(W8, ih, iw) planes of an (h, w) image, or (B, W8, ih, iw) of B
    stacked images, from one launch of ``variant``; ``offsets`` are the
    pattern's ``tile_offsets`` (read by the generic variant)."""
    smoothed = smoothed.contiguous()
    cuda_lib.check_cuda_inputs("brief", {"smoothed": smoothed})
    lead = tuple(smoothed.shape[:-2])
    h, w = smoothed.shape[-2:]
    ih, iw = h - 2 * half, w - 2 * half
    if len(lead) > 1 or ih < 1 or iw < 1:
        raise ValueError(f"brief: a {tuple(smoothed.shape)} image has no "
                         f"interior at half {half}")
    B = lead[0] if lead else 1
    n_bits = offsets.shape[0]
    out = torch.empty(lead + (n_bits // 32, ih, iw), dtype=torch.int32,
                      device=smoothed.device)
    lib = cuda_lib.library()
    if variant == "s256":
        lib.call("ekf_brief_batched", smoothed.data_ptr(), h, w, B,
                 out.data_ptr(), cuda_lib.stream_of(smoothed))
        LAUNCHES.hit()
    else:
        offsets = np.ascontiguousarray(offsets, dtype=np.int32)
        lib.call("ekf_brief_generic_batched", smoothed.data_ptr(), h, w,
                 half, offsets.ctypes.data, n_bits, B, out.data_ptr(),
                 cuda_lib.stream_of(smoothed))
        GENERIC_LAUNCHES.hit()
    return out


@functools.cache
def _batched_op():
    def brief_op(smoothed: torch.Tensor, variant: str, half: int,
                 offsets: torch.Tensor) -> torch.Tensor:
        return _launch(smoothed, variant, half, offsets.numpy())

    def rule(info, in_dims, smoothed, variant, half, offsets):
        (smoothed,) = batched.stacked(info.batch_size, in_dims[:1], smoothed)
        return _launch(smoothed, variant, half, offsets.numpy()), 0

    return batched.custom_op("brief", brief_op, rule)


def dense_planes(smoothed: torch.Tensor, pattern: BriefPattern):
    """W8-tuple of (ih, iw) int32 bit-planes: plain version on the CPU, the
    kernel on CUDA (one launch for all streams under
    ``torch.func.vmap``)."""
    if smoothed.device.type == "cpu":
        return dense_planes_plain(smoothed, pattern)
    if batched.any_batched(smoothed):
        return tuple(_batched_op()(
            smoothed, pattern.variant, pattern.half,
            torch.from_numpy(pattern.tile_offsets)).unbind(0))
    return dense_planes_cuda(smoothed, pattern)


if __name__ == "__main__":
    HEADER.write_text(pattern_header())
    print(f"wrote {HEADER}")
