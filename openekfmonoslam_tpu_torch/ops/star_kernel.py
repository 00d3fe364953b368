"""STAR scoring and non-max suppression as one CUDA kernel
(``csrc/star.cu``).

Replaces the TPU kernels ``_resp_kernel`` and ``_score_kernel`` /
``star_scores_fused`` (openekfmonoslam_tpu/ops/star_kernel.py:45,69,126):
from the integral image, the scale-max center-surround response, then the
gradients, 5x5 structure tensor, line gate and threshold (the pre-NMS
map) and the (2r+1)^2 non-max suppression (the NMS'd map).  The integral
image before it stays PyTorch (``vision/star._integral``), as it stayed
XLA.

Unlike the TPU kernel, which computes on a 5 px extended grid and differs
from the XLA chain near the border, this one follows the plain chain's
edge rules exactly, so both maps equal the plain version on every pixel:
clamped indices for the gradients and box sums, pixels outside the image
ignored by the NMS window.

Bound on the H100: memory.  At 640x480 the function reads the 547x707
float32 integral image once (1.5 MB) and writes two 480x640 maps (2.5 MB),
about 1.2 us at 3.35 TB/s; its ~160 flop a pixel take 0.7 us at 67
TFLOP/s.  Design: one launch.  A block owns a TILE_H x (FRAME_W - 2e)
output tile, e = 3 + nms_radius (132 blocks of 1024 threads at 640x480),
and computes every stage in shared memory on the tile and its halo of e,
so nothing but the two maps goes back to device memory.  Stage A, the
response, reads the integral image one of two ways, the *route*, picked
by ``star_plan`` from the settings: ``staged`` copies the window its
boxes reach into shared memory first (75 KB a block at the s3 max
size 16; it fits up to max size 44), ``direct`` reads it through the
read-only path.  Every rounding is spelled out (``__fmul_rn``,
``__fadd_rn``, ``__fmaf_rn`` where the plain chain fuses) so that the
compiler contracts nothing.

``star_from_integral`` is the wrapper: a CPU tensor runs ``star_plain``, a
CUDA tensor launches the kernel or raises.

B streams stacked on a leading axis take one launch (the stream is a
grid index; each stream's bits are its single launch's), which the
batched step (parallel/batch_runner.py) reaches under ``torch.func.vmap``
through the wrapper's custom op (ops/batched.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.ops import batched, cuda_lib
from openekfmonoslam_tpu_torch.vision import fast, star

LAUNCHES = cuda_lib.LaunchCounter("star")                # staged route
DIRECT_LAUNCHES = cuda_lib.LaunchCounter("star_direct")

# mirrors of csrc/star.cu: a block's output rows, its frame's columns, the
# shared memory a block may opt into on the H100, and the most sizes the
# staged route is built for
TILE_H, FRAME_W = 44, 64
SMEM_MAX = 227 * 1024
STAGED_SIZES = 10


class StarSettings(NamedTuple):
    """The detector's STAR parameters (config.DetectorConfig)."""

    max_size: int = 16
    response_threshold: float = 30.0
    line_threshold: float = 10.0
    nms_radius: int = 2


def star_plain(ii: torch.Tensor, h: int, w: int, s: StarSettings):
    """(score_raw, score_nms): vision/star.py's chain after the integral
    image, then vision/fast.py's non-max suppression."""
    raw = star.scores_from_integral(ii, h, w, s.max_size,
                                    s.response_threshold, s.line_threshold)
    return raw, fast.non_max_suppress(raw, s.nms_radius)


def star_params(h: int, w: int, ii_w: int, s: StarSettings
                ) -> cuda_lib.StarParams:
    sizes = star.star_sizes(s.max_size)
    p = cuda_lib.StarParams(
        h=h, w=w, ii_w=ii_w, pad=star.integral_pad(s.max_size),
        n_sizes=len(sizes), nms_radius=s.nms_radius,
        response_threshold=s.response_threshold,
        line_threshold=s.line_threshold)
    for k, n in enumerate(sizes):
        p.size[k] = n
        p.fuse[k] = star.fused_term(n, sizes)
        p.r_in[k] = star.inv_area(n)
        p.r_out[k] = star.inv_area(2 * n)
    return p


def star_plan(s: StarSettings) -> tuple[str, int]:
    """(route, shared-memory bytes a block) of the kernel under ``s``:
    "staged" where the integral-image window and the response map fit in
    SMEM_MAX, else "direct".  The frame's four later maps reuse the
    window's room.  ``ekf_star`` sizes the same way."""
    e = 3 + s.nms_radius
    plane = (TILE_H + 2 * e) * FRAME_W
    pad = star.integral_pad(s.max_size)
    window = (TILE_H + 2 * e + 2 * pad - 1) * (FRAME_W + 2 * pad - 1)
    staged = 4 * (plane + max(window, 4 * plane))
    if staged <= SMEM_MAX \
            and len(star.star_sizes(s.max_size)) <= STAGED_SIZES:
        return "staged", staged
    return "direct", 4 * 5 * plane


def star_cuda(ii: torch.Tensor, h: int, w: int, s: StarSettings,
              route: str | None = None):
    """The same two maps from one launch of the CUDA kernel, by
    ``star_plan``'s route or by ``route`` ("direct" takes any settings);
    B streams' integral images stacked (B, ...) give (B, h, w) maps from
    the same one launch."""
    ii = ii.contiguous()
    cuda_lib.check_cuda_inputs("star", {"ii": ii})
    pad = star.integral_pad(s.max_size)
    lead = tuple(ii.shape[:-2])
    if (ii.shape != lead + (h + 2 * pad + 1, w + 2 * pad + 1) or h < 1
            or w < 1 or len(lead) > 1):
        raise ValueError(f"star: integral image {tuple(ii.shape)} does not "
                         f"match a {h}x{w} frame with pad {pad}")
    if len(star.star_sizes(s.max_size)) > cuda_lib.STAR_MAX_SIZES \
            or not 0 <= s.nms_radius < FRAME_W // 2 - 3:
        raise ValueError("star: unsupported settings")
    planned = star_plan(s)[0]
    route = route or planned
    if route not in ("staged", "direct") or (route, planned) == ("staged",
                                                                 "direct"):
        raise ValueError(f"star: route {route!r} under {s} (planned "
                         f"{planned!r})")
    raw = torch.empty(lead + (h, w), dtype=torch.float32, device=ii.device)
    nms = torch.empty_like(raw)
    params = star_params(h, w, ii.shape[-1], s)
    cuda_lib.library().call("ekf_star_batched", ii.data_ptr(),
                            ctypes.byref(params), int(route == "staged"),
                            lead[0] if lead else 1, raw.data_ptr(),
                            nms.data_ptr(), cuda_lib.stream_of(ii))
    (LAUNCHES if route == "staged" else DIRECT_LAUNCHES).hit()
    return raw, nms


@functools.cache
def _batched_op():
    def star_op(ii: torch.Tensor, h: int, w: int, max_size: int,
                response_threshold: float, line_threshold: float,
                nms_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
        return star_cuda(ii, h, w, StarSettings(
            max_size, response_threshold, line_threshold, nms_radius))

    def rule(info, in_dims, ii, h, w, *settings):
        (ii,) = batched.stacked(info.batch_size, in_dims[:1], ii)
        return star_cuda(ii, h, w, StarSettings(*settings)), (0, 0)

    return batched.custom_op("star", star_op, rule)


def star_from_integral(ii: torch.Tensor, h: int, w: int, s: StarSettings):
    """(score_raw, score_nms) of an (h, w) frame from its integral image:
    plain version on the CPU, the kernel on CUDA (one launch for all
    streams under ``torch.func.vmap``)."""
    if ii.device.type == "cpu":
        return star_plain(ii, h, w, s)
    if batched.any_batched(ii):
        return _batched_op()(ii, h, w, int(s.max_size),
                             float(s.response_threshold),
                             float(s.line_threshold), int(s.nms_radius))
    return star_cuda(ii, h, w, s)


def star_scores_fused(gray: torch.Tensor, s: StarSettings):
    """(score_raw, score_nms) of a frame: the integral image, then
    ``star_from_integral``."""
    h, w = gray.shape
    ii = star._integral(gray, star.integral_pad(s.max_size))
    return star_from_integral(ii, h, w, s)
