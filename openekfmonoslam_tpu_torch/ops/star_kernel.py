"""STAR scoring and non-max suppression as CUDA kernels (``csrc/star.cu``).

Replaces the TPU kernels ``_resp_kernel`` and ``_score_kernel`` /
``star_scores_fused`` (openekfmonoslam_tpu/ops/star_kernel.py:45,69,126):
from the integral image, the scale-max center-surround response, then the
gradients, 5x5 structure tensor, line gate and threshold (the pre-NMS
map) and the 5x5 non-max suppression (the NMS'd map).  The integral image
before it stays PyTorch (``vision/star._integral``), as it stayed XLA.

Unlike the TPU kernel, which computes on a 5 px extended grid and differs
from the XLA chain near the border, this one follows the plain chain's
edge rules exactly, so both maps equal the plain version on every pixel:
clamped indices for the gradients and box sums, pixels outside the image
ignored by the NMS window.

Bound on the H100: memory.  At 640x480 the function reads the 547x707
float32 integral image once (1.5 MB) and writes two 480x640 maps (2.5 MB),
about 1.2 us at 3.35 TB/s; its ~160 flop a pixel take 0.7 us at 67
TFLOP/s.  Design: three launches, one thread a pixel.  ``star_resp`` reads
its 64 integral values through L1/L2 (the whole image fits in L2);
``star_score`` stages the gradients of its 32x8 tile with a halo of 2 in
shared memory and sums the products from there; ``star_nms`` needs the
finished pre-NMS map at its neighbours, hence the third launch.  The
scale-max map is a scratch buffer.  Every rounding is spelled out
(``__fmul_rn``, ``__fadd_rn``, ``__fmaf_rn`` where the plain chain fuses)
so that the compiler contracts nothing.

``star_from_integral`` is the wrapper: a CPU tensor runs ``star_plain``, a
CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.ops import cuda_lib
from openekfmonoslam_tpu_torch.vision import fast, star

LAUNCHES = cuda_lib.LaunchCounter("star")


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


def star_cuda(ii: torch.Tensor, h: int, w: int, s: StarSettings):
    """The same two maps from the three CUDA launches."""
    ii = ii.contiguous()
    cuda_lib.check_cuda_inputs("star", {"ii": ii})
    pad = star.integral_pad(s.max_size)
    if ii.shape != (h + 2 * pad + 1, w + 2 * pad + 1) or h < 1 or w < 1:
        raise ValueError(f"star: integral image {tuple(ii.shape)} does not "
                         f"match a {h}x{w} frame with pad {pad}")
    if len(star.star_sizes(s.max_size)) > cuda_lib.STAR_MAX_SIZES \
            or s.nms_radius < 0:
        raise ValueError("star: unsupported settings")
    best = torch.empty((h, w), dtype=torch.float32, device=ii.device)
    raw = torch.empty_like(best)
    nms = torch.empty_like(best)
    params = star_params(h, w, ii.shape[1], s)
    cuda_lib.library().call("ekf_star", ii.data_ptr(), ctypes.byref(params),
                            best.data_ptr(), raw.data_ptr(), nms.data_ptr(),
                            cuda_lib.stream_of(ii))
    LAUNCHES.hit()
    return raw, nms


def star_from_integral(ii: torch.Tensor, h: int, w: int, s: StarSettings):
    """(score_raw, score_nms) of an (h, w) frame from its integral image:
    plain version on the CPU, the kernels on CUDA."""
    if ii.device.type == "cpu":
        return star_plain(ii, h, w, s)
    return star_cuda(ii, h, w, s)


def star_scores_fused(gray: torch.Tensor, s: StarSettings):
    """(score_raw, score_nms) of a frame: the integral image, then
    ``star_from_integral``."""
    h, w = gray.shape
    ii = star._integral(gray, star.integral_pad(s.max_size))
    return star_from_integral(ii, h, w, s)
