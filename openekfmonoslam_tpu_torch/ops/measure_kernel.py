"""The measurement-prediction chain as one CUDA kernel (``csrc/measure.cu``).

Replaces the TPU kernel ``_kernel`` / ``measure_chain_pallas``
(openekfmonoslam_tpu/ops/measure_kernel.py:44,237): for every slot, the
predicted distorted pixel, the visibility gate, Hc7 (2x7) and Hf (2x6).

Bound on the H100: launch latency.  At F = 96 the kernel reads ~2.5 KB,
writes ~11 KB and does ~40 kflop.  Design: one thread per slot, outputs in
the (F, 2), (F, 2, 7), (F, 2, 6), (F,) layouts the caller consumes (no
lane padding, no row packing).  The reference-quirks chain is not ported.

``measure`` is the wrapper: a CPU tensor runs ``measure_plain`` (the
filter/measure_fast.py chain), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.ops import cuda_lib

LAUNCHES = cuda_lib.LaunchCounter("measure")


def measure_plain(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
                  is_xyz: torch.Tensor, active: torch.Tensor):
    """(uv (F,2), Hc7 (F,2,7), Hf (F,2,6), visible (F,) bool)."""
    from openekfmonoslam_tpu_torch.filter import measure_fast

    uv, Hc7, Hf = measure_fast.measurements_with_jacobians(
        camera, cam7, feats, is_xyz)
    visible = measure_fast.visibility(camera, cam7, feats, is_xyz, active,
                                      uv)
    return uv, Hc7, Hf, visible


def measure_cuda(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
                 is_xyz: torch.Tensor, active: torch.Tensor):
    """The same four arrays from one launch of the CUDA kernel."""
    feats = feats.contiguous()
    cam7 = cam7.contiguous()
    cuda_lib.check_cuda_inputs("measure", {
        "cam7": cam7, "feats": feats, "is_xyz": is_xyz, "active": active})
    F = feats.shape[0]
    if cam7.shape != (7,) or feats.shape != (F, 6) or F < 1 \
            or is_xyz.shape != (F,) or active.shape != (F,):
        raise ValueError("measure: bad shapes")
    uv = torch.empty((F, 2), dtype=torch.float32, device=feats.device)
    Hc7 = torch.empty((F, 2, 7), dtype=torch.float32, device=feats.device)
    Hf = torch.empty((F, 2, 6), dtype=torch.float32, device=feats.device)
    visible = torch.empty((F,), dtype=torch.bool, device=feats.device)
    cam = cuda_lib.CamParams.from_camera(camera)
    cuda_lib.library().call(
        "ekf_measure", cam7.data_ptr(), feats.data_ptr(), is_xyz.data_ptr(),
        active.data_ptr(), uv.data_ptr(), Hc7.data_ptr(), Hf.data_ptr(),
        visible.data_ptr(), F, ctypes.byref(cam), cuda_lib.stream_of(feats))
    LAUNCHES.hit()
    return uv, Hc7, Hf, visible


def measure(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
            is_xyz: torch.Tensor, active: torch.Tensor):
    """The measurement chain: plain version on the CPU, the kernel on CUDA."""
    if feats.device.type == "cpu":
        return measure_plain(camera, cam7, feats, is_xyz, active)
    return measure_cuda(camera, cam7, feats, is_xyz, active)
