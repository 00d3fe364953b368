"""The measurement-prediction chain as one CUDA kernel (``csrc/measure.cu``).

Replaces the TPU kernel ``_kernel`` / ``measure_chain_pallas``
(openekfmonoslam_tpu/ops/measure_kernel.py:44,237) together with the
caller's masking after it (openekfmonoslam_tpu/filter/measure.py:151-158):
for every slot, the predicted distorted pixel, the visibility gate, Hc
(2x13, columns 7:13 zero) and Hf (2x6), as ``predict_measurements``
consumes them.

Both variants of the TPU kernel are ported: the correct-math chain and,
with ``quirks``, the reference's bug-compatible chain that the parity mode
(``reference_quirks``) runs.  The flag is a template parameter of the CUDA
kernel; the two variants count their launches apart (``LAUNCHES`` and
``QUIRKS_LAUNCHES``).

Bound on the H100: launch latency.  At F = 96 the kernel reads ~2.5 KB,
writes ~16 KB and does ~40 kflop; its time is one thread's dependency
chain (csrc/measure.cu says how the design shortens it).

``measure`` is the wrapper: a CPU tensor runs ``measure_plain`` (the
filter/measure_fast.py chain and the same masks), a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM
from openekfmonoslam_tpu_torch.ops import cuda_lib

LAUNCHES = cuda_lib.LaunchCounter("measure")
QUIRKS_LAUNCHES = cuda_lib.LaunchCounter("measure_quirks")


def measure_plain(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
                  is_xyz: torch.Tensor, active: torch.Tensor,
                  quirks: bool = False):
    """(uv (F,2), Hc (F,2,13), Hf (F,2,6), visible (F,) bool), masked:
    Hc and Hf multiplied by ``visible``, Hf's retired dims of XYZ slots
    by 0, uv 0 where not visible."""
    from openekfmonoslam_tpu_torch.filter import measure_fast

    uv, Hc7, Hf = measure_fast.measurements_with_jacobians(
        camera, cam7, feats, is_xyz, quirks=quirks)
    visible = measure_fast.visibility(camera, cam7, feats, is_xyz, active,
                                      uv)
    F, dtype = Hc7.shape[0], Hc7.dtype
    vis = visible[:, None, None].to(dtype)
    Hc = torch.cat([Hc7 * vis, torch.zeros((F, 2, CAM_DIM - 7), dtype=dtype,
                                           device=Hc7.device)], dim=-1)
    Hf = Hf * vis
    # retired dims of converted-XYZ slots carry no Jacobian
    first3 = torch.arange(FEAT_DIM, device=Hf.device) < 3
    feat_dim_mask = first3[None, :] | ~is_xyz[:, None]
    Hf = Hf * feat_dim_mask[:, None, :].to(dtype)
    uv = torch.where(visible[:, None], uv, torch.zeros_like(uv))
    return uv, Hc, Hf, visible


def measure_cuda(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
                 is_xyz: torch.Tensor, active: torch.Tensor,
                 quirks: bool = False):
    """The same four masked arrays from one launch of the CUDA kernel (its
    QUIRKS instantiation with ``quirks``)."""
    feats = feats.contiguous()
    cam7 = cam7.contiguous()
    cuda_lib.check_cuda_inputs("measure", {
        "cam7": cam7, "feats": feats, "is_xyz": is_xyz, "active": active})
    F = feats.shape[0]
    if cam7.shape != (7,) or feats.shape != (F, 6) or F < 1 \
            or is_xyz.shape != (F,) or active.shape != (F,):
        raise ValueError("measure: bad shapes")
    uv = torch.empty((F, 2), dtype=torch.float32, device=feats.device)
    Hc = torch.empty((F, 2, CAM_DIM), dtype=torch.float32,
                     device=feats.device)
    Hf = torch.empty((F, 2, 6), dtype=torch.float32, device=feats.device)
    visible = torch.empty((F,), dtype=torch.bool, device=feats.device)
    cam = cuda_lib.CamParams.from_camera(camera)
    cuda_lib.library().call(
        "ekf_measure", cam7.data_ptr(), feats.data_ptr(), is_xyz.data_ptr(),
        active.data_ptr(), uv.data_ptr(), Hc.data_ptr(), Hf.data_ptr(),
        visible.data_ptr(), F, int(quirks), ctypes.byref(cam),
        cuda_lib.stream_of(feats))
    (QUIRKS_LAUNCHES if quirks else LAUNCHES).hit()
    return uv, Hc, Hf, visible


def measure(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
            is_xyz: torch.Tensor, active: torch.Tensor, quirks: bool = False):
    """The measurement chain: plain version on the CPU, the kernel on CUDA."""
    if feats.device.type == "cpu":
        return measure_plain(camera, cam7, feats, is_xyz, active, quirks)
    return measure_cuda(camera, cam7, feats, is_xyz, active, quirks)
