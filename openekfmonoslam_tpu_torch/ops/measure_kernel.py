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

B streams stacked on a leading axis take one launch (the stream is a
grid index; each stream's bits are its single launch's), which the
batched step (parallel/batch_runner.py) reaches under ``torch.func.vmap``
through the wrapper's custom op (ops/batched.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM
from openekfmonoslam_tpu_torch.ops import batched, cuda_lib

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


def measure_cuda(camera: Camera | cuda_lib.CamParams, cam7: torch.Tensor,
                 feats: torch.Tensor, is_xyz: torch.Tensor,
                 active: torch.Tensor, quirks: bool = False):
    """The same four masked arrays from one launch of the CUDA kernel (its
    QUIRKS instantiation with ``quirks``); B streams stacked (a leading B
    axis on every input and output) in the same one launch."""
    feats = feats.contiguous()
    cam7 = cam7.contiguous()
    is_xyz, active = is_xyz.contiguous(), active.contiguous()
    cuda_lib.check_cuda_inputs("measure", {
        "cam7": cam7, "feats": feats, "is_xyz": is_xyz, "active": active})
    lead = tuple(cam7.shape[:-1])
    F = feats.shape[-2]
    if cam7.shape != lead + (7,) or feats.shape != lead + (F, 6) or F < 1 \
            or is_xyz.shape != lead + (F,) or active.shape != lead + (F,) \
            or len(lead) > 1:
        raise ValueError("measure: bad shapes")
    f32 = dict(dtype=torch.float32, device=feats.device)
    uv = torch.empty(lead + (F, 2), **f32)
    Hc = torch.empty(lead + (F, 2, CAM_DIM), **f32)
    Hf = torch.empty(lead + (F, 2, 6), **f32)
    visible = torch.empty(lead + (F,), dtype=torch.bool, device=feats.device)
    cam = (camera if isinstance(camera, cuda_lib.CamParams)
           else cuda_lib.CamParams.from_camera(camera))
    cuda_lib.library().call(
        "ekf_measure_batched", cam7.data_ptr(), feats.data_ptr(),
        is_xyz.data_ptr(), active.data_ptr(), uv.data_ptr(), Hc.data_ptr(),
        Hf.data_ptr(), visible.data_ptr(), F, lead[0] if lead else 1,
        int(quirks), ctypes.byref(cam), cuda_lib.stream_of(feats))
    (QUIRKS_LAUNCHES if quirks else LAUNCHES).hit()
    return uv, Hc, Hf, visible


@functools.cache
def _batched_op():
    def measure_op(cam: list[float], cam7: torch.Tensor, feats: torch.Tensor,
                   is_xyz: torch.Tensor, active: torch.Tensor, quirks: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        return measure_cuda(cuda_lib.CamParams(*cam), cam7, feats, is_xyz,
                            active, quirks)

    def rule(info, in_dims, cam, cam7, feats, is_xyz, active, quirks):
        args = batched.stacked(info.batch_size, in_dims[1:5], cam7, feats,
                               is_xyz, active)
        return (measure_cuda(cuda_lib.CamParams(*cam), *args, quirks),
                (0, 0, 0, 0))

    return batched.custom_op("measure", measure_op, rule)


def measure(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
            is_xyz: torch.Tensor, active: torch.Tensor, quirks: bool = False):
    """The measurement chain: plain version on the CPU, the kernel on CUDA
    (one launch for all streams under ``torch.func.vmap``)."""
    if feats.device.type == "cpu":
        return measure_plain(camera, cam7, feats, is_xyz, active, quirks)
    if batched.any_batched(cam7, feats, is_xyz, active):
        return _batched_op()(cuda_lib.CamParams.values(camera), cam7, feats,
                             is_xyz, active, bool(quirks))
    return measure_cuda(camera, cam7, feats, is_xyz, active, quirks)
