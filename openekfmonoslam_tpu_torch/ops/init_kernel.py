"""The feature-initialization chain as one CUDA kernel (``csrc/init.cu``).

Replaces the TPU kernel ``_init_kernel`` / ``init_chain_pallas``
(openekfmonoslam_tpu/ops/init_kernel.py:48,138): per candidate pixel, the
inverse-depth feature (undistort -> back-project -> rotate -> bearing
angles) with its hand-derived Jacobians J1 = d(feat)/d(r, q) and
J2 = d(feat)/d(u, v, rho), in the padded (C, 6), (C, 6, 7), (C, 6, 3)
shapes.  The bearing atan2 runs inside the kernel (the TPU caller took it
outside: Mosaic has no atan2).

Bound on the H100: launch latency.  At C = 96 the kernel reads 0.8 KB,
writes ~25 KB and does ~20 kflop.  Design: one thread per candidate.

``init_chain`` is the wrapper: a CPU tensor runs ``init_plain`` (the
vmapped forward-mode Jacobian of filter/features.py init_feature, the
chain the JAX package runs off the TPU), a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.ops import cuda_lib

LAUNCHES = cuda_lib.LaunchCounter("init")


def init_plain(camera: Camera, cam7: torch.Tensor, cand_uv: torch.Tensor,
               rho0: float):
    """(feats (C, 6), J1 (C, 6, 7), J2 (C, 6, 3)) by forward-mode
    differentiation of init_feature, vmapped over the candidates."""
    from torch.func import jacfwd, vmap

    from openekfmonoslam_tpu_torch.filter.features import init_feature

    C = cand_uv.shape[0]
    uv_rho = torch.cat([cand_uv, torch.full((C, 1), rho0, dtype=cand_uv.dtype,
                                            device=cand_uv.device)], dim=1)

    def f(c7, m):
        return init_feature(camera, c7, m)

    feats = vmap(f, in_dims=(None, 0))(cam7, uv_rho)
    J1 = vmap(jacfwd(f, argnums=0), in_dims=(None, 0))(cam7, uv_rho)
    J2 = vmap(jacfwd(f, argnums=1), in_dims=(None, 0))(cam7, uv_rho)
    return feats, J1, J2


def init_cuda(camera: Camera, cam7: torch.Tensor, cand_uv: torch.Tensor,
              rho0: float):
    """The same three arrays from one launch of the CUDA kernel."""
    cam7 = cam7.contiguous()
    cand_uv = cand_uv.contiguous()
    cuda_lib.check_cuda_inputs("init", {"cam7": cam7, "cand_uv": cand_uv})
    C = cand_uv.shape[0]
    if cam7.shape != (7,) or cand_uv.shape != (C, 2) or C < 1:
        raise ValueError("init: bad shapes")
    dev = cand_uv.device
    feats = torch.empty((C, 6), dtype=torch.float32, device=dev)
    J1 = torch.empty((C, 6, 7), dtype=torch.float32, device=dev)
    J2 = torch.empty((C, 6, 3), dtype=torch.float32, device=dev)
    cam = cuda_lib.CamParams.from_camera(camera)
    cuda_lib.library().call(
        "ekf_init", cam7.data_ptr(), cand_uv.data_ptr(), feats.data_ptr(),
        J1.data_ptr(), J2.data_ptr(), C, float(rho0), ctypes.byref(cam),
        cuda_lib.stream_of(cand_uv))
    LAUNCHES.hit()
    return feats, J1, J2


def init_chain(camera: Camera, cam7: torch.Tensor, cand_uv: torch.Tensor,
               rho0: float):
    """The init chain: plain version on the CPU, the kernel on CUDA."""
    if cand_uv.device.type == "cpu":
        return init_plain(camera, cam7, cand_uv, rho0)
    return init_cuda(camera, cam7, cand_uv, rho0)
