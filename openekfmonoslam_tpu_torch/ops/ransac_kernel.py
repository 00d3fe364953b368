"""1-point RANSAC's hypotheses and support count as one CUDA kernel
(``csrc/ransac.cu``).

Replaces no TPU kernel: the JAX package runs RANSAC as plain XLA.  The
plain chain below, a few hundred small PyTorch ops over (F, F) elements,
cost the host about a quarter of every live frame in launches that each
gave the card about 2 us of work; the kernel does all of it in one launch.
For every matched slot h, a state-only 1-point update (the hypothesis),
then every slot re-predicted from the hypothesised state and counted where
it lands within ``threshold`` pixels of its match: ``(support (F,) int32,
good (F, F) bool)``, row h the slots hypothesis h supports.

``support_plain`` is the plain version (``hypotheses_plain`` then
``count_plain``, the chain ``filter/ransac.py`` runs on the CPU),
``support_cuda`` one launch (the ``deadband`` flag, the parity mode's
DELTA deadband on dz and dx, picks a template instantiation), and
``support`` the wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises.

Bound on the H100: launch latency and one thread's dependency chain (the
Newton distortion).  The bytes that must move are the two rows of H P a
hypothesis reads, 2F (7 + 6F) floats: about 0.14 us at F = 96 and 0.41 us
at F = 168 at 3.35 TB/s.

B streams stacked on a leading axis take one launch (the stream is a grid
index; each stream's bits are its single launch's), which the batched step
(parallel/batch_runner.py) reaches under ``torch.func.vmap`` through the
wrapper's custom op (ops/batched.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.measure import (measure_one,
                                                      point_in_camera_frame)
from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM
from openekfmonoslam_tpu_torch.filter.update import deadbanded
from openekfmonoslam_tpu_torch.ops import batched, cuda_lib

LAUNCHES = cuda_lib.LaunchCounter("ransac_support")   # both variants


def solve2x2(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 solve: (..., 2, 2) x (..., 2) -> (..., 2)."""
    a, c = S[..., 0, 0], S[..., 0, 1]
    d, e = S[..., 1, 0], S[..., 1, 1]
    det = a * e - c * d
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20),
                      det)
    x0 = (e * b[..., 0] - c * b[..., 1]) / det
    x1 = (a * b[..., 1] - d * b[..., 0]) / det
    return torch.stack([x0, x1], dim=-1)


def hypotheses_plain(x: torch.Tensor, HP: torch.Tensor, S: torch.Tensor,
                     z: torch.Tensor, uv: torch.Tensor,
                     matched: torch.Tensor, pixel_error: float,
                     deadband: bool = False) -> torch.Tensor:
    """(F, N) hypothesized state vectors: one state-only 1-point update
    per matched slot, K_i dz_i = (H_i P)^T S_i^-1 dz_i with the rows of
    the shared H P (P is symmetric).  ``deadband``: updateOnlyState runs
    through the reference's deadbanded stateUpdate (Update.cpp:133-203)."""
    F = uv.shape[0]
    HPr = HP.reshape(F, 2, -1)
    S = S + (pixel_error - 1.0) * torch.eye(2, dtype=S.dtype,
                                            device=S.device)[None]
    dz = z - uv
    if deadband:
        dz = deadbanded(dz)
    sol = solve2x2(S, dz)
    dx = torch.einsum("fin,fi->fn", HPr, sol)
    if deadband:
        dx = deadbanded(dx)
    dx = dx * matched[:, None].to(x.dtype)
    return x[None, :] + dx


def count_plain(states_x: torch.Tensor, camera: Camera, z: torch.Tensor,
                matched: torch.Tensor, active: torch.Tensor,
                is_xyz: torch.Tensor, threshold: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(support (F,) int32, good (F, F) bool): per hypothesis, the matched
    slots re-predicted within ``threshold`` pixels (matchesBelowAThreshold,
    1PointRansac.cpp:48-84)."""
    F = active.shape[0]
    cam7 = states_x[:, None, :7]                               # (H, 1, 7)
    feats = states_x[:, CAM_DIM:CAM_DIM + F * FEAT_DIM].reshape(
        -1, F, FEAT_DIM)                                       # (H, F, 6)
    is_xyz = is_xyz[None, :]
    uv = measure_one(camera, cam7, feats, is_xyz)
    p_cam = point_in_camera_frame(cam7, feats, is_xyz)
    vis = (cam_mod.in_front_and_in_fov(camera, p_cam)
           & cam_mod.in_image(camera, uv))
    dist = torch.linalg.vector_norm(z[None] - uv, dim=-1)
    good = matched[None] & active[None] & vis & (dist < threshold)
    return torch.sum(good, dim=1, dtype=torch.int32), good


def support_plain(camera: Camera, x: torch.Tensor, HP: torch.Tensor,
                  S: torch.Tensor, z: torch.Tensor, uv: torch.Tensor,
                  matched: torch.Tensor, active: torch.Tensor,
                  is_xyz: torch.Tensor, pixel_error: float,
                  threshold: float, deadband: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(support (F,) int32, good (F, F) bool) by the plain chain."""
    states_x = hypotheses_plain(x, HP, S, z, uv, matched, pixel_error,
                                deadband)
    return count_plain(states_x, camera, z, matched, active, is_xyz,
                       threshold)


def knife_edges(camera: Camera, x: torch.Tensor, HP: torch.Tensor,
                S: torch.Tensor, z: torch.Tensor, uv: torch.Tensor,
                matched: torch.Tensor, active: torch.Tensor,
                is_xyz: torch.Tensor, pixel_error: float, threshold: float,
                deadband: bool = False, margin: float = 1e-4
                ) -> torch.Tensor:
    """(F, F) bool: the plain chain's decisions within ``margin`` px of a
    threshold (the distance's, or an image border's), which another
    rounding of the same float32 arithmetic may take the other way: what a
    comparison of the kernel with the plain version leaves out."""
    F = active.shape[0]
    states_x = hypotheses_plain(x, HP, S, z, uv, matched, pixel_error,
                                deadband)
    uvh = measure_one(camera, states_x[:, None, :7],
                      states_x[:, CAM_DIM:CAM_DIM + F * FEAT_DIM].reshape(
                          -1, F, FEAT_DIM), is_xyz[None])
    dist = torch.linalg.vector_norm(z[None] - uvh, dim=-1)
    border = torch.stack([uvh[..., 0], camera.pixels_x - uvh[..., 0],
                          uvh[..., 1], camera.pixels_y - uvh[..., 1]])
    return (((dist - threshold).abs() < margin)
            | (border.abs().amin(0) < margin))


def support_cuda(camera: Camera | cuda_lib.CamParams, x: torch.Tensor,
                 HP: torch.Tensor, S: torch.Tensor, z: torch.Tensor,
                 uv: torch.Tensor, matched: torch.Tensor,
                 active: torch.Tensor, is_xyz: torch.Tensor,
                 pixel_error: float, threshold: float,
                 deadband: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same two outputs from one launch of the CUDA kernel (its
    DEADBAND instantiation with ``deadband``); B streams stacked (a
    leading B axis on every input and output) in the same one launch."""
    tensors = {"x": x, "HP": HP, "S": S, "z": z, "uv": uv,
               "matched": matched, "active": active, "is_xyz": is_xyz}
    tensors = {k: t.contiguous() for k, t in tensors.items()}
    cuda_lib.check_cuda_inputs("ransac_support", tensors)
    x, HP, S = tensors["x"], tensors["HP"], tensors["S"]
    lead = tuple(x.shape[:-1])
    N, F = x.shape[-1], active.shape[-1]
    if F < 1 or len(lead) > 1 or N < CAM_DIM + FEAT_DIM * F \
            or HP.shape != lead + (2 * F, N) or S.shape != lead + (F, 2, 2) \
            or any(tensors[k].shape != lead + (F, 2) for k in ("z", "uv")) \
            or any(tensors[k].shape != lead + (F,)
                   for k in ("matched", "active", "is_xyz")):
        raise ValueError("ransac_support: bad shapes")
    support = torch.empty(lead + (F,), dtype=torch.int32, device=x.device)
    good = torch.empty(lead + (F, F), dtype=torch.bool, device=x.device)
    cam = (camera if isinstance(camera, cuda_lib.CamParams)
           else cuda_lib.CamParams.from_camera(camera))
    cuda_lib.library().call(
        "ekf_ransac_support_batched", x.data_ptr(), HP.data_ptr(),
        S.data_ptr(), tensors["z"].data_ptr(), tensors["uv"].data_ptr(),
        tensors["matched"].data_ptr(), tensors["active"].data_ptr(),
        tensors["is_xyz"].data_ptr(), support.data_ptr(), good.data_ptr(),
        F, N, lead[0] if lead else 1, float(pixel_error) - 1.0,
        float(threshold), int(deadband), ctypes.byref(cam),
        cuda_lib.stream_of(x))
    LAUNCHES.hit()
    return support, good


@functools.cache
def _batched_op():
    def support_op(cam: list[float], x: torch.Tensor, HP: torch.Tensor,
                   S: torch.Tensor, z: torch.Tensor, uv: torch.Tensor,
                   matched: torch.Tensor, active: torch.Tensor,
                   is_xyz: torch.Tensor, pixel_error: float,
                   threshold: float, deadband: bool
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        return support_cuda(cuda_lib.CamParams(*cam), x, HP, S, z, uv,
                            matched, active, is_xyz, pixel_error, threshold,
                            deadband)

    def rule(info, in_dims, cam, x, HP, S, z, uv, matched, active, is_xyz,
             pixel_error, threshold, deadband):
        args = batched.stacked(info.batch_size, in_dims[1:9], x, HP, S, z,
                               uv, matched, active, is_xyz)
        return (support_cuda(cuda_lib.CamParams(*cam), *args, pixel_error,
                             threshold, deadband), (0, 0))

    return batched.custom_op("ransac_support", support_op, rule)


def support(camera: Camera, x: torch.Tensor, HP: torch.Tensor,
            S: torch.Tensor, z: torch.Tensor, uv: torch.Tensor,
            matched: torch.Tensor, active: torch.Tensor,
            is_xyz: torch.Tensor, pixel_error: float, threshold: float,
            deadband: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """RANSAC's support count: plain version on the CPU, the kernel on
    CUDA (one launch for all streams under ``torch.func.vmap``)."""
    args = (x, HP, S, z, uv, matched, active, is_xyz)
    if x.device.type == "cpu":
        return support_plain(camera, *args, pixel_error, threshold, deadband)
    if batched.any_batched(*args):
        return _batched_op()(cuda_lib.CamParams.values(camera), *args,
                             float(pixel_error), float(threshold),
                             bool(deadband))
    return support_cuda(camera, *args, pixel_error, threshold, deadband)
