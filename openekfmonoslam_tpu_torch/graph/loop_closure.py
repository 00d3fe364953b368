"""Automatic loop closure: keyframe place recognition, PnP and a graph edge
(port of graph/loop_closure.py).

The reference has no loop closure, and unseen landmarks are culled
(EKF.cpp:582-586), so revisiting a place gives no constraint.  On top of
graph/pose_graph.py:

  * every keyframe snapshot keeps the live landmarks' descriptors and
    world positions, frozen at snapshot time (on the device);
  * a new keyframe's frame descriptors are matched (gate-free 2-NN with
    the ratio test of Matching.cpp:116-177) against every stored keyframe
    older than a gap;
  * with enough 2D-3D correspondences, the camera pose is solved against
    the old keyframe's frozen landmarks by a masked Gauss-Newton PnP
    through the exact measurement model (projection and Newton
    re-distortion), started at the old keyframe's pose;
  * an accepted solve (reprojection RMS under a threshold) becomes a loop
    edge: the relative pose between the stored keyframe pose and the PnP
    pose is drift-free, since both live in the old keyframe's world frame.

A keyframe attempt reads back twice: the candidates' match counts, in one
copy, and the PnP's (rms, used); frames that take no keyframe read
nothing.  An accepted closure's dr, dq and information stay on the
device (float64).  On the s3 profile the signature runs the STAR and BRIEF
kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core import quaternion as quat
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter.state import SlamState
from openekfmonoslam_tpu_torch.graph.pose_graph import relative_pose
from openekfmonoslam_tpu_torch.vision import fast

_BIG_DISTANCE = 1e30


def landmark_world_xyz(state: SlamState) -> torch.Tensor:
    """(F, 3) world positions of all slots (inverse-depth ones through
    anchor + m / rho, changeInverseDepthToDepth,
    CommonFunctions.cpp:149-159)."""
    feats = state.features
    m = quat.directional_vector(feats[:, 3], feats[:, 4])
    rho = feats[:, 5]
    rho_safe = torch.where(torch.abs(rho) < 1e-12,
                           torch.full_like(rho, 1e-12), rho)
    inv = feats[:, 0:3] + m / rho_safe[:, None]
    return torch.where(state.is_xyz[:, None], feats[:, 0:3], inv)


class Keyframe(NamedTuple):
    """A snapshot taken every keyframe interval; tensors on the state's
    device."""

    node_index: int          # index in the pose graph
    frame_index: int         # engine frame number
    r: torch.Tensor          # (3,) float64 pose at snapshot
    q: torch.Tensor          # (4,) float64
    lm_xyz: torch.Tensor     # (F, 3) frozen landmark world positions
    lm_desc: torch.Tensor    # (F, W) landmark descriptors
    lm_valid: torch.Tensor   # (F,) bool


def match_2d3d(kf_desc: torch.Tensor, kf_valid: torch.Tensor,
               kp_desc: torch.Tensor, kp_valid: torch.Tensor,
               distance_fn, ratio: float = 0.8,
               max_distance: float = 60.0):
    """Gate-free 2-NN descriptor matching of stored landmarks against the
    current keypoints.  Returns (matched (F,), kp_index (F,)).

    The 2-NN ratio test follows Matching.cpp:116-177; ``max_distance``
    also rejects weak absolute matches (no ellipse gate prunes impostors
    here).  Ties go to the lower keypoint index, as ``lax.top_k`` breaks
    them."""
    dist = distance_fn(kf_desc, kp_desc).to(torch.float32)       # (F, K)
    big = torch.full((), _BIG_DISTANCE, dtype=torch.float32,
                     device=dist.device)
    dist = torch.where(kp_valid[None, :], dist, big)
    d1 = torch.amin(dist, dim=1)
    idx = torch.argmin(dist, dim=1)
    k_iota = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.amin(torch.where(k_iota[None, :] == idx[:, None], big, dist),
                    dim=1)
    matched = kf_valid & (d1 <= max_distance) & (d1 <= d2 * ratio)
    return matched, idx


def _rotate_small(q: torch.Tensor, dth: torch.Tensor) -> torch.Tensor:
    """q composed on the right with the small rotation dth, normalised."""
    dq = torch.cat([torch.ones_like(dth[0:1]), 0.5 * dth])
    q2 = quat.multiply(q, dq)
    return q2 / torch.linalg.vector_norm(q2)


def _skew(p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) [p]x, the cross product p x . as a matrix."""
    zero = torch.zeros_like(p[..., 0])
    x, y, z = p.unbind(-1)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _reproject(camera: Camera, xyz: torch.Tensor, r: torch.Tensor,
               q: torch.Tensor, jacobian: bool = False):
    """The (M, 2) distorted pixels of ``xyz`` from the pose (r, q), and with
    ``jacobian`` their (M, 2, 6) derivative by the local perturbation
    (dr in the world frame, dtheta on the right), at zero.  The JAX
    package takes that derivative by ``jax.jacfwd``; here it is written
    out (one chain of a few dozen operations, not a forward pass per
    direction): dp/d(dr) = -R^T, dp/d(dtheta) = [p]x for p = R^T (X - r),
    then the projection and ``camera.distort_jacobian``."""
    R = quat.to_rotation_matrix(q)
    p = (xyz - r) @ R                                     # R^T (X - r)
    z = p[:, 2]
    small = torch.abs(z) < 1e-6
    z_safe = torch.where(small, torch.ones_like(z), z)
    uv_u = cam_mod.project(camera, torch.cat([p[:, 0:2], z_safe[:, None]],
                                             dim=1))
    uv = cam_mod.distort(camera, uv_u)
    if not jacobian:
        return uv
    zero = torch.zeros_like(z)
    dz = torch.where(small, zero, 1.0 / (z_safe * z_safe))
    jp = torch.stack([
        torch.stack([camera.fx / z_safe, zero, -camera.fx * p[:, 0] * dz],
                    -1),
        torch.stack([zero, camera.fy / z_safe, -camera.fy * p[:, 1] * dz],
                    -1)], -2)                             # (M, 2, 3)
    dp = torch.cat([-R.T.expand(p.shape[0], 3, 3), _skew(p)], dim=-1)
    return uv, cam_mod.distort_jacobian(camera, uv_u) @ jp @ dp


def pnp_gauss_newton(camera: Camera, xyz: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, r0: torch.Tensor, q0: torch.Tensor,
                     iterations: int = 15, damping: float = 1e-6,
                     trim_px: float = 3.0):
    """Masked Gauss-Newton PnP: the camera pose from 2D-3D matches through
    the exact projection and re-distortion.  Returns (r, q, rms_px,
    n_used, H), all tensors on ``xyz``'s device.

    Gate-free matching admits impostors: after a first solve over all
    matches, those whose reprojection error exceeds ``trim_px`` are
    dropped and the pose is solved again on the survivors; rms, n_used and
    H describe the trimmed set."""
    dtype = xyz.dtype
    uv = uv.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=xyz.device)

    def linearise(w, r, q):
        """The weighted residual (2M,) and its Jacobian (2M, 6) at zero
        perturbation (the pose's quaternion normalised, as the JAX
        residual does)."""
        qn = q / torch.linalg.vector_norm(q)
        pix, J = _reproject(camera, xyz, r, qn, jacobian=True)
        return (((pix - uv) * w[:, None]).reshape(-1),
                (J * w[:, None, None]).reshape(-1, 6))

    def solve(w, r, q):
        for _ in range(iterations):
            res, J = linearise(w, r, q)
            H = J.T @ J + damping * eye6
            delta = -torch.linalg.solve_ex(H, J.T @ res)[0]
            r, q = r + delta[0:3], _rotate_small(q, delta[3:6])
        return r, q

    r, q = solve(valid.to(dtype), r0.to(dtype), q0.to(dtype))
    # trim: drop correspondences whose first-pass reprojection error
    # exceeds trim_px, then solve again on the survivors
    err = torch.linalg.vector_norm(_reproject(camera, xyz, r, q) - uv,
                                   dim=-1)
    inlier = valid & (err <= trim_px)
    w = inlier.to(dtype)
    n_used = torch.sum(inlier, dtype=torch.int32)
    r, q = solve(w, r, q)

    res = (_reproject(camera, xyz, r, q) - uv) * w[:, None]
    rms = torch.sqrt(torch.sum(res * res)
                     / torch.clamp(2.0 * n_used.to(dtype), min=1.0))
    # pose information at the solution (unit pixel noise): J^T J over the
    # local (dr, dtheta) parametrisation, the loop edge's weight
    J = linearise(w, r, q)[1]
    return r, q, rms, n_used, J.T @ J


class LoopCloser:
    """Stores keyframe snapshots and, when a new keyframe arrives, looks
    for a loop closure against the older ones."""

    def __init__(self, runtime, min_gap: int = 5, min_matches: int = 10,
                 max_rms_px: float = 2.0, ratio: float = 0.8,
                 max_distance: float = 60.0):
        self.runtime = runtime
        self.min_gap = min_gap
        self.min_matches = min_matches
        self.max_rms_px = max_rms_px
        self.ratio = ratio
        self.max_distance = max_distance
        self.keyframes: list[Keyframe] = []
        self.closures: list[dict] = []

    def _signature(self, gray: torch.Tensor):
        """The frame's (kp_xy, desc, valid): the configured detector and
        descriptor over the whole (border-masked) frame."""
        rt = self.runtime
        aux = rt.frontend.precompute(gray)
        kps = fast.detect_keypoints(aux["score_nms"],
                                    rt._border_mask(gray.shape),
                                    rt.config.max_keypoints)
        desc = rt.frontend.describe(aux, kps.yx)
        kp_xy = torch.stack([kps.yx[:, 1], kps.yx[:, 0]],
                            dim=-1).to(rt.dtype)
        return kp_xy, desc, kps.valid

    def snapshot(self, state: SlamState, node_index: int,
                 frame_index: int) -> Keyframe:
        kf = Keyframe(
            node_index=node_index,
            frame_index=frame_index,
            r=state.x[0:3].to(torch.float64),
            q=state.x[3:7].to(torch.float64),
            lm_xyz=landmark_world_xyz(state),
            lm_desc=state.descriptors,
            lm_valid=state.active & (state.times_matched >= 2),
        )
        self.keyframes.append(kf)
        return kf

    def try_close(self, gray: torch.Tensor, new_kf: Keyframe
                  ) -> Optional[dict]:
        """Match ``new_kf``'s frame against every stored keyframe older
        than ``min_gap``; an accepted loop-closure edge dict, or None."""
        candidates = [kf for kf in self.keyframes
                      if new_kf.node_index - kf.node_index > self.min_gap]
        if not candidates:
            return None
        rt = self.runtime
        kp_xy, kp_desc, kp_valid = self._signature(gray)
        found = [match_2d3d(kf.lm_desc, kf.lm_valid, kp_desc, kp_valid,
                            rt.frontend.distance, self.ratio,
                            self.max_distance) for kf in candidates]
        counts = torch.stack([torch.sum(m, dtype=torch.int32)
                              for m, _ in found]).tolist()
        best = None
        for n, kf, (matched, kp_idx) in zip(counts, candidates, found):
            if n >= self.min_matches and (best is None or n > best[0]):
                best = (n, kf, matched, kp_idx)
        if best is None:
            return None

        n, kf, matched, kp_idx = best
        r, q, rms, n_used, H = pnp_gauss_newton(
            rt.camera, kf.lm_xyz.to(rt.dtype), kp_xy[kp_idx], matched,
            kf.r.to(rt.dtype), kf.q.to(rt.dtype))
        rms, n_used = torch.stack([rms.to(torch.float64),
                                   n_used.to(torch.float64)]).tolist()
        if rms > self.max_rms_px or int(n_used) < self.min_matches:
            return None
        # drift-free relative pose: kf.(r, q) and the PnP pose both live in
        # the old keyframe's world frame (its frozen landmarks define it)
        dr, dq = relative_pose(kf.r, kf.q, r.to(torch.float64),
                               q.to(torch.float64))
        closure = {
            "i": kf.node_index, "j": new_kf.node_index,
            "dr": dr, "dq": dq, "info": H.to(torch.float64),
            "matches": n, "rms_px": rms,
            "frame_i": kf.frame_index, "frame_j": new_kf.frame_index,
        }
        self.closures.append(closure)
        return closure


def correct_trajectory(records_r: np.ndarray, records_q: np.ndarray,
                       kf_frames: list, raw_kf_r: np.ndarray,
                       raw_kf_q: np.ndarray, opt_kf_r: np.ndarray,
                       opt_kf_q: np.ndarray) -> np.ndarray:
    """The per-keyframe graph corrections applied to the whole per-frame
    trajectory: each frame takes the SE(3) correction of the nearest
    preceding keyframe, T_corr = T_opt T_raw^-1 (a world-frame left
    multiplication).  Host numpy, float64."""
    out = np.asarray(records_r, np.float64).copy()
    if not kf_frames:
        return out
    kf_frames = np.asarray(kf_frames)

    def rot(q):
        return quat.to_rotation_matrix(
            torch.as_tensor(np.asarray(q, np.float64))).numpy()

    for t in range(out.shape[0]):
        k = int(np.searchsorted(kf_frames, t + 1, side="right")) - 1
        if k < 0:
            continue
        R_corr = rot(opt_kf_q[k]) @ rot(raw_kf_q[k]).T
        t_corr = opt_kf_r[k] - R_corr @ raw_kf_r[k]
        out[t] = R_corr @ out[t] + t_corr
    return out
