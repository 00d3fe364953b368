"""3D map + camera debug viewer (the reference's PCL window, offline; port
of viz/viewer3d.py).

Reference: modules/Gui/Draw.h:88-100 declares the debug 3D viewers
(`draw3DMap`, PCL visualization of map points, the camera frustum and
its axes) that the desktop build opens in interactive windows.  Those
are debug-only display paths; here the same information is rendered
headlessly (matplotlib Agg) to PNG so it works on a display-less host
and inside CI:

  * map landmarks as 3D points — XYZ-parametrized features solid,
    inverse-depth features (converted to their point estimate
    anchor + m(theta, phi)/rho) hollow, sized by position uncertainty;
  * the camera as an oriented frustum with RGB = XYZ body axes;
  * the full camera trajectory polyline.

Use `render_map3d` for a single view or `Map3DSink` to emit
map3d_%05d.png alongside the overlay channel (CLI `--viz3d N`).
`snapshot_from_state` gathers what a view needs on the state's device and
reads it back in one copy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _camera_frustum(r: np.ndarray, R: np.ndarray, scale: float
                    ) -> np.ndarray:
    """(5, 3) apex + image-plane corners of a schematic frustum in world."""
    corners = np.array([[-1, -0.75, 2.0], [1, -0.75, 2.0],
                        [1, 0.75, 2.0], [-1, 0.75, 2.0]]) * (scale * 0.5)
    return np.vstack([r, r + corners @ R.T])


def render_map3d(landmarks: np.ndarray, active: np.ndarray,
                 is_xyz: np.ndarray, trajectory: np.ndarray,
                 cam_r: np.ndarray, cam_R: np.ndarray,
                 sigma: Optional[np.ndarray] = None,
                 elev: float = -60.0, azim: float = -90.0,
                 size_px: int = 720) -> np.ndarray:
    """Render one 3D map view; returns an (H, W, 3) uint8 RGB image.

    ``landmarks`` (F, 3) world positions (see
    graph.loop_closure.landmark_world_xyz), ``active``/``is_xyz`` (F,)
    masks, ``trajectory`` (T, 3) camera positions, ``cam_r`` (3,) and
    ``cam_R`` (3, 3) current pose, ``sigma`` optional (F,) position
    1-sigma used to size the points.  The default view looks down the
    world -y axis (the s3 rig's "up"), matching the planar viz.
    """
    # Render on an explicit Agg canvas instead of switching the global
    # pyplot backend: interactive callers keep whatever backend they had.
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    import mpl_toolkits.mplot3d  # noqa: F401  (registers the 3d projection)

    fig = Figure(figsize=(size_px / 100.0, size_px / 100.0), dpi=100)
    FigureCanvasAgg(fig)
    ax = fig.add_subplot(111, projection="3d")

    act = np.asarray(active, bool)
    pts = np.asarray(landmarks, float)[act]
    xyz_m = np.asarray(is_xyz, bool)[act]
    if sigma is not None:
        s = np.clip(np.asarray(sigma, float)[act], 0.0, 1.0)
        sizes = 8.0 + 60.0 * s / (s.max() + 1e-12)
    else:
        sizes = np.full(len(pts), 12.0)
    if pts.size:
        ax.scatter(*pts[xyz_m].T, s=sizes[xyz_m], c="#2a7a2a",
                   depthshade=True, label="XYZ")
        ax.scatter(*pts[~xyz_m].T, s=sizes[~xyz_m], facecolors="none",
                   edgecolors="#3465a4", depthshade=False,
                   label="inverse-depth")

    traj = np.asarray(trajectory, float).reshape(-1, 3)
    if len(traj) >= 2:
        ax.plot(*traj.T, color="#555555", linewidth=1.0)

    # frustum + body axes at the current camera
    span = max(float(np.ptp(traj[:, 0])) if len(traj) else 0.0, 0.2)
    fr = _camera_frustum(np.asarray(cam_r, float),
                         np.asarray(cam_R, float), 0.15 * span)
    for i in range(1, 5):
        j = 1 + (i % 4)
        ax.plot(*np.vstack([fr[0], fr[i]]).T, color="#a40000", lw=0.8)
        ax.plot(*np.vstack([fr[i], fr[j]]).T, color="#a40000", lw=0.8)
    for axis, color in zip(np.eye(3), ("#cc0000", "#00aa00", "#0000cc")):
        tip = cam_r + cam_R @ (axis * 0.1 * span)
        ax.plot(*np.vstack([cam_r, tip]).T, color=color, lw=1.6)

    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.view_init(elev=elev, azim=azim)
    if pts.size:
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout(pad=0.2)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    return img


def snapshot_from_state(state):
    """Pull (landmarks, active, is_xyz, cam_r, cam_R, sigma) off a
    SlamState: the landmarks' world positions
    (graph.loop_closure.landmark_world_xyz), the features, the slots' 6x6
    covariance blocks, the masks and the camera pose are gathered on the
    state's device and read back in one copy, once per rendered view.

    Marker sizes reflect the full point-estimate uncertainty: for
    inverse-depth slots the 6x6 slot covariance is pushed through the
    Jacobian of p = anchor + m(theta, phi)/rho (so depth/bearing variance
    shows up, not just anchor variance); XYZ slots use their position
    block directly."""
    import torch

    from openekfmonoslam_tpu_torch.core import quaternion
    from openekfmonoslam_tpu_torch.filter.state import CAM_DIM, FEAT_DIM
    from openekfmonoslam_tpu_torch.graph.loop_closure import (
        landmark_world_xyz)

    f = state.n_features
    P = state.P
    dtype, dev = P.dtype, P.device
    rows = (CAM_DIM + FEAT_DIM * torch.arange(f, device=dev)[:, None]
            + torch.arange(FEAT_DIM, device=dev)[None, :])        # (F, 6)
    blocks = P[rows[:, :, None], rows[:, None, :]]              # (F, 6, 6)
    parts = [landmark_world_xyz(state), state.features, blocks,
             state.active, state.is_xyz, state.r,
             quaternion.to_rotation_matrix(state.q)]
    host = torch.cat([p.to(dtype).reshape(-1) for p in parts]).cpu().numpy()
    sizes = [3 * f, FEAT_DIM * f, FEAT_DIM * FEAT_DIM * f, f, f, 3, 9]
    lm, feats, blk, act, is_xyz_np, cam_r, cam_R = np.split(
        host, np.cumsum(sizes)[:-1])
    lm = lm.reshape(f, 3)
    feats = feats.reshape(f, FEAT_DIM)
    blk = blk.reshape(f, FEAT_DIM, FEAT_DIM)
    act, is_xyz_np = act.astype(bool), is_xyz_np.astype(bool)
    theta, phi, rho = feats[:, 3], feats[:, 4], feats[:, 5]
    rho_s = np.where(np.abs(rho) < 1e-12, 1e-12, rho)
    cth, sth = np.cos(theta), np.sin(theta)
    cph, sph = np.cos(phi), np.sin(phi)
    m = np.stack([cph * sth, -sph, cph * cth], -1)                 # (F, 3)
    dm_dth = np.stack([cph * cth, np.zeros(f), -cph * sth], -1)
    dm_dph = np.stack([-sph * sth, -cph, -sph * cth], -1)
    # J (F, 3, 6): [I3 | dm/dtheta / rho | dm/dphi / rho | -m / rho^2]
    J = np.zeros((f, 3, FEAT_DIM))
    J[:, :, :3] = np.eye(3)
    J[:, :, 3] = dm_dth / rho_s[:, None]
    J[:, :, 4] = dm_dph / rho_s[:, None]
    J[:, :, 5] = -m / (rho_s ** 2)[:, None]
    var = np.empty((f, 3))
    for i in range(f):
        if is_xyz_np[i]:
            var[i] = np.diag(blk[i])[:3]
        else:
            var[i] = np.diag(J[i] @ blk[i] @ J[i].T)
    sig = np.sqrt(np.maximum(var, 0.0)).mean(-1)
    return lm, act, is_xyz_np, cam_r, cam_R.reshape(3, 3), sig


class Map3DSink:
    """Writes map3d_%05d.png every ``every`` frames (debug channel)."""

    def __init__(self, output_path: str, every: int = 30):
        self.output_path = output_path
        self.every = max(int(every), 1)
        os.makedirs(output_path, exist_ok=True)

    def maybe_write(self, frame_idx: int, state, trajectory) -> Optional[str]:
        if frame_idx % self.every != 0:
            return None
        return self.write(frame_idx, state, trajectory)

    def write(self, frame_idx: int, state, trajectory) -> str:
        lm, act, is_xyz, r, R, sig = snapshot_from_state(state)
        img = render_map3d(lm, act, is_xyz, np.asarray(trajectory), r, R,
                           sigma=sig)
        path = os.path.join(self.output_path, f"map3d_{frame_idx:05d}.png")
        # matplotlib.image.imsave avoids a cv2 dependency and never
        # touches the pyplot backend
        from matplotlib.image import imsave

        imsave(path, img)
        return path
