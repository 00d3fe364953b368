"""Pinhole camera with 2-term radial distortion (port of core/camera.py).

The distortion model matches the reference (the Civera MATLAB convention):
the radial polynomial operates on *metric* sensor coordinates, obtained by
scaling pixel offsets from the principal point by the pixel pitch (dx, dy).

  * ``distort``  : undistorted pixel -> distorted pixel, by inverting
    r_u = r_d (1 + k1 r_d^2 + k2 r_d^4) with 10 Newton iterations plus the
    final step the JAX version differentiates through
    (distortPoint_matlab, MeasurementPrediction.cpp:47-83);
  * ``undistort``: distorted pixel -> undistorted pixel, by the one-shot
    forward polynomial (undistortPoint, AddMapFeature.cpp:42-58).

Calibration constants are Python floats, so every function computes in
the dtype of the tensor it is given.  All functions batch over leading
axes (pixels on the last axis = 2, points on the last axis = 3).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.config import CameraCalibration

_NEWTON_ITERS = 10


class Camera(NamedTuple):
    """Calibration constants as Python scalars."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    dx: float
    dy: float
    pixels_x: int
    pixels_y: int
    pixel_error_x: float
    pixel_error_y: float
    tan_vision_x: float   # tan(angular_vision) FOV gates
    tan_vision_y: float

    @classmethod
    def from_calibration(cls, calib: CameraCalibration) -> "Camera":
        return cls(
            fx=float(calib.fx), fy=float(calib.fy), cx=float(calib.cx),
            cy=float(calib.cy), k1=float(calib.k1), k2=float(calib.k2),
            dx=float(calib.dx), dy=float(calib.dy),
            pixels_x=int(calib.pixels_x), pixels_y=int(calib.pixels_y),
            pixel_error_x=float(calib.pixel_error_x),
            pixel_error_y=float(calib.pixel_error_y),
            tan_vision_x=math.tan(math.radians(calib.angular_vision_x)),
            tan_vision_y=math.tan(math.radians(calib.angular_vision_y)),
        )


def project(cam: Camera, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D point -> undistorted pixel (MeasurementPrediction.cpp:110-120)."""
    return torch.stack([
        cam.cx + cam.fx * p_cam[..., 0] / p_cam[..., 2],
        cam.cy + cam.fy * p_cam[..., 1] / p_cam[..., 2],
    ], dim=-1)


def back_project(cam: Camera, uv_undist: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel -> unit-depth camera ray (AddMapFeature.cpp:313-315)."""
    return torch.stack([
        (uv_undist[..., 0] - cam.cx) / cam.fx,
        (uv_undist[..., 1] - cam.cy) / cam.fy,
        torch.ones_like(uv_undist[..., 0]),
    ], dim=-1)


def _metric_r2(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    mx = cam.dx * (uv[..., 0] - cam.cx)
    my = cam.dy * (uv[..., 1] - cam.cy)
    return mx * mx + my * my


def _newton_step(cam: Camera, rd: torch.Tensor, ru: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Newton step on r_d + k1 r_d^3 + k2 r_d^5 = r_u: (the new r_d,
    the derivative g'(r_d) it divided by)."""
    rd2 = rd * rd
    f = rd + cam.k1 * rd2 * rd + cam.k2 * rd2 * rd2 * rd - ru
    fp = 1.0 + 3.0 * cam.k1 * rd2 + 5.0 * cam.k2 * rd2 * rd2
    return rd - f / fp, fp


def _newton_radius(cam: Camera, r2: torch.Tensor, steps: int
                   ) -> torch.Tensor:
    """The metric distorted radius of r_u = sqrt(r2) after ``steps`` Newton
    steps from r_u / (1 + k1 r2 + k2 r2^2)."""
    ru = torch.sqrt(r2)
    rd = ru / (1.0 + cam.k1 * r2 + cam.k2 * r2 * r2)
    for _ in range(steps):
        rd = _newton_step(cam, rd, ru)[0]
    return rd


def distort(cam: Camera, uv_undist: torch.Tensor) -> torch.Tensor:
    """Undistorted pixel -> distorted pixel via Newton inversion.

    Solves r_d + k1 r_d^3 + k2 r_d^5 = r_u for the metric distorted radius
    (10 iterations, then the one extra step the JAX version appends for its
    implicit derivative -- kept so the values agree), then divides the pixel
    offset by d = 1 + k1 r_d^2 + k2 r_d^4.
    """
    du = uv_undist[..., 0] - cam.cx
    dv = uv_undist[..., 1] - cam.cy
    # floor r^2 at the principal point exactly as the JAX version
    r2 = torch.clamp(_metric_r2(cam, uv_undist), min=1e-12)
    rd = _newton_radius(cam, r2, _NEWTON_ITERS + 1)
    rd2 = rd * rd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    return torch.stack([cam.cx + du / d, cam.cy + dv / d], dim=-1)


def distort_jacobian(cam: Camera, uv_undist: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) d distort / d uv_undist: the derivative that
    ``jax.jacfwd`` takes through the JAX version, d(rd)/d(ru) = 1/g'(rd) at
    the converged root (the implicit step) and nothing through the r^2
    floor at the principal point."""
    du = uv_undist[..., 0] - cam.cx
    dv = uv_undist[..., 1] - cam.cy
    r2_raw = _metric_r2(cam, uv_undist)
    r2 = torch.clamp(r2_raw, min=1e-12)
    ru = torch.sqrt(r2)
    rd, fp = _newton_step(cam, _newton_radius(cam, r2, _NEWTON_ITERS), ru)
    rd2 = rd * rd
    d = 1.0 + cam.k1 * rd2 + cam.k2 * rd2 * rd2
    # dd/d(du) = dd/drd * drd/dru * dru/dr2 * dr2/d(du)
    a = torch.where(r2_raw > 1e-12,
                    (2.0 * cam.k1 * rd + 4.0 * cam.k2 * rd2 * rd)
                    / (fp * ru), torch.zeros_like(ru))
    dd_du = a * (cam.dx * cam.dx) * du
    dd_dv = a * (cam.dy * cam.dy) * dv
    inv_d = 1.0 / d
    inv_d2 = inv_d * inv_d
    return torch.stack([
        torch.stack([inv_d - du * inv_d2 * dd_du, -du * inv_d2 * dd_dv],
                    dim=-1),
        torch.stack([-dv * inv_d2 * dd_du, inv_d - dv * inv_d2 * dd_dv],
                    dim=-1)], dim=-2)


def undistort(cam: Camera, uv_dist: torch.Tensor) -> torch.Tensor:
    """Distorted pixel -> undistorted pixel (one-shot polynomial,
    undistortPoint, AddMapFeature.cpp:42-58)."""
    du = uv_dist[..., 0] - cam.cx
    dv = uv_dist[..., 1] - cam.cy
    r2 = _metric_r2(cam, uv_dist)
    d = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    return torch.stack([cam.cx + du * d, cam.cy + dv * d], dim=-1)


def in_front_and_in_fov(cam: Camera, p_cam: torch.Tensor) -> torch.Tensor:
    """Angular FOV gate (isInFrontOfCamera, MeasurementPrediction.cpp:162-171):
    z > 0 and |x| < z tan(fov_x), |y| < z tan(fov_y)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    return ((z > 0)
            & (torch.abs(x) < z * cam.tan_vision_x)
            & (torch.abs(y) < z * cam.tan_vision_y))


def in_image(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Image-bounds gate (isVisibleInImageFrame, MeasurementPrediction.cpp:176-181)."""
    return ((uv[..., 0] > 0) & (uv[..., 0] < cam.pixels_x)
            & (uv[..., 1] > 0) & (uv[..., 1] < cam.pixels_y))
