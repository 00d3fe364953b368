"""Quaternion and rotation primitives (port of core/quaternion.py).

Semantics follow the reference's EKFMath (Core/EKFMath.cpp): quaternions are
(w, x, y, z); ``to_rotation_matrix(q)`` is the camera-to-world rotation
R(q) (EKFMath.cpp:118-141); ``from_axis_angle`` is ``anglesToQuaternion``
(EKFMath.cpp:58-78) with the small-angle branch replaced by a series.

Every function takes quaternions on the last axis and batches over any
leading axes.
"""

from __future__ import annotations

import torch

_SMALL = 1e-8


def from_axis_angle(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) -> unit quaternion (..., 4) (w, x, y, z).

    q = [cos(|v|/2), sin(|v|/2) * v/|v|], with a 2nd-order series for small
    |v| (replaces the EPSILON branch at EKFMath.cpp:62-68).
    """
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < _SMALL ** 2
    n_safe = torch.sqrt(torch.where(small, torch.full_like(n2, _SMALL ** 2),
                                    n2))
    half = 0.5 * n_safe
    sinc_half = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / n_safe)
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    return torch.cat([w, sinc_half * v], dim=-1)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product (EKFMath.cpp:82-98)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, -x, -y, -z), by sign flips on the device (no constant to
    upload)."""
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """R(q) (..., 3, 3): rotates camera-frame vectors into the world frame.

    Matches quaternionToRotationMatrix (EKFMath.cpp:118-141); valid for any
    (not necessarily unit) quaternion, as in the reference.
    """
    w, x, y, z = q.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    return torch.stack([
        torch.stack([w2 + x2 - y2 - z2, 2 * (x * y - w * z),
                     2 * (z * x + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), w2 - x2 + y2 - z2,
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (z * x - w * y), 2 * (y * z + w * x),
                     w2 - x2 - y2 + z2], dim=-1),
    ], dim=-2)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def normalize_jacobian(q: torch.Tensor) -> torch.Tensor:
    """4x4 Jacobian of q -> q/|q| (Update.cpp:45-60)."""
    w, x, y, z = q.unbind(-1)
    n2 = w * w + x * x + y * y + z * z
    a = n2 ** (-1.5)
    j = torch.stack([
        torch.stack([x * x + y * y + z * z, -w * x, -w * y, -w * z], dim=-1),
        torch.stack([-x * w, w * w + y * y + z * z, -x * y, -x * z], dim=-1),
        torch.stack([-y * w, -y * x, w * w + x * x + z * z, -y * z], dim=-1),
        torch.stack([-z * w, -z * x, -z * y, w * w + x * x + y * y], dim=-1),
    ], dim=-2)
    return j * a[..., None, None]


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> (roll, pitch, yaw) (EKFMath.cpp:355-365)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)),
        torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0)),
        torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)),
    ], dim=-1)


def directional_vector(theta: torch.Tensor, phi: torch.Tensor
                       ) -> torch.Tensor:
    """Unit ray (..., 3) from azimuth/elevation (EKFMath.cpp:145-152).

    m(theta, phi) = (cos(phi) sin(theta), -sin(phi), cos(phi) cos(theta)).
    """
    cosphi = torch.cos(phi)
    return torch.stack([
        cosphi * torch.sin(theta),
        -torch.sin(phi),
        cosphi * torch.cos(theta),
    ], dim=-1)
