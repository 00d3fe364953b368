"""Analytic measurement Jacobians, structure-of-arrays (port of
filter/measure_fast.py, correct-math chain only).

  h(x) = distort(project(R(q)^T a)),   a = p - r               (XYZ)
                                       a = rho (p0 - r) + m(theta, phi)
  dh/d(r, q, feat) = IDJ @ FPJ @ [d p_cam/d(...)]
    FPJ = d(project)/d(p_cam), IDJ = d(distort)/d(uv_undist) by implicit
    differentiation of the Newton radius equation.

This is the plain version of the measure kernel (ops/measure_kernel.py),
both of its variants: the correct-math chain and, with ``quirks``, the
reference's bug-compatible chain (the parity mode, ``reference_quirks``).
"""

from __future__ import annotations

import torch

from openekfmonoslam_tpu_torch.core import camera as cam_mod
from openekfmonoslam_tpu_torch.core.camera import Camera, _NEWTON_ITERS


def _rotation_T(q):
    """Rows of R(q)^T as 9 scalars (R as in quat.to_rotation_matrix)."""
    w, x, y, z = q.unbind()
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    r00 = w2 + x2 - y2 - z2
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (z * x + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = w2 - x2 + y2 - z2
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (z * x - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = w2 - x2 - y2 + z2
    return ((r00, r10, r20),
            (r01, r11, r21),
            (r02, r12, r22))


def _camera_frame(cam7, feats, is_xyz):
    """(a, p_cam) per slot: the anchor-relative vector and its rotation
    into the camera frame, as component tuples."""
    r = cam7[0:3]
    Rt = _rotation_T(cam7[3:7])
    theta, phi, rho = feats[:, 3], feats[:, 4], feats[:, 5]
    cph, sph = torch.cos(phi), torch.sin(phi)
    cth, sth = torch.cos(theta), torch.sin(theta)
    ox, oy, oz = feats[:, 0] - r[0], feats[:, 1] - r[1], feats[:, 2] - r[2]
    ax = torch.where(is_xyz, ox, rho * ox + cph * sth)
    ay = torch.where(is_xyz, oy, rho * oy + (-sph))
    az = torch.where(is_xyz, oz, rho * oz + cph * cth)
    p = tuple(Rt[i][0] * ax + Rt[i][1] * ay + Rt[i][2] * az
              for i in range(3))
    return Rt, (ax, ay, az), (ox, oy, oz), (cph, sph, cth, sth), p


def measurements_with_jacobians(camera: Camera, cam7: torch.Tensor,
                                feats: torch.Tensor, is_xyz: torch.Tensor,
                                quirks: bool = False):
    """(uv (F,2), Hc7 (F,2,7), Hf (F,2,6)) by the analytic chain.

    ``quirks`` switches the H chain to the reference's transcribed bugs
    (eval/oracle.py's OracleQuirks documents each):
      * the jacobian[1]/[2] slip: dh/dr uses -R^T with entry (0, 1)
        zeroed (MeasurementPrediction.cpp:371-394); dh/dq, Hf and the
        value keep the true R^T;
      * the unrotated drho column: Hf[:, 5] carries the world-frame anchor
        offset, not R^T (p0 - r) (:553-580);
      * the one-shot distortion Jacobian: IDJ is the inverse of the
        one-shot undistort Jacobian at the distorted pixel (:308-337), not
        the exact implicit derivative of the Newton inversion.
    The measurement value h(x) is the same in both modes."""
    Rt, (ax, ay, az), (ox, oy, oz), (cph, sph, cth, sth), (px, py, pz) = \
        _camera_frame(cam7, feats, is_xyz)
    rho = feats[:, 5]
    pz = torch.where(torch.abs(pz) < 1e-6, torch.ones_like(pz), pz)

    def rt_mul(vx, vy, vz):
        return (Rt[0][0] * vx + Rt[0][1] * vy + Rt[0][2] * vz,
                Rt[1][0] * vx + Rt[1][1] * vy + Rt[1][2] * vz,
                Rt[2][0] * vx + Rt[2][1] * vy + Rt[2][2] * vz)

    # ---- projection + distortion (value), as cam_mod.project/distort
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    k1, k2, dx_, dy_ = camera.k1, camera.k2, camera.dx, camera.dy
    inv_z = 1.0 / pz
    uu = cx + fx * px * inv_z
    vu = cy + fy * py * inv_z
    du = uu - cx
    dv = vu - cy
    mx = dx_ * du
    my = dy_ * dv
    r2 = torch.clamp(mx * mx + my * my, min=1e-12)
    ru = torch.sqrt(r2)
    rd = ru / (1.0 + k1 * r2 + k2 * r2 * r2)
    for _ in range(_NEWTON_ITERS):
        rd2 = rd * rd
        fv = rd + k1 * rd2 * rd + k2 * rd2 * rd2 * rd - ru
        fp = 1.0 + 3.0 * k1 * rd2 + 5.0 * k2 * rd2 * rd2
        rd = rd - fv / fp
    # final implicit step: gp = g'(rd) at the pre-step radius is what the
    # derivative uses, the value takes the post-step radius
    rd_s = rd
    rd2s = rd_s * rd_s
    fv = rd_s + k1 * rd2s * rd_s + k2 * rd2s * rd2s * rd_s - ru
    gp = 1.0 + 3.0 * k1 * rd2s + 5.0 * k2 * rd2s * rd2s
    rd = rd_s - fv / gp
    rd2 = rd * rd
    d = 1.0 + k1 * rd2 + k2 * rd2 * rd2
    ud = cx + du / d
    vd = cy + dv / d
    uv = torch.stack([ud, vd], dim=-1)

    if quirks:
        # ---- IDJ = inverse of the one-shot undistort Jacobian at the
        # distorted pixel (makeJacobianOfDistortionFunction, inverted by
        # makeJacobianOfProjection :343-362)
        pdx = ud - cx
        pdy = vd - cy
        mxq = dx_ * pdx
        myq = dy_ * pdy
        r2q = mxq * mxq + myq * myq
        radq = 1.0 + k1 * r2q + k2 * r2q * r2q
        gq = k1 + 2.0 * k2 * r2q
        u00 = radq + pdx * gq * 2.0 * pdx * dx_ * dx_
        u01 = pdx * gq * 2.0 * pdy * dy_ * dy_
        u10 = pdy * gq * 2.0 * pdx * dx_ * dx_
        u11 = radq + pdy * gq * 2.0 * pdy * dy_ * dy_
        detq = u00 * u11 - u01 * u10
        i00 = u11 / detq
        i01 = -u01 / detq
        i10 = -u10 / detq
        i11 = u00 / detq
    else:
        # ---- IDJ = d(distort)/d(uv_undist) (implicit function theorem)
        dd_drd = 2.0 * k1 * rd + 4.0 * k2 * rd * rd2
        cmul = dd_drd / (gp * ru)
        inv_d = 1.0 / d
        inv_d2 = inv_d * inv_d
        i00 = inv_d - du * cmul * dx_ * dx_ * du * inv_d2
        i01 = -du * cmul * dy_ * dy_ * dv * inv_d2
        i10 = -dv * cmul * dx_ * dx_ * du * inv_d2
        i11 = inv_d - dv * cmul * dy_ * dy_ * dv * inv_d2

    # ---- FPJ = d(project)/d(p_cam); proj = IDJ @ FPJ (2x3)
    f00 = fx * inv_z
    f02 = -px * fx * inv_z * inv_z
    f11 = fy * inv_z
    f12 = -py * fy * inv_z * inv_z
    p00 = i00 * f00
    p01 = i01 * f11
    p02 = i00 * f02 + i01 * f12
    p10 = i10 * f00
    p11 = i11 * f11
    p12 = i10 * f02 + i11 * f12

    def proj_mul(vx, vy, vz):
        return (p00 * vx + p01 * vy + p02 * vz,
                p10 * vx + p11 * vy + p12 * vz)

    # ---- dh/dr = -s proj @ Rt, s = XYZ ? 1 : rho
    s = torch.where(is_xyz, torch.ones_like(rho), rho)
    pR = [proj_mul(Rt[0][j], Rt[1][j], Rt[2][j]) for j in range(3)]
    # the slip: entry (0, 1) of dh/dr's R^T is never written (0)
    pRd = ([pR[0], proj_mul(0.0, Rt[1][1], Rt[2][1]), pR[2]] if quirks
           else pR)
    dh_dr = [[-s * pRd[j][i] for j in range(3)] for i in range(2)]

    # ---- dh/dq through the conjugate quaternion
    w, qx, qy, qz = cam7[3], -cam7[4], -cam7[5], -cam7[6]
    c0 = (2 * (w * ax - qz * ay + qy * az),
          2 * (qz * ax + w * ay - qx * az),
          2 * (-qy * ax + qx * ay + w * az))
    c1 = (2 * (qx * ax + qy * ay + qz * az),
          2 * (qy * ax - qx * ay - w * az),
          2 * (qz * ax + w * ay - qx * az))
    c2 = (2 * (-qy * ax + qx * ay + w * az),
          2 * (qx * ax + qy * ay + qz * az),
          2 * (-w * ax + qz * ay - qy * az))
    c3 = (2 * (-qz * ax - w * ay + qx * az),
          2 * (w * ax - qz * ay + qy * az),
          2 * (qx * ax + qy * ay + qz * az))
    sgn = (1.0, -1.0, -1.0, -1.0)
    dh_dq = [[], []]
    for k, ck in enumerate((c0, c1, c2, c3)):
        rows = proj_mul(*ck)
        dh_dq[0].append(sgn[k] * rows[0])
        dh_dq[1].append(sgn[k] * rows[1])

    # ---- Hf: [rho proj Rt | proj Rt dm/dtheta | proj Rt dm/dphi |
    #           proj Rt (p0 - r)], XYZ slots keep proj Rt only
    inv = 1.0 - is_xyz.to(feats.dtype)
    zero = torch.zeros_like(cph)
    pR_dmth = proj_mul(*rt_mul(cph * cth, zero, -cph * sth))
    pR_dmph = proj_mul(*rt_mul(-sph * sth, -cph, -sph * cth))
    # the unrotated drho column: the world-frame offset (p0 - r)
    pR_off = (proj_mul(ox, oy, oz) if quirks
              else proj_mul(*rt_mul(ox, oy, oz)))
    hf = [[torch.where(is_xyz, pR[j][i], rho * pR[j][i]) for j in range(3)]
          + [inv * pR_dmth[i], inv * pR_dmph[i], inv * pR_off[i]]
          for i in range(2)]

    Hc7 = torch.stack([torch.stack(dh_dr[i] + dh_dq[i], dim=-1)
                       for i in range(2)], dim=1)
    Hf = torch.stack([torch.stack(hf[i], dim=-1) for i in range(2)], dim=1)
    return uv, Hc7, Hf


def visibility(camera: Camera, cam7: torch.Tensor, feats: torch.Tensor,
               is_xyz: torch.Tensor, active: torch.Tensor, uv: torch.Tensor
               ) -> torch.Tensor:
    """Active, in front and inside the FOV (unclamped p_cam), and inside
    the image."""
    p_cam = torch.stack(_camera_frame(cam7, feats, is_xyz)[4], dim=-1)
    return (active
            & cam_mod.in_front_and_in_fov(camera, p_cam)
            & cam_mod.in_image(camera, uv))
