"""Reference-parity oracle: a bug-compatible float64 NumPy EKF (the port's
own copy of openekfmonoslam_tpu/eval/oracle.py: the same NumPy code over
the port's ``config``, so it runs where the JAX package cannot be
imported, such as on the GPU machine).

The reference binary (OpenCV 2.4-era C++) cannot be built in this
environment, so measured ATE parity is established against this oracle: a
plain-NumPy, dynamically-shaped reimplementation of the reference's filter
math that reproduces its documented quirks *by flag*:

  * ``jacobian_slip``  -- makeJacobianOfChangeToCameraAxisRightPart writes
    jacobian[2] twice and jacobian[1] never (MeasurementPrediction.cpp:
    371-373; repeated in the rho-scaled variant :392-394), so dh/dr uses
    -R^T with entry (0,1) zeroed.
  * ``rho_unrotated``  -- makeJacobianOfMeasurementByFeatureiInverseDepth
    computes the rotated anchor offset into ``rotationByPointInCameraAxis``
    but never uses it: the dh/drho column carries the *world-frame* offset
    (y - r) instead of R^T (y - r) (MeasurementPrediction.cpp:553-580).
  * ``deadband``       -- stateUpdate zeroes residual components and skips
    state increments with magnitude <= DELTA = 1e-12 (Update.cpp:133-203).
  * ``adaptive_visit`` -- the sequential 1-point RANSAC loop with the
    shrinking hypothesis bound log(1-p)/log(e) (1PointRansac.cpp:125-186);
    off = evaluate every hypothesis, argmax support (the engine's default).
  * ``hypothesis_order`` -- "insertion" visits hypotheses in mapFeatures
    (addition) order like the reference; "slot" visits in the engine's slot order
    for bit-comparable runs against SlamRuntime.step_injected.

Everything else is the reference algorithm as specified: dt = 1 predict
(StateAndCovariancePrediction.cpp:244-252) including the |w| < EPSILON
branch (:172-185), 10-iteration Newton re-distortion (:47-83), per-feature
S_i with identity R (:647-653) vs joint-update R = pixelError * I
(Update.cpp:95-109, explicit S.inv()), (I - KH) P, symmetrize + quaternion
renormalization with the norm Jacobian (Update.cpp:282-318), chi-square
outlier rescue (EKF.cpp:68-119), counter/ratio culling, at-most-one
inverse-depth -> XYZ conversion per frame with covariance-row deletion and
re-basing (MapManagement.cpp:279-523), and sequential feature addition with
the 6x7 / 6x3 init Jacobians (AddMapFeature.cpp:109-367).

Driven through :meth:`ReferenceOracle.step_injected` with an injection log
recorded from a live run (per-slot measurements + new-feature pixels and
slot ids), it produces the trajectory the reference implementation would,
which tests/test_torch_parity.py and chip_smoke.py diff against the port's
parity mode.

One deliberate departure: when the reference removes a feature twice in
one frame (a bad-ratio feature that is also in the stale unseen list it
collected before the updates) it indexes freed memory (EKF.cpp:572-586 +
MapManagement.cpp:212-259 use-after-free); the oracle removes it once.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from openekfmonoslam_tpu_torch.config import SlamConfig

EPSILON = 2.22e-16
DELTA = 1.0e-12
_RAD_TO_DEG = 180.0 / 3.14159265  # the reference's PI (EKFMath.h:39)


@dataclass(frozen=True)
class OracleQuirks:
    """Bug-compatibility flags (SURVEY.md section 7.3 item 2)."""

    jacobian_slip: bool = True
    rho_unrotated: bool = True
    deadband: bool = True
    adaptive_visit: bool = True
    hypothesis_order: str = "insertion"   # or "slot"
    # The reference chains the projection Jacobian through the *inverse of
    # the one-shot undistort Jacobian* (makeJacobianOfProjection,
    # MeasurementPrediction.cpp:343-362) even though h() itself distorts
    # with the Newton inversion -- the one-shot map is not the exact
    # inverse, so H is off by O((k1 r^2)^2) relative.  False = the exact
    # implicit derivative of the Newton-inverted distortion (what the
    # engine's correct-math chain computes).
    handchain_distortion_jac: bool = True

    @classmethod
    def none(cls) -> "OracleQuirks":
        """Correct-math mode, ordered like the engine -- for
        cross-implementation equivalence checks against step_injected."""
        return cls(jacobian_slip=False, rho_unrotated=False, deadband=False,
                   adaptive_visit=True, hypothesis_order="slot",
                   handchain_distortion_jac=False)


# ---------------------------------------------------------------------------
# quaternion / camera primitives (EKFMath.cpp formulas, float64 numpy)
# ---------------------------------------------------------------------------


def _quat_from_rotvec(v: np.ndarray) -> np.ndarray:
    n = math.sqrt(float(v @ v))
    if n < EPSILON:
        return np.array([1.0, 0.0, 0.0, 0.0])
    h = n / 2.0
    s = math.sin(h) / n
    return np.array([math.cos(h), s * v[0], s * v[1], s * v[2]])


def _quat_mult(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_to_R(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (z * x + w * y)],
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        [2 * (z * x - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
    ])


def _directional_vector(theta: float, phi: float) -> np.ndarray:
    cp = math.cos(phi)
    return np.array([cp * math.sin(theta), -math.sin(phi),
                     cp * math.cos(theta)])


def _dR_a_dq(q: np.ndarray, a: np.ndarray) -> np.ndarray:
    """d(R(q) a)/dq, 3x4 (makeJacobianOfQuaternionToRotationMatrix,
    CommonFunctions.cpp:87-145)."""
    w, x, y, z = q
    cols = [
        np.array([[2 * w, -2 * z, 2 * y], [2 * z, 2 * w, -2 * x],
                  [-2 * y, 2 * x, 2 * w]]) @ a,
        np.array([[2 * x, 2 * y, 2 * z], [2 * y, -2 * x, -2 * w],
                  [2 * z, 2 * w, -2 * x]]) @ a,
        np.array([[-2 * y, 2 * x, 2 * w], [2 * x, 2 * y, 2 * z],
                  [-2 * w, 2 * z, -2 * y]]) @ a,
        np.array([[-2 * z, -2 * w, 2 * x], [2 * w, -2 * z, 2 * y],
                  [2 * x, 2 * y, 2 * z]]) @ a,
    ]
    return np.stack(cols, axis=1)


def _quat_norm_jacobian(q: np.ndarray) -> Tuple[np.ndarray, float]:
    """(4x4 Jacobian of q/|q|, |q|) (Update.cpp:45-60)."""
    w, x, y, z = q
    n = math.sqrt(w * w + x * x + y * y + z * z)
    a = 1.0 / n ** 3
    J = np.array([
        [x * x + y * y + z * z, -w * x, -w * y, -w * z],
        [-x * w, w * w + y * y + z * z, -x * y, -x * z],
        [-y * w, -y * x, w * w + x * x + z * z, -y * z],
        [-z * w, -z * x, -z * y, w * w + x * x + y * y],
    ]) * a
    return J, n


class _Cam:
    """Calibration scalars + the reference's projection/distortion math."""

    def __init__(self, c):
        self.fx, self.fy, self.cx, self.cy = c.fx, c.fy, c.cx, c.cy
        self.k1, self.k2, self.dx, self.dy = c.k1, c.k2, c.dx, c.dy
        self.px, self.py = c.pixels_x, c.pixels_y
        self.avx, self.avy = c.angular_vision_x, c.angular_vision_y
        self.pixel_error_x = c.pixel_error_x
        self.pixel_error_y = c.pixel_error_y

    def project(self, p: np.ndarray) -> np.ndarray:
        return np.array([self.cx + self.fx * p[0] / p[2],
                         self.cy + self.fy * p[1] / p[2]])

    def distort_newton(self, uv: np.ndarray) -> np.ndarray:
        """distortPoint_matlab (MeasurementPrediction.cpp:47-83)."""
        du, dv = uv[0] - self.cx, uv[1] - self.cy
        mx, my = self.dx * du, self.dy * dv
        r2 = mx * mx + my * my
        ru = math.sqrt(r2)
        rd = ru / (1.0 + self.k1 * r2 + self.k2 * r2 * r2)
        for _ in range(10):
            rd2 = rd * rd
            f = rd + self.k1 * rd2 * rd + self.k2 * rd2 * rd2 * rd - ru
            fp = 1.0 + 3.0 * self.k1 * rd2 + 5.0 * self.k2 * rd2 * rd2
            rd = rd - f / fp
        rd2 = rd * rd
        d = 1.0 + self.k1 * rd2 + self.k2 * rd2 * rd2
        return np.array([self.cx + du / d, self.cy + dv / d])

    def undistort_oneshot(self, uv: np.ndarray) -> np.ndarray:
        """undistortPoint (AddMapFeature.cpp:42-58)."""
        du, dv = uv[0] - self.cx, uv[1] - self.cy
        mx, my = self.dx * du, self.dy * dv
        r2 = mx * mx + my * my
        d = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        return np.array([self.cx + du * d, self.cy + dv * d])

    def undistort_jacobian(self, uv_dist: np.ndarray) -> np.ndarray:
        """d(undistort)/d(distorted pixel), 2x2, evaluated at a distorted
        point (makeJacobianOfDistortionFunction, MeasurementPrediction.cpp:
        308-337 == computeUndistortPointJacobian, AddMapFeature.cpp:65-90)."""
        pdx, pdy = uv_dist[0] - self.cx, uv_dist[1] - self.cy
        mx, my = self.dx * pdx, self.dy * pdy
        r2 = mx * mx + my * my
        rad = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        g = self.k1 + 2.0 * self.k2 * r2
        return np.array([
            [rad + pdx * g * 2.0 * pdx * self.dx * self.dx,
             pdx * g * 2.0 * pdy * self.dy * self.dy],
            [pdy * g * 2.0 * pdx * self.dx * self.dx,
             rad + pdy * g * 2.0 * pdy * self.dy * self.dy],
        ])

    def distort_jacobian_exact(self, uv_undist: np.ndarray) -> np.ndarray:
        """Exact d(distort_newton)/d(undistorted pixel) by implicit
        differentiation of r_d + k1 r_d^3 + k2 r_d^5 = r_u (the derivative
        of the converged unrolled Newton)."""
        du = np.array([uv_undist[0] - self.cx, uv_undist[1] - self.cy])
        m = np.array([self.dx * du[0], self.dy * du[1]])
        r2 = float(m @ m)
        ru = math.sqrt(max(r2, 1e-30))
        rd = ru / (1.0 + self.k1 * r2 + self.k2 * r2 * r2)
        for _ in range(10):
            rd2 = rd * rd
            f = rd + self.k1 * rd2 * rd + self.k2 * rd2 * rd2 * rd - ru
            fp = 1.0 + 3.0 * self.k1 * rd2 + 5.0 * self.k2 * rd2 * rd2
            rd = rd - f / fp
        rd2 = rd * rd
        d = 1.0 + self.k1 * rd2 + self.k2 * rd2 * rd2
        gp = 1.0 + 3.0 * self.k1 * rd2 + 5.0 * self.k2 * rd2 * rd2
        # out = c + du / d(rd(ru(du)));  dd/ddu = (2k1 rd + 4k2 rd^3)
        #   * (1/g'(rd)) * (dx^2 du_x, dy^2 du_y) / ru
        dd_drd = 2.0 * self.k1 * rd + 4.0 * self.k2 * rd * rd2
        dru_ddu = np.array([self.dx * self.dx * du[0],
                            self.dy * self.dy * du[1]]) / ru
        dd_ddu = dd_drd / gp * dru_ddu
        J = np.eye(2) / d - np.outer(du, dd_ddu) / (d * d)
        return J

    def in_front(self, p: np.ndarray) -> bool:
        """isInFrontOfCamera (MeasurementPrediction.cpp:162-171)."""
        axz = _RAD_TO_DEG * math.atan2(p[0], p[2])
        ayz = _RAD_TO_DEG * math.atan2(p[1], p[2])
        return (-self.avx < axz < self.avx) and (-self.avy < ayz < self.avy)

    def in_image(self, uv: np.ndarray) -> bool:
        return 0 < uv[0] < self.px and 0 < uv[1] < self.py


# ---------------------------------------------------------------------------
# dynamic-size filter state
# ---------------------------------------------------------------------------


class _Feature:
    __slots__ = ("pos", "dim", "cov_pos", "is_xyz", "times_predicted",
                 "times_matched", "slot")

    def __init__(self, pos, cov_pos, slot):
        self.pos = np.asarray(pos, np.float64)
        self.dim = 6
        self.cov_pos = cov_pos
        self.is_xyz = False
        self.times_predicted = 0
        self.times_matched = 0
        self.slot = slot


class _Pred:
    __slots__ = ("feat", "uv", "S", "Hs", "Hf")

    def __init__(self, feat, uv):
        self.feat = feat
        self.uv = uv
        self.S = None
        self.Hs = None    # (2, 13)
        self.Hf = None    # (2, dim)


class ReferenceOracle:
    """The reference EKF, minus vision, driven by injected measurements."""

    def __init__(self, config: SlamConfig,
                 quirks: Optional[OracleQuirks] = None):
        self.cfg = config
        self.q = quirks if quirks is not None else OracleQuirks()
        self.cam = _Cam(config.camera)
        ekf = config.ekf
        self.ekf = ekf
        # initState / initCovariance (CommonFunctions.cpp:39-80)
        self.x = np.zeros(13)
        self.x[3] = 1.0
        self.x[10:13] = EPSILON
        self.P = np.zeros((13, 13))
        for i in range(7):
            self.P[i, i] = EPSILON
        self.P[7:10, 7:10] = np.eye(3) * ekf.init_linear_accel_sd ** 2
        self.P[10:13, 10:13] = np.eye(3) * ekf.init_angular_accel_sd ** 2
        self.feats: List[_Feature] = []        # mapFeatures order
        self.invdepth: List[_Feature] = []     # mapFeaturesInvDepth order
        self.frame = 0
        self.slot_collisions = 0
        self.trajectory: List[np.ndarray] = []   # (13,) per frame

    # -- state helpers ----------------------------------------------------

    @property
    def n_dims(self) -> int:
        return 13 + sum(f.dim for f in self.feats)

    def _R(self) -> np.ndarray:
        return _quat_to_R(self.x[3:7])

    def _feature_by_slot(self, slot: int) -> Optional[_Feature]:
        for f in self.feats:
            if f.slot == slot:
                return f
        return None

    # -- predict (StateAndCovariancePrediction.cpp) -----------------------

    def _predict(self, dt: float = 1.0) -> None:
        w = self.x[10:13]
        q = self.x[3:7]
        q2 = _quat_from_rotvec(w * dt)

        F = np.eye(13)
        F[0:3, 7:10] = np.eye(3) * dt
        # dq'/dq: right-multiplication matrix of q2 (:70-91)
        qw, qx, qy, qz = q2
        F[3:7, 3:7] = np.array([
            [qw, -qx, -qy, -qz],
            [qx, qw, qz, -qy],
            [qy, -qz, qw, qx],
            [qz, qy, -qx, qw],
        ])
        G = np.zeros((13, 6))
        G[0:3, 0:3] = np.eye(3) * dt
        G[7:10, 0:3] = np.eye(3)
        G[10:13, 3:6] = np.eye(3)
        if (abs(w[0]) < EPSILON and abs(w[1]) < EPSILON
                and abs(w[2]) < EPSILON):
            # the reference's |w| ~ 0 branch zeroes the w-w identity AND
            # (because jacFSubmatrix still aliases the quaternion block and
            # a size-mismatched copyTo detaches) leaves G's quaternion block
            # zero (:171-185, :209-212)
            F[10, 10] = F[11, 11] = F[12, 12] = 0.0
        else:
            # dq'/dw (:98-148): Q(q) @ d(quat(w dt))/dw
            nw = math.sqrt(float(w @ w))
            qmat = np.array([
                [q[0], -q[1], -q[2], -q[3]],
                [q[1], q[0], -q[3], q[2]],
                [q[2], q[3], q[0], -q[1]],
                [q[3], -q[2], q[1], q[0]],
            ])
            h = nw * dt / 2.0
            sh, ch = math.sin(h), math.cos(h)
            d = np.zeros((4, 3))
            for a in range(3):
                d[0, a] = (-dt / 2.0) * (w[a] / nw) * sh
            for a in range(3):
                for b in range(3):
                    if a == b:
                        d[a + 1, b] = ((dt / 2.0) * w[a] * w[a] / (nw * nw)
                                       * ch
                                       + (1.0 / nw)
                                       * (1.0 - w[a] * w[a] / (nw * nw))
                                       * sh)
                    else:
                        d[a + 1, b] = (w[a] * w[b] / (nw * nw)
                                       * ((dt / 2.0) * ch - (1.0 / nw) * sh))
            dqdw = qmat @ d
            F[3:7, 10:13] = dqdw
            G[3:7, 3:6] = dqdw

        lin = self.ekf.linear_accel_sd ** 2 * dt * dt
        ang = self.ekf.angular_accel_sd ** 2 * dt * dt
        Q = np.diag([lin, lin, lin, ang, ang, ang])

        P = self.P
        P[0:13, 0:13] = F @ P[0:13, 0:13] @ F.T + G @ Q @ G.T
        if P.shape[0] > 13:
            P[0:13, 13:] = F @ P[0:13, 13:]
            P[13:, 0:13] = P[13:, 0:13] @ F.T

        # predictState (:43-65) runs after predictCovariance (:244-252)
        self.x[0:3] += self.x[7:10] * dt
        self.x[3:7] = _quat_mult(q, q2)

    # -- measurement prediction (MeasurementPrediction.cpp) ----------------

    def _point_in_camera(self, f: _Feature, x: np.ndarray) -> np.ndarray:
        Rt = _quat_to_R(x[3:7]).T
        if f.is_xyz:
            return Rt @ (f.pos[0:3] - x[0:3])
        m = _directional_vector(f.pos[3], f.pos[4])
        return Rt @ (f.pos[5] * (f.pos[0:3] - x[0:3]) + m)

    def _predict_features(self, feats: Sequence[_Feature],
                          x: Optional[np.ndarray] = None
                          ) -> Tuple[List[_Pred], List[_Feature]]:
        """predictMeasurementState (:203-265): returns (predictions,
        not-predicted features)."""
        x = self.x if x is None else x
        preds, unseen = [], []
        for f in feats:
            p_cam = self._point_in_camera(f, x)
            if self.cam.in_front(p_cam):
                uv = self.cam.distort_newton(self.cam.project(p_cam))
                if self.cam.in_image(uv):
                    preds.append(_Pred(f, uv))
                    continue
            unseen.append(f)
        return preds, unseen

    def _carp(self, Rt: np.ndarray, rho: Optional[float]) -> np.ndarray:
        """makeJacobianOfChangeToCameraAxisRightPart (:365-399): d(p_cam)/dr
        = -R^T (x rho for inverse depth), with the jacobian[1]/[2] slip."""
        J = -Rt.copy()
        if self.q.jacobian_slip:
            J = J.copy()
            J[0, 1] = 0.0           # jacobian[1] never written (stays 0)
        if rho is not None:
            if self.q.jacobian_slip:
                # the rho-scaled variant repeats the slip: index 1 is never
                # multiplied -- it is already 0, so scaling all is identical
                J = J * rho
            else:
                J = J * rho
        return J

    def _jacobians(self, pred: _Pred) -> None:
        """Fill pred.Hs (2x13), pred.Hf (2xdim), per the reference chain
        (makeMeasurementCovariance, :595-658)."""
        f = pred.feat
        x = self.x
        Rt = self._R().T
        p_cam = self._point_in_camera(f, x)
        # composed projection+distortion jacobian (2x3),
        # makeJacobianOfProjection (:343-362)
        fpj = np.array([
            [self.cam.fx / p_cam[2], 0.0,
             -p_cam[0] * self.cam.fx / (p_cam[2] * p_cam[2])],
            [0.0, self.cam.fy / p_cam[2],
             -p_cam[1] * self.cam.fy / (p_cam[2] * p_cam[2])],
        ])
        if self.q.handchain_distortion_jac:
            idj = np.linalg.inv(self.cam.undistort_jacobian(pred.uv))
        else:
            uv_undist = self.cam.project(p_cam)
            idj = self.cam.distort_jacobian_exact(uv_undist)
        proj = idj @ fpj

        # dh/dr (:404-437)
        rho = None if f.is_xyz else f.pos[5]
        dh_dr = proj @ self._carp(Rt, rho)

        # dh/dq (:443-485): d(R(q_conj) a)/dq * diag(1,-1,-1,-1)
        a = f.pos[0:3] - x[0:3]
        if not f.is_xyz:
            a = a * f.pos[5] + _directional_vector(f.pos[3], f.pos[4])
        q_conj = np.array([x[3], -x[4], -x[5], -x[6]])
        dq = _dR_a_dq(q_conj, a)
        dq[:, 1:] = -dq[:, 1:]
        dh_dq = proj @ dq

        Hs = np.zeros((2, 13))
        Hs[:, 0:3] = dh_dr
        Hs[:, 3:7] = dh_dq
        pred.Hs = Hs

        if f.is_xyz:
            pred.Hf = proj @ Rt          # (:510-523)
        else:
            theta, phi, rho = f.pos[3], f.pos[4], f.pos[5]
            cp, sp = math.cos(phi), math.sin(phi)
            ct, st = math.cos(theta), math.sin(theta)
            dm_dtheta = np.array([cp * ct, 0.0, -cp * st])
            dm_dphi = np.array([-sp * st, -cp, -sp * ct])
            offset = f.pos[0:3] - x[0:3]
            drho_col = offset if self.q.rho_unrotated else Rt @ offset
            Jf = np.zeros((3, 6))
            Jf[:, 0:3] = rho * Rt
            Jf[:, 3] = Rt @ dm_dtheta
            Jf[:, 4] = Rt @ dm_dphi
            Jf[:, 5] = drho_col          # (:560-580, quirk)
            pred.Hf = proj @ Jf

    def _innovation_cov(self, pred: _Pred) -> None:
        """S_i = H_i P H_i^T + I (identity R_i, :640-655)."""
        f = pred.feat
        cp, d = f.cov_pos, f.dim
        hiByP = (pred.Hf @ self.P[cp:cp + d, :]
                 + pred.Hs @ self.P[0:13, :])
        pred.S = (hiByP[:, 0:13] @ pred.Hs.T
                  + hiByP[:, cp:cp + d] @ pred.Hf.T + np.eye(2))

    def _predict_measurements(self, feats: Sequence[_Feature]
                              ) -> Tuple[List[_Pred], List[_Feature]]:
        """predictCameraMeasurements (:705-719)."""
        preds, unseen = self._predict_features(feats)
        for p in preds:
            self._jacobians(p)
            self._innovation_cov(p)
        return preds, unseen

    # -- update (Update.cpp) ----------------------------------------------

    def _dense_rows(self, preds: Sequence[_Pred]) -> np.ndarray:
        n = self.n_dims
        H = np.zeros((2 * len(preds), n))
        for i, p in enumerate(preds):
            H[2 * i:2 * i + 2, 0:13] = p.Hs
            cp, d = p.feat.cov_pos, p.feat.dim
            H[2 * i:2 * i + 2, cp:cp + d] = p.Hf
        return H

    def _state_plus(self, x13: np.ndarray, feats_flat: np.ndarray,
                    dx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """stateUpdate's deadbanded increment application (Update.cpp:
        147-203) on a (13,) camera vector + flat feature parameters."""
        full = np.concatenate([x13, feats_flat])
        if self.q.deadband:
            inc = np.where(np.abs(dx) > DELTA, dx, 0.0)
        else:
            inc = dx
        full = full + inc
        return full[:13], full[13:]

    def _flat_features(self) -> np.ndarray:
        if not self.feats:
            return np.zeros(0)
        return np.concatenate([f.pos for f in self.feats])

    def _unflatten_features(self, flat: np.ndarray) -> None:
        off = 0
        for f in self.feats:
            f.pos = flat[off:off + f.dim].copy()
            off += f.dim

    def _update(self, matches_z: Sequence[np.ndarray],
                preds: Sequence[_Pred], update_covariance: bool) -> None:
        """updateStateAndCovariance (Update.cpp:237-265)."""
        if not preds:
            return
        H = self._dense_rows(preds)
        R = np.eye(2 * len(preds)) * self.cam.pixel_error_x
        PHt = self.P @ H.T
        S = H @ PHt + R
        K = PHt @ np.linalg.inv(S)      # explicit inverse as the reference

        res = np.zeros(2 * len(preds))
        for i, (z, p) in enumerate(zip(matches_z, preds)):
            d = z - p.uv
            if self.q.deadband:
                d = np.where(np.abs(d) > DELTA, d, 0.0)
            res[2 * i:2 * i + 2] = d

        dx = K @ res
        x13, flat = self._state_plus(self.x, self._flat_features(), dx)
        self.x = x13
        self._unflatten_features(flat)
        if update_covariance:
            self.P = self.P - K @ (H @ self.P)

    def _update_full(self, matches_z, preds) -> None:
        """update (Update.cpp:282-318): joint update + numerics."""
        if not preds:
            return
        self._update(matches_z, preds, update_covariance=True)
        self.P = 0.5 * (self.P + self.P.T)
        Jq, norm = _quat_norm_jacobian(self.x[3:7])
        self.x[3:7] = self.x[3:7] / norm
        self.P[0:3, 3:7] = self.P[0:3, 3:7] @ Jq.T
        self.P[3:7, 0:3] = Jq @ self.P[3:7, 0:3]
        self.P[3:7, 3:7] = Jq @ self.P[3:7, 3:7] @ Jq.T
        self.P[3:7, 7:] = Jq @ self.P[3:7, 7:]
        self.P[7:, 3:7] = self.P[7:, 3:7] @ Jq.T

    # -- 1-point RANSAC (1PointRansac.cpp) ----------------------------------

    def _ransac(self, matches: List[Tuple[_Pred, np.ndarray]]
                ) -> Tuple[List[int], List[int]]:
        """Returns (inlier indices, outlier indices) into ``matches``."""
        if not matches:
            return [], []
        order = list(range(len(matches)))
        if self.q.hypothesis_order == "slot":
            order.sort(key=lambda i: matches[i][0].feat.slot)
        threshold = self.ekf.ransac_threshold_predict_distance
        num_hyp = 1000
        best: List[int] = []
        for k, i in enumerate(order):
            if self.q.adaptive_visit and k >= num_hyp:
                break
            pred, z = matches[i]
            # state-only 1-point update (updateOnlyState, Update.cpp:269-275)
            saved_x = self.x.copy()
            saved_feats = self._flat_features()
            self._update([z], [pred], update_covariance=False)
            temp_x = self.x.copy()
            temp_flat = self._flat_features()
            self.x = saved_x
            self._unflatten_features(saved_feats)

            # re-predict every feature with the hypothesized state
            support: List[int] = []
            # temp feature positions: build a lookup feature -> temp pos
            off = 0
            temp_pos = {}
            for f in self.feats:
                temp_pos[id(f)] = temp_flat[off:off + f.dim]
                off += f.dim
            by_feat = {id(m[0].feat): j for j, m in enumerate(matches)}
            for f in self.feats:
                tf = _Feature(temp_pos[id(f)], f.cov_pos, f.slot)
                tf.is_xyz = f.is_xyz
                tf.dim = f.dim
                p_cam = self._point_in_camera(tf, temp_x)
                if not self.cam.in_front(p_cam):
                    continue
                uv = self.cam.distort_newton(self.cam.project(p_cam))
                if not self.cam.in_image(uv):
                    continue
                j = by_feat.get(id(f))
                if j is None:
                    continue
                dz = matches[j][1] - uv
                if math.sqrt(float(dz @ dz)) < threshold:
                    support.append(j)
            if len(support) > len(best):
                best = support
                e = 1.0 - len(best) / len(matches)
                if self.q.adaptive_visit:
                    if e <= 0.0:
                        num_hyp = 0
                    else:
                        num_hyp = int(
                            math.log(1.0
                                     - self.ekf.ransac_all_inliers_probability)
                            / math.log(e))
        inliers = sorted(best)
        outliers = [i for i in range(len(matches)) if i not in set(inliers)]
        return inliers, outliers

    # -- map management (MapManagement.cpp) ---------------------------------

    def _remove_features(self, to_remove: List[_Feature]) -> None:
        """removeFeaturesFromStateAndCovariance (MapManagement.cpp:212-259);
        ``to_remove`` must be in mapFeatures order."""
        if not to_remove:
            return
        dims = []
        for f in to_remove:
            dims.extend(range(f.cov_pos, f.cov_pos + f.dim))
        self.P = np.delete(np.delete(self.P, dims, axis=0), dims, axis=1)
        removed = set(id(f) for f in to_remove)
        acc = 0
        for f in self.feats:
            if id(f) in removed:
                acc += f.dim
            else:
                f.cov_pos -= acc
        self.feats = [f for f in self.feats if id(f) not in removed]
        self.invdepth = [f for f in self.invdepth if id(f) not in removed]

    def _convert_one(self) -> None:
        """convertMapFeaturesInverseDepthToDepth (:494-523): at most one."""
        thr = self.ekf.inverse_depth_linearity_index_threshold
        # reference order: mapFeaturesInvDepth (insertion); the engine
        # scans slots -- mirror it in slot-ordered (correct_math) mode
        feats = (self.invdepth if self.q.hypothesis_order == "insertion"
                 else sorted(self.invdepth, key=lambda g: g.slot))
        for f in feats:
            # computeLinearityIndex (:311-339)
            rho = f.pos[5]
            sigma_rho = math.sqrt(self.P[f.cov_pos + 5, f.cov_pos + 5])
            sigma_d = sigma_rho / (rho * rho)
            m = _directional_vector(f.pos[3], f.pos[4])
            xyz = f.pos[0:3] + m / rho
            to_cam = xyz - self.x[0:3]
            to_anchor = xyz - f.pos[0:3]
            d_cam = math.sqrt(float(to_cam @ to_cam))
            d_anchor = math.sqrt(float(to_anchor @ to_anchor))
            cos_alpha = float(to_cam @ to_anchor) / (d_anchor * d_cam)
            li = 4.0 * sigma_d * cos_alpha / d_cam
            if li < thr:
                self._convert_to_depth(f)
                return

    def _convert_to_depth(self, f: _Feature) -> None:
        """convertToDepth (:343-490)."""
        theta, phi, rho = f.pos[3], f.pos[4], f.pos[5]
        m = _directional_vector(theta, phi)
        xyz = f.pos[0:3] + m / rho
        cp, sp = math.cos(phi), math.sin(phi)
        ct, st = math.cos(theta), math.sin(theta)
        J = np.zeros((3, 6))
        J[:, 0:3] = np.eye(3)
        J[:, 3] = np.array([cp * ct, 0.0, -cp * st]) / rho
        J[:, 4] = np.array([-sp * st, -cp, -sp * ct]) / rho
        J[:, 5] = -m / (rho * rho)

        k = f.cov_pos
        P = self.P
        n = P.shape[0]
        rows6 = P[k:k + 6, :]
        sub3n = J @ rows6                       # (3, n)
        newP = np.zeros((n - 3, n - 3))
        newP[0:k, 0:k] = P[0:k, 0:k]
        newP[k:k + 3, 0:k] = sub3n[:, 0:k]
        newP[0:k, k:k + 3] = P[0:k, k:k + 6] @ J.T
        newP[k:k + 3, k:k + 3] = sub3n[:, k:k + 6] @ J.T
        if k + 6 < n:
            newP[k:k + 3, k + 3:] = sub3n[:, k + 6:]
            newP[k + 3:, k:k + 3] = P[k + 6:, k:k + 6] @ J.T
            newP[k + 3:, 0:k] = P[k + 6:, 0:k]
            newP[0:k, k + 3:] = P[0:k, k + 6:]
            newP[k + 3:, k + 3:] = P[k + 6:, k + 6:]
        self.P = newP

        f.pos = xyz
        f.dim = 3
        f.is_xyz = True
        self.invdepth.remove(f)
        for g in self.feats:
            if g.cov_pos > k:
                g.cov_pos -= 3

    # -- feature addition (AddMapFeature.cpp) -------------------------------

    def add_feature(self, uv: np.ndarray, slot: int) -> None:
        """addFeatureToStateAndCovariance (:293-350) + covariance growth
        (:221-289), sequential."""
        existing = self._feature_by_slot(slot)
        if existing is not None:
            # slot collision: the replayed run freed this slot but the
            # oracle (diverged mapman decisions) has not -- drop ours first
            self.slot_collisions += 1
            self._remove_features([existing])

        cam = self.cam
        uvu = cam.undistort_oneshot(uv)
        ray_c = np.array([-(cam.cx - uvu[0]) / cam.fx,
                          -(cam.cy - uvu[1]) / cam.fy, 1.0])
        R = self._R()
        ray_w = R @ ray_c
        theta = math.atan2(ray_w[0], ray_w[2])
        phi = math.atan2(-ray_w[1],
                         math.sqrt(ray_w[0] ** 2 + ray_w[2] ** 2))
        pos = np.concatenate([self.x[0:3],
                              [theta, phi, self.ekf.init_inv_depth_rho]])
        f = _Feature(pos, self.P.shape[0], slot)
        self.feats.append(f)
        self.invdepth.append(f)

        # computeAddFeatureJacobian (:109-216)
        xw, yw, zw = ray_w
        xx_zz = xw * xw + zw * zw
        dtheta_dg = np.array([zw / xx_zz, 0.0, -xw / xx_zz])
        sq = math.sqrt(xx_zz)
        nsq = xx_zz + yw * yw
        dphi_dg = np.array([xw * yw / (nsq * sq), -sq / nsq,
                            zw * yw / (nsq * sq)])
        dg_dq = _dR_a_dq(self.x[3:7], ray_c)        # (3, 4)
        J1 = np.zeros((6, 7))
        J1[0:3, 0:3] = np.eye(3)
        J1[3, 3:7] = dtheta_dg @ dg_dq
        J1[4, 3:7] = dphi_dg @ dg_dq
        dgc_dhu = np.array([[1.0 / cam.fx, 0.0], [0.0, 1.0 / cam.fy],
                            [0.0, 0.0]])
        dhu_dhd = cam.undistort_jacobian(uv)
        sub = np.stack([dtheta_dg @ R, dphi_dg @ R]) @ dgc_dhu @ dhu_dhd
        J2 = np.zeros((6, 3))
        J2[3:5, 0:2] = sub
        J2[5, 2] = 1.0

        Radd = np.diag([cam.pixel_error_x ** 2, cam.pixel_error_y ** 2,
                        self.ekf.inverse_depth_rho_sd ** 2])
        P = self.P
        n = P.shape[0]
        newP = np.zeros((n + 6, n + 6))
        newP[0:n, 0:n] = P
        rows = J1 @ P[0:7, :]
        newP[n:, 0:n] = rows
        newP[0:n, n:] = P[:, 0:7] @ J1.T
        newP[n:, n:] = rows[:, 0:7] @ J1.T + J2 @ Radd @ J2.T
        self.P = newP

    # -- the per-frame pipeline (EKF::step, EKF.cpp:242-666) -----------------

    def init_with_features(self, uv_slots: Sequence[Tuple[np.ndarray, int]]
                           ) -> None:
        """EKF::init with injected detections (EKF.cpp:170-237)."""
        for uv, slot in uv_slots:
            self.add_feature(np.asarray(uv, np.float64), int(slot))

    def step_injected(self, z_by_slot: np.ndarray, matched_by_slot: np.ndarray,
                      new_uv_slots: Sequence[Tuple[np.ndarray, int]] = ()
                      ) -> dict:
        """One frame with injected per-slot measurements.

        ``z_by_slot`` (F, 2) and ``matched_by_slot`` (F,) are keyed by the
        engine's slot ids (the replay log); ``new_uv_slots`` is the
        list of (pixel, slot) detections added this frame.
        """
        self.frame += 1
        self._predict()

        preds, unseen = self._predict_measurements(self.feats)

        # guided matching replaced by the injection (in prediction order,
        # which is mapFeatures order -- matchPredictedFeatures iterates
        # predictions, Matching.cpp:217-263)
        matches: List[Tuple[_Pred, np.ndarray]] = []
        for p in preds:
            s = p.feat.slot
            if s >= 0 and s < len(matched_by_slot) and matched_by_slot[s]:
                matches.append((p, np.asarray(z_by_slot[s], np.float64)))

        inlier_idx, outlier_idx = self._ransac(matches)

        # low-innovation update with the pre-RANSAC jacobians (EKF.cpp:430)
        self._update_full([matches[i][1] for i in inlier_idx],
                          [matches[i][0] for i in inlier_idx])

        # outlier rescue on re-predicted features (EKF.cpp:443-517)
        outlier_feats = [matches[i][0].feat for i in outlier_idx]
        re_preds, _ = self._predict_measurements(outlier_feats)
        by_feat = {id(p.feat): p for p in re_preds}
        rescued_z, rescued_preds = [], []
        for i in outlier_idx:
            p = by_feat.get(id(matches[i][0].feat))
            if p is None:
                continue
            z = matches[i][1]
            d = z - p.uv
            if float(d @ np.linalg.inv(p.S) @ d) \
                    < self.ekf.ransac_chi2_threshold:
                rescued_z.append(z)
                rescued_preds.append(p)
        if rescued_preds:
            self._update_full(rescued_z, rescued_preds)

        # counters (updateMapFeatures, MapManagement.cpp:74-113)
        for p in preds:
            p.feat.times_predicted += 1
        inlier_feats = ([matches[i][0].feat for i in inlier_idx]
                        + [p.feat for p in rescued_preds])
        for f in inlier_feats:
            f.times_matched += 1

        n_inliers = len(inlier_feats)
        freq = self.ekf.map_management_frequency
        if freq > 0 and self.frame % freq == 0:
            needed = self.ekf.min_matches_per_image - n_inliers

            # removeBadMapFeatures (:279-307): NaN (0/0) compares False
            bad = []
            for f in self.feats:
                if f.times_predicted > 0 and (
                        f.times_matched / f.times_predicted
                        < self.ekf.good_feature_matching_percent):
                    bad.append(f)
            self._remove_features(bad)

            # unseen-pressure removal (EKF.cpp:582-586); skip features the
            # bad cull just freed (the reference UAFs here, see module doc)
            live = set(id(f) for f in self.feats)
            unseen_live = [f for f in unseen if id(f) in live]
            if needed > 0 and (
                    self.ekf.always_remove_unseen_map_features
                    or (self.ekf.max_map_features_count > 0
                        and len(self.feats) + needed
                        > self.ekf.max_map_features_count)
                    or (self.ekf.max_map_size > 0
                        and self.P.shape[0] + needed * 6
                        > self.ekf.max_map_size)):
                self._remove_features(unseen_live)

            self._convert_one()

            if needed > 0:
                for uv, slot in new_uv_slots:
                    self.add_feature(np.asarray(uv, np.float64), int(slot))

        self.trajectory.append(self.x[0:13].copy())
        return {
            "frame": self.frame,
            "total_matches": len(matches),
            "li_inliers": len(inlier_idx),
            "hi_inliers": len(rescued_preds),
            "n_active": len(self.feats),
            "position": self.x[0:3].copy(),
        }


def replay_log(config: SlamConfig, log: dict,
               quirks: Optional[OracleQuirks] = None) -> ReferenceOracle:
    """Drive an oracle through a recorded injection log.

    ``log`` = {"init": [(uv, slot), ...], "frames": [{"z": (F,2),
    "matched": (F,), "new": [(uv, slot), ...]}, ...]} as produced by
    tests/test_oracle_parity.py's recorder.
    """
    orc = ReferenceOracle(config, quirks)
    orc.init_with_features(log["init"])
    for fr in log["frames"]:
        orc.step_injected(fr["z"], fr["matched"], fr.get("new", ()))
    return orc


def quirk_variants() -> dict:
    """Named quirk configurations for the parity study."""
    full = OracleQuirks()
    return {
        "reference": full,
        "no_slip": dataclasses.replace(full, jacobian_slip=False),
        "no_rho_quirk": dataclasses.replace(full, rho_unrotated=False),
        "no_deadband": dataclasses.replace(full, deadband=False),
        "correct_math": OracleQuirks.none(),
    }
