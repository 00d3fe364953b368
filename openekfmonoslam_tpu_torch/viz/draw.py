"""Rendering of predictions, matches, and trajectories (port of viz/draw.py).

Reference: modules/Gui/Draw.cpp.  drawPrediction overlays each predicted
feature and its uncertainty ellipse on the frame (Draw.cpp:66-94, written
per frame as %05d.png and into videoOutput.mpg, EKF.cpp:294-305);
drawPlanarInformation renders the 2D trajectory (Draw.cpp:96-148).

Unlike the reference, rendering here is display-only: the *compute* role
of ellipse rasterization (search masks) is served by the analytic
Mahalanobis gates in vision/matching.py.  Ellipse geometry matches
matrix2x2ToUncertaintyEllipse2D (EKFMath.cpp:271-298): half-axes
2 sqrt(eig * chi2_95), orientation from the leading eigenvector.

Every function draws on numpy arrays on the host, with OpenCV (imported
at the first call); the engine (engine/engine.py) reads a frame's drawing
fields back inside its one packed summary copy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

CHISQ_95_2 = 5.9915


def ellipse_params(S: np.ndarray) -> tuple:
    """2x2 covariance -> (half_axes (2,), angle_rad) per
    matrix2x2ToUncertaintyEllipse2D (EKFMath.cpp:271-298)."""
    vals, vecs = np.linalg.eigh(S)
    # eigh sorts ascending; the reference's cv::eigen gives descending
    vals = vals[::-1]
    vecs = vecs[:, ::-1]
    axes = 2.0 * np.sqrt(np.maximum(vals, 0.0) * CHISQ_95_2)
    angle = float(np.arctan2(vecs[1, 0], vecs[0, 0]))
    return axes, angle


def draw_prediction_overlay(gray: np.ndarray, pred_uv: np.ndarray,
                            pred_S: np.ndarray, visible: np.ndarray,
                            matched_uv: Optional[np.ndarray] = None,
                            matched: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """BGR overlay frame (drawPrediction semantics): red crosses at
    predictions, green ellipses, yellow crosses at matches."""
    import cv2
    img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    for i in range(len(pred_uv)):
        if not visible[i]:
            continue
        c = (int(round(pred_uv[i, 0])), int(round(pred_uv[i, 1])))
        axes, angle = ellipse_params(pred_S[i])
        cv2.ellipse(img, c, (int(axes[0]), int(axes[1])),
                    np.degrees(angle), 0, 360, (0, 200, 0), 1)
        cv2.drawMarker(img, c, (0, 0, 255), cv2.MARKER_CROSS, 5)
        if matched is not None and matched[i]:
            m = (int(round(matched_uv[i, 0])), int(round(matched_uv[i, 1])))
            cv2.drawMarker(img, m, (0, 255, 255), cv2.MARKER_CROSS, 5)
    return img


def draw_ransac_debug(gray: np.ndarray, z: np.ndarray,
                      matched: np.ndarray, inliers: np.ndarray,
                      new_uv: Optional[np.ndarray] = None,
                      new_ok: Optional[np.ndarray] = None) -> np.ndarray:
    """RANSAC + new-feature debug overlay: the DEBUG_SHOW_RANSAC_INFO /
    DEBUG_SHOW_NEW_FEATURES windows (EKF.cpp:198-222,542-544; Draw.h),
    rendered headlessly.  Accepted matches (LI + rescued HI) green,
    RANSAC-rejected outliers red, newly initialized features blue."""
    import cv2
    img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    for i in range(len(z)):
        if not matched[i]:
            continue
        c = (int(round(z[i, 0])), int(round(z[i, 1])))
        if inliers[i]:
            cv2.circle(img, c, 4, (0, 200, 0), 1)
        else:
            cv2.drawMarker(img, c, (0, 0, 230), cv2.MARKER_TILTED_CROSS, 7)
    if new_uv is not None and new_ok is not None:
        for i in range(len(new_uv)):
            if new_ok[i]:
                c = (int(round(new_uv[i, 0])), int(round(new_uv[i, 1])))
                cv2.drawMarker(img, c, (230, 120, 0), cv2.MARKER_DIAMOND, 7)
    return img


def draw_planar_trajectory(positions: np.ndarray, size: int = 600,
                           axes=(0, 2)) -> np.ndarray:
    """Top-down 2D trajectory image (drawPlanarInformation, Draw.cpp:96-148)."""
    import cv2
    img = np.full((size, size, 3), 255, np.uint8)
    p = positions[:, list(axes)]
    lo = p.min(0)
    hi = p.max(0)
    span = np.maximum(hi - lo, 1e-9)
    scale = (size * 0.9) / span.max()
    xy = ((p - lo) * scale + size * 0.05).astype(int)
    for a, b in zip(xy[:-1], xy[1:]):
        cv2.line(img, tuple(a), tuple(b), (180, 0, 0), 1)
    cv2.circle(img, tuple(xy[0]), 4, (0, 160, 0), -1)
    cv2.circle(img, tuple(xy[-1]), 4, (0, 0, 200), -1)
    return img


class VideoSink:
    """Per-frame PNG + video writer (EKF.cpp:294-305 outputs)."""

    def __init__(self, output_path: str, fps: float = 20.0,
                 write_pngs: bool = True, video_name: str = "videoOutput.mp4"):
        self.output_path = output_path
        self.fps = fps
        self.write_pngs = write_pngs
        self.video_name = video_name
        self._writer = None
        self._index = 0
        os.makedirs(output_path, exist_ok=True)

    def write(self, frame_bgr: np.ndarray) -> None:
        import cv2
        self._index += 1
        if self.write_pngs:
            cv2.imwrite(os.path.join(self.output_path,
                                     f"{self._index:05d}.png"), frame_bgr)
        if self._writer is None:
            h, w = frame_bgr.shape[:2]
            self._writer = cv2.VideoWriter(
                os.path.join(self.output_path, self.video_name),
                cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
        self._writer.write(frame_bgr)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None
