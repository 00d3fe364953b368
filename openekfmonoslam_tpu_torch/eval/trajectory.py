"""Offline evaluation: the resultReader equivalents plus ATE/RPE (a copy
of the JAX package's numpy-only eval/trajectory.py, which the port does
not import).

Reference: kalmanFilter/resultReader/.  The reference's evaluation story is
to re-read output.yml, extract per-frame camera state / counts / phase
times, recover the metric scale from the known robot speed via a 30-bucket
histogram mode (main.cpp:100-117,152-153; ScaleFactor.cpp:43-89), and emit
MATLAB series for plotting.  This module reproduces those computations on
record dicts/arrays and adds standard trajectory metrics (ATE / RPE,
optional similarity alignment) that the reference lacks -- they are the
parity measure against reference trajectories (BASELINE.md).
"""

from __future__ import annotations

import numpy as np

EXABOT_VELOCITY = 0.002904  # m/s (resultReader/main.cpp:42)
HISTOGRAM_BUCKETS = 30


def positions_from_records(records) -> np.ndarray:
    """(T, 3) camera positions from a list of record dicts or a StepRecord
    of stacked numpy arrays."""
    if isinstance(records, list):
        return np.asarray([r["position"] for r in records])
    return np.asarray(records.x_cam[:, 0:3])


def velocities_from_records(records) -> np.ndarray:
    if isinstance(records, list):
        return np.asarray([r["linear_velocity"] for r in records])
    return np.asarray(records.x_cam[:, 7:10])


def scale_factor(linear_velocities: np.ndarray,
                 robot_velocity: float = EXABOT_VELOCITY) -> float:
    """Metric scale from known robot speed: per-frame f = v_real / |v_est|,
    histogram-mode bucket average (ScaleFactor::determine,
    ScaleFactor.cpp:43-89)."""
    speeds = np.linalg.norm(linear_velocities, axis=-1)
    factors = robot_velocity / speeds[speeds > 0]
    if len(factors) == 0:
        return float("nan")
    lo, hi = factors.min(), factors.max()
    if hi == lo:
        return float(lo)
    bucket = (hi - lo) / HISTOGRAM_BUCKETS
    pos = np.minimum(((factors - lo) / bucket).astype(int),
                     HISTOGRAM_BUCKETS - 1)
    counts = np.bincount(pos, minlength=HISTOGRAM_BUCKETS)
    best = int(np.argmax(counts))
    return float(factors[pos == best].mean())


def align_similarity(est: np.ndarray, ref: np.ndarray,
                     with_scale: bool = True):
    """Umeyama similarity alignment est -> ref; returns (s, R, t)."""
    mu_e, mu_r = est.mean(0), ref.mean(0)
    E, Rf = est - mu_e, ref - mu_r
    C = Rf.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (E ** 2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale else 1.0
    t = mu_r - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, ref: np.ndarray, align: bool = True,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after optional similarity alignment
    (monocular SLAM is scale-free, so with_scale=True is the standard)."""
    est = np.asarray(est, float)
    ref = np.asarray(ref, float)
    assert est.shape == ref.shape
    if align and len(est) >= 3:
        s, R, t = align_similarity(est, ref, with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=-1))))


def rpe_rmse(est: np.ndarray, ref: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over ``delta``-frame steps."""
    de = est[delta:] - est[:-delta]
    dr = ref[delta:] - ref[:-delta]
    return float(np.sqrt(np.mean(np.sum((de - dr) ** 2, axis=-1))))


def summarize(records) -> dict:
    """Per-run summary: counts, scale factor, phase-time stats (the
    resultReader output set, main.cpp:82-163)."""
    pos = positions_from_records(records)
    vel = velocities_from_records(records)
    out = {
        "n_frames": len(pos),
        "path_length": float(np.sum(np.linalg.norm(np.diff(pos, axis=0),
                                                   axis=-1))),
        "scale_factor": scale_factor(vel),
        "final_position": pos[-1].tolist() if len(pos) else None,
    }
    if isinstance(records, list):
        for k in ("total_matches", "li_inliers", "hi_inliers", "n_active"):
            vals = [r[k] for r in records]
            out[f"mean_{k}"] = float(np.mean(vals))
        if "wall_time_s" in records[0]:
            out["mean_wall_ms"] = float(
                np.mean([r["wall_time_s"] for r in records]) * 1e3)
    else:
        out["mean_total_matches"] = float(np.mean(
            np.asarray(records.total_matches)))
        out["mean_li_inliers"] = float(np.mean(np.asarray(records.li_inliers)))
        out["mean_hi_inliers"] = float(np.mean(np.asarray(records.hi_inliers)))
        out["mean_n_active"] = float(np.mean(np.asarray(records.n_active)))
    return out
