"""resultReader-compatible post-processing: MATLAB .m series emission
(a copy of the JAX package's numpy-only eval/result_reader.py, which the
port does not import).

Reference: kalmanFilter/resultReader/ -- reads output.yml, extracts
per-frame camera positions / velocities / Euler orientations / counts /
phase times, recovers metric scale, and writes each series as a MATLAB
function file (Points3d.cpp:44-66, Points1d, TimesCpu, ScaleFactor.cpp:
91-109).  This module produces the same artifact set from this engine's
records (list of dicts from SlamEngine, or a StepRecord of stacked numpy
arrays from engine/scan_runner.py).
"""

from __future__ import annotations

import os

import numpy as np

from openekfmonoslam_tpu_torch.eval.trajectory import (
    EXABOT_VELOCITY,
    scale_factor,
)


def _quat_to_euler(q: np.ndarray) -> np.ndarray:
    """(T, 4) -> (T, 3) roll/pitch/yaw (quaterionToAngles, EKFMath.cpp:355-365)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)),
        np.arcsin(np.clip(2 * (w * y - z * x), -1, 1)),
        np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z)),
    ], axis=-1)


def write_points3d(path: str, name: str, pts: np.ndarray) -> None:
    """A MATLAB function returning 3 column vectors (Points3d.cpp:44-66)."""
    with open(path, "w") as f:
        f.write(f"function [x, y, z] = {name}()\n")
        for dim, label in enumerate("xyz"):
            vals = " ".join(f"{v:.17g}" for v in pts[:, dim])
            f.write(f"{label} = [{vals}];\n")
        f.write("end\n")


def write_points1d(path: str, name: str, vals: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write(f"function [x] = {name}()\n")
        body = " ".join(f"{v:.17g}" for v in np.asarray(vals).ravel())
        f.write(f"x = [{body}];\nend\n")


def write_scale_factor(path: str, name: str, factor: float) -> None:
    """(ScaleFactor::save, ScaleFactor.cpp:91-109)."""
    with open(path, "w") as f:
        f.write(f"function [x] = {name}()\nx = [{factor:.17g}];\nend\n")


PHASE_KEYS = ("Prediction", "Matching", "Ransac", "UpdateLI",
              "RescueOutliers", "UpdateHI", "MapManagement")


def records_to_dicts(records, phase_times=None, frame_time_us=None) -> list:
    """Stacked StepRecord (scan runner output) -> per-frame dicts
    in the engine's record format.

    ``phase_times`` (T, 7) gives each frame's 7 phases in microseconds, as
    measured (the step's ``step.<phase>`` spans; EKF.cpp:255-618), and
    ``frame_time_us`` the mean frame time for ``wall_time_s``.  Dicts with
    phase times carry ``phase_times_source = "measured"``, as the engine's
    do.
    """
    x = np.asarray(records.x_cam, np.float64)
    P = np.asarray(records.P_cam, np.float64)
    tm = np.asarray(records.total_matches)
    li = np.asarray(records.li_inliers)
    hi = np.asarray(records.hi_inliers)
    na = np.asarray(records.n_active)
    out = []
    for i in range(len(x)):
        r = {
            "frame": i + 1,
            "position": x[i, 0:3].tolist(),
            "orientation": x[i, 3:7].tolist(),
            "linear_velocity": x[i, 7:10].tolist(),
            "angular_velocity": x[i, 10:13].tolist(),
            "covariance_cam": P[i].tolist(),
            "total_matches": int(tm[i]),
            "li_inliers": int(li[i]),
            "hi_inliers": int(hi[i]),
            "n_active": int(na[i]),
            "wall_time_s": (frame_time_us or 0.0) * 1e-6,
        }
        if phase_times is not None:
            r["phase_times_us"] = {
                k: float(us) for k, us in zip(PHASE_KEYS, phase_times[i])}
            r["phase_times_source"] = "measured"
        out.append(r)
    return out


def _write_cvmat(f, indent: str, name: str, rows: int, cols: int,
                 data) -> None:
    f.write(f"{indent}{name}: !!opencv-matrix\n")
    f.write(f"{indent}   rows: {rows}\n")
    f.write(f"{indent}   cols: {cols}\n")
    f.write(f"{indent}   dt: d\n")
    vals = ", ".join(f"{float(v):.17g}" for v in np.asarray(data).ravel())
    f.write(f"{indent}   data: [ {vals} ]\n")


def write_output_yml(records, path: str) -> str:
    """Reference-shaped output.yml (the exact key set EKF::step writes,
    EKF.cpp:291,340,410-416,437,511-517,539,614-628): 7 per-phase
    microsecond timings, match/inlier counts, the 1x13 StateEstimation
    matrix with inverse-depth/XYZ counts, and the 13x13
    StateCovarianceMatrixEstimation corner."""
    if not isinstance(records, list):
        records = records_to_dicts(records)
    source = next((r["phase_times_source"] for r in records
                   if r.get("phase_times_source")), None)
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        if source is not None:
            # honesty label for the 7-phase channel: "measured" = live
            # per-phase bracketing (the reference's Timer semantics),
            # "calibrated-shares" = scan-mode attribution (calibrated
            # phase shares x measured fused frame time)
            f.write(f'PhaseTimesSource: "{source}"\n')
        for r in records:
            pt = r.get("phase_times_us") or {}
            f.write(f'"Frame {r["frame"]}":\n')
            f.write(f"   Prediction: {pt.get('Prediction', 0.0):.1f}\n")
            f.write(f"   Matching: {pt.get('Matching', 0.0):.1f}\n")
            f.write(f"   Ransac: {pt.get('Ransac', 0.0):.1f}\n")
            f.write(f"   totalMatches: {r['total_matches']}\n")
            f.write(f"   liInliers: {r['li_inliers']}\n")
            f.write(f"   UpdateLI: {pt.get('UpdateLI', 0.0):.1f}\n")
            f.write("   RescueOutliers: "
                    f"{pt.get('RescueOutliers', 0.0):.1f}\n")
            f.write(f"   hiInliers: {r['hi_inliers']}\n")
            f.write(f"   UpdateHI: {pt.get('UpdateHI', 0.0):.1f}\n")
            f.write("   MapManagement: "
                    f"{pt.get('MapManagement', 0.0):.1f}\n")
            state13 = (list(r["position"]) + list(r["orientation"])
                       + list(r["linear_velocity"])
                       + list(r["angular_velocity"]))
            _write_cvmat(f, "   ", "StateEstimation", 1, 13, state13)
            f.write("   MapFeaturesInvDepthCount: "
                    f"{r.get('n_inverse_depth', r.get('n_active', 0))}\n")
            f.write(f"   MapFeaturesDepthCount: {r.get('n_xyz', 0)}\n")
            if r.get("covariance_cam") is not None:
                _write_cvmat(f, "   ", "StateCovarianceMatrixEstimation",
                             13, 13, r["covariance_cam"])
    return path


def read_output_yml(path: str) -> list:
    """Parse an output.yml (reference-shaped, as written by
    write_output_yml / EKF.cpp) back into record dicts -- the input side of
    the resultReader role (resultReader/main.cpp:82-150)."""
    records: list[dict] = []
    cur: dict | None = None
    pending_mat: str | None = None
    mat_data: list = []
    in_data = False   # inside a multi-line flow-style data: [ ... ] array

    def finish_mat():
        nonlocal pending_mat, mat_data
        if cur is None or pending_mat is None:
            return
        if pending_mat == "StateEstimation" and len(mat_data) == 13:
            cur["position"] = mat_data[0:3]
            cur["orientation"] = mat_data[3:7]
            cur["linear_velocity"] = mat_data[7:10]
            cur["angular_velocity"] = mat_data[10:13]
        elif pending_mat == "StateCovarianceMatrixEstimation":
            cur["covariance_cam"] = [mat_data[i * 13:(i + 1) * 13]
                                     for i in range(13)]
        pending_mat, mat_data = None, []

    source = None
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("PhaseTimesSource:"):
                source = s.split(":", 1)[1].strip().strip('"')
                continue
            if s.startswith('"Frame'):
                finish_mat()
                if cur:
                    records.append(cur)
                cur = {"frame": int(s.split()[1].rstrip('":')),
                       "phase_times_us": {}}
                continue
            if cur is None:
                continue
            if in_data:
                # continuation of a wrapped flow-style array: genuine
                # cv::FileStorage output wraps long rows (EKF.cpp:614-628
                # writes 169-entry covariance matrices), unlike our
                # single-line writer
                mat_data.extend(float(v) for v in
                                s.rstrip("]").strip().split(",")
                                if v.strip())
                if s.endswith("]"):
                    in_data = False
                    finish_mat()
                continue
            if ":" not in s:
                continue
            key, _, val = s.partition(":")
            val = val.strip()
            if key in ("rows", "cols", "dt") and pending_mat:
                continue
            if key == "data" and pending_mat:
                mat_data = [float(v) for v in
                            val.strip("[] ").split(",") if v.strip()]
                if val.startswith("[") and not val.endswith("]"):
                    in_data = True          # wrapped across lines
                else:
                    finish_mat()
                continue
            finish_mat()
            if key in ("StateEstimation", "StateCovarianceMatrixEstimation"):
                pending_mat, mat_data = key, []
            elif key == "totalMatches":
                cur["total_matches"] = int(val)
            elif key == "liInliers":
                cur["li_inliers"] = int(val)
            elif key == "hiInliers":
                cur["hi_inliers"] = int(val)
            elif key == "MapFeaturesInvDepthCount":
                cur["n_inverse_depth"] = int(val)
            elif key == "MapFeaturesDepthCount":
                cur["n_xyz"] = int(val)
            elif key in PHASE_KEYS:
                cur["phase_times_us"][key] = float(val)
    finish_mat()
    if cur:
        records.append(cur)
    for r in records:
        if source is not None and r.get("phase_times_us"):
            r.setdefault("phase_times_source", source)
        r.setdefault("wall_time_s",
                     sum(r.get("phase_times_us", {}).values()) * 1e-6)
        r.setdefault("hi_inliers", 0)
        r.setdefault("li_inliers", 0)
        r.setdefault("total_matches", 0)
        if r.get("n_inverse_depth") is not None:
            r.setdefault("n_active",
                         r["n_inverse_depth"] + r.get("n_xyz", 0))
    return records


def write_times_cpu(path: str, name: str, phase_times: np.ndarray) -> None:
    """7-phase per-frame timing series in the reference's timesCpu.m
    format (TimesCpu::save, resultReader/TimesCpu.cpp:49-71):
    ``function [p, m, ran, li, res, hi, map] = timesCpu()``."""
    labels = ("p", "m", "ran", "li", "res", "hi", "map")
    with open(path, "w") as f:
        f.write(f"function [{', '.join(labels)}] = {name}()\n")
        for j, lab in enumerate(labels):
            vals = " ".join(f"{v:.17g}" for v in phase_times[:, j])
            f.write(f"{lab} = [{vals}];\n")
        f.write("end\n")


def _extract(records):
    if isinstance(records, list):
        pos = np.asarray([r["position"] for r in records])
        quat = np.asarray([r["orientation"] for r in records])
        vel = np.asarray([r["linear_velocity"] for r in records])
        avel = np.asarray([r["angular_velocity"] for r in records])
        matches = np.asarray([r["total_matches"] for r in records])
        li = np.asarray([r["li_inliers"] for r in records])
        hi = np.asarray([r["hi_inliers"] for r in records])
        times = np.asarray([r.get("wall_time_s", 0.0) for r in records])
        phase = np.asarray(
            [[r.get("phase_times_us", {}).get(k, 0.0) for k in PHASE_KEYS]
             for r in records])
    else:
        x = np.asarray(records.x_cam)
        pos, quat, vel, avel = x[:, 0:3], x[:, 3:7], x[:, 7:10], x[:, 10:13]
        matches = np.asarray(records.total_matches)
        li = np.asarray(records.li_inliers)
        hi = np.asarray(records.hi_inliers)
        times = np.zeros(len(x))
        phase = np.zeros((len(x), 7))
    return pos, quat, vel, avel, matches, li, hi, times, phase


def emit_matlab_report(records, output_dir: str,
                       robot_velocity: float = EXABOT_VELOCITY) -> dict:
    """Write the full resultReader artifact set (resultReader/main.cpp:152-163)."""
    os.makedirs(output_dir, exist_ok=True)
    pos, quat, vel, avel, matches, li, hi, times, phase = _extract(records)

    write_points3d(os.path.join(output_dir, "cameraPositions.m"),
                   "cameraPositions", pos)
    write_points3d(os.path.join(output_dir, "cameraLinearVelocities.m"),
                   "cameraLinearVelocities", vel)
    write_points3d(os.path.join(output_dir, "cameraAngularVelocities.m"),
                   "cameraAngularVelocities", avel)
    write_points3d(os.path.join(output_dir, "cameraOrientations.m"),
                   "cameraOrientations", _quat_to_euler(quat))
    write_points1d(os.path.join(output_dir, "matches.m"), "matches", matches)
    write_points1d(os.path.join(output_dir, "inliers.m"), "inliers", li)
    write_points1d(os.path.join(output_dir, "rescued.m"), "rescued", hi)
    # timesCpu.m carries the 7-phase series (TimesCpu.cpp format); the
    # per-frame wall totals go to wallTimes.m
    write_times_cpu(os.path.join(output_dir, "timesCpu.m"), "timesCpu",
                    phase)
    write_points1d(os.path.join(output_dir, "wallTimes.m"), "wallTimes",
                   times)

    sf = scale_factor(vel, robot_velocity)
    write_scale_factor(os.path.join(output_dir, "scaleFactor.m"),
                       "scaleFactor", sf)
    return {"scale_factor": sf, "n_frames": len(pos)}
