"""Host-side engine: the reference's 3-call public API, plus outputs (port
of engine/engine.py).

The reference's public surface is ``EKF(configFile, outputPath)``,
``EKF::init(image)`` and ``EKF::step(image)``, with direct access to
``state`` and ``stateCovarianceMatrix`` (EKF.h:41-63).  SlamEngine mirrors
that:

    engine = SlamEngine("config.yml", output_path="out/")
    engine.init(first_frame)          # EKF::init
    for frame in frames:
        record = engine.step(frame)   # EKF::step
    engine.state_vector, engine.covariance   # state access
    engine.close()

It runs on the first CUDA device unless ``device="cpu"`` is given.  A
config path sizes the map with ``auto_max_features`` from the file's
MaxMapSize, as the JAX engine does: ``MaxMapSize: 960`` gives F = 168
slots and a padded state of N = 1024.

Per-frame records carry the observables the reference writes to
output.yml (state, 13x13 covariance corner, match/inlier counts, per-phase
wall times; EKF.cpp:405-628), as JSONL plus an output.yml for the
resultReader tooling (``eval/result_reader.py``).  ``step`` reads one
packed summary back a frame, in one device-to-host copy; the step itself
adds the one read of ``SlamRuntime.phase_mapman``, after the replay of its
captured prefix on the card (engine/step_graph.py).

``keyframe_every > 0`` adds the keyframe pose graph (graph/pose_graph.py)
with automatic loop closure (graph/loop_closure.py): a keyframe every
``keyframe_every`` frames and on every relocalization, each one a place
recognition query against the older keyframes.  A keyframe frame reads
back twice more (the candidates' match counts and the PnP's result); the
graph lives on the engine's device and ``corrected_trajectory`` optimises
it there.

``render`` writes the prediction overlay (``%05d.png`` and
``videoOutput.mp4``), ``render_debug`` the RANSAC and new-feature overlay
(``debug/%05d.png`` and ``debug/ransacDebug.mp4``), and ``viz3d_every``
the 3D map view (``map3d_%05d.png`` every N frames), all drawn on the host
by ``viz/``.  The overlays' fields of the record ride in the packed
summary's one copy, so a rendered frame reads back no more often than
another; a 3D view reads back once more (``viewer3d.snapshot_from_state``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from openekfmonoslam_tpu_torch import spans
from openekfmonoslam_tpu_torch.config import (SlamConfig, auto_max_features,
                                              load_config)
from openekfmonoslam_tpu_torch.engine import checkpoint
from openekfmonoslam_tpu_torch.engine.step import SlamRuntime, StepRecord
from openekfmonoslam_tpu_torch.eval import result_reader
from openekfmonoslam_tpu_torch.graph import pose_graph as graph_mod
from openekfmonoslam_tpu_torch.graph.loop_closure import (LoopCloser,
                                                          correct_trajectory)
from openekfmonoslam_tpu_torch.io.sources import to_gray
from openekfmonoslam_tpu_torch.spans import span

# the record's fields that the overlays draw, in the order the packed
# summary carries them
DRAW_FIELDS = ("pred_uv", "pred_S", "visible", "z", "matched", "inliers",
               "new_uv", "new_ok")
# the step's map counts a record gives while the recorder is on (spans.py),
# beside "replayed": 1 where the step replayed its prefix's CUDA graph
MAP_COUNTS = ("added", "removed", "converted")


class SlamEngine:
    def __init__(self, config: "str | os.PathLike | SlamConfig",
                 output_path: Optional[str] = None, render: bool = False,
                 render_debug: bool = False,
                 keyframe_every: int = 0, keyframe_capacity: int = 256,
                 relocalize_after: int = 0, lost_matches_threshold: int = 4,
                 phase_timing: bool = False, viz3d_every: int = 0,
                 device=None, **overrides):
        if isinstance(config, SlamConfig):
            cfg = config
        else:
            cfg = load_config(os.fspath(config))
            if "max_features" not in overrides:
                overrides["max_features"] = auto_max_features(cfg.ekf)
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        self.runtime = SlamRuntime(cfg, device=device)
        self.device = self.runtime.device
        self.state = self.runtime.make_initial_state()
        self.records: list[dict] = []
        self.frame_index = 0
        # the reference's 7-phase microsecond timing channel
        # (EKF.cpp:255-618): each frame's step.<phase> spans, on the host's
        # clock, with no sync between phases (spans.collect)
        self.phase_timing = phase_timing
        # automatic relocalization: after ``relocalize_after`` consecutive
        # frames with fewer than ``lost_matches_threshold`` matches, drop
        # the map, keep the pose, and re-bootstrap from the current frame
        # (EKF.cpp:587-588 / MapManagement.cpp:263-275).  0 disables.
        self.relocalize_after = relocalize_after
        self.lost_matches_threshold = lost_matches_threshold
        self.lost_streak = 0
        self.relocalizations = 0

        # the keyframe pose graph: a keyframe every ``keyframe_every``
        # frames, loop closures by place recognition + PnP
        self.keyframe_every = keyframe_every
        self.pose_graph = None
        self.loop_closer = None
        self.keyframe_frames: list[int] = []
        self._graph_nodes = 0    # the graph's n_nodes, counted on the host
        if keyframe_every > 0:
            # odometry-edge information: the relative motion noise over the
            # keyframe interval (velocity random walk, k^3/2 growth), not
            # the inverse absolute covariance, which shrinks as the filter
            # converges and would drown the loop-closure edges
            k = float(keyframe_every)
            sig_r = max(cfg.ekf.linear_accel_sd * k ** 1.5, 1e-5)
            sig_t = max(cfg.ekf.angular_accel_sd * k ** 1.5, 1e-5)
            self._odometry_info = torch.diag(torch.tensor(
                [1.0 / sig_r ** 2] * 3 + [1.0 / sig_t ** 2] * 3,
                dtype=torch.float32)).to(self.device)
            self.pose_graph = graph_mod.make_pose_graph(
                max_nodes=keyframe_capacity,
                max_edges=4 * keyframe_capacity, device=self.device)
            self.loop_closer = LoopCloser(self.runtime)

        self.output_path = output_path
        self._jsonl = None
        self._log = None
        self._sink = None
        self._debug_sink = None
        self._map3d = None
        if output_path:
            os.makedirs(output_path, exist_ok=True)
            self._jsonl = open(os.path.join(output_path, "records.jsonl"),
                               "w")
            # human-readable per-step state dump (the reference's log.txt
            # channel, EKF.cpp:135-136 + State::showDetailed,
            # State.cpp:229-258)
            self._log = open(os.path.join(output_path, "log.txt"), "w")
            self._log.write(f"seed: {self.config.seed}\n")
            if render:
                from openekfmonoslam_tpu_torch.viz.draw import VideoSink
                self._sink = VideoSink(output_path)
            if render_debug:
                from openekfmonoslam_tpu_torch.viz.draw import VideoSink
                self._debug_sink = VideoSink(
                    os.path.join(output_path, "debug"),
                    video_name="ransacDebug.mp4")
            # the 3D map debug channel (the reference's PCL viewer,
            # Draw.h:88-100, rendered headlessly)
            if viz3d_every > 0:
                from openekfmonoslam_tpu_torch.viz.viewer3d import Map3DSink
                self._map3d = Map3DSink(output_path, every=viz3d_every)

    # ------------------------------------------------------------------
    def _upload(self, gray_np: np.ndarray) -> torch.Tensor:
        """The gray frame on the engine's device; to the card through
        pinned memory, without a host sync."""
        gray = torch.from_numpy(np.array(gray_np))
        if self.device.type == "cuda":
            return gray.pin_memory().to(self.device, non_blocking=True)
        return gray.to(self.device)

    def init(self, image: np.ndarray) -> None:
        """EKF::init (EKF.cpp:170-237)."""
        self.state = self.runtime.init_step(
            self.state, self._upload(to_gray(np.asarray(image))))

    def _summary(self, rec: StepRecord, draw: bool = False, before=None
                 ) -> tuple[np.ndarray, dict]:
        """The frame's packed summary, x_cam (13) | P_cam (169) | 7
        counters, with ``before`` (the state the step began from) then the
        step's map counts (MAP_COUNTS), then with ``draw`` the overlays'
        fields (DRAW_FIELDS), read back in one device-to-host copy.
        Returns the summary in float64 and the fields in the record's
        dtype (booleans as bool)."""
        state = self.state

        def count(mask):
            return torch.sum(mask, dtype=torch.int32)

        counts = [rec.total_matches, rec.li_inliers, rec.hi_inliers,
                  rec.n_active, rec.n_visible,
                  count(state.active & state.is_xyz),
                  count(state.active & ~state.is_xyz)]
        if before is not None:
            # a removal clears is_xyz, an addition takes a free slot, and
            # removals come before additions in the step
            added = count(rec.new_ok)
            counts += [added,
                       count(before.active) + added - count(state.active),
                       count(state.is_xyz & ~before.is_xyz)]
        parts = [rec.x_cam, rec.P_cam.reshape(-1),
                 torch.stack(counts).to(rec.x_cam.dtype)]
        if draw:
            parts += [getattr(rec, k).to(rec.x_cam.dtype).reshape(-1)
                      for k in DRAW_FIELDS]
        packed = torch.cat(parts)
        with span("read.summary"):
            host = packed.cpu().numpy()
        head = at = 13 + 169 + len(counts)
        fields = {}
        if draw:
            for k in DRAW_FIELDS:
                v = getattr(rec, k)
                n = v.numel()
                a = host[at:at + n].reshape(tuple(v.shape))
                fields[k] = a.astype(bool) if v.dtype == torch.bool else a
                at += n
        return host[:head].astype(np.float64), fields

    def step(self, image: np.ndarray) -> dict:
        """EKF::step (EKF.cpp:242-666); returns the per-frame record.  The
        call is the span ``engine.step``, tagged with the frame's index
        (spans.py); with the recorder on the record also gives the step's
        map counts, and with ``phase_timing`` its seven phases' µs."""
        timing = (spans.collect() if self.phase_timing
                  else contextlib.nullcontext())
        with timing as timed, span("engine.step", frame=self.frame_index + 1):
            return self._step(image, timed)

    def _step(self, image: np.ndarray, timed) -> dict:
        t0 = time.perf_counter()
        with span("engine.upload"):
            gray_np = to_gray(np.asarray(image))
            gray = self._upload(gray_np)
        before = self.state if spans.recording() else None
        self.state, rec = self.runtime.step(self.state, gray)
        self.frame_index += 1
        if (self.pose_graph is not None
                and self.frame_index % self.keyframe_every == 0):
            self._take_keyframe(gray)
        # no separate sync: the summary's copy waits for the step
        summary, drawn = self._summary(
            rec, draw=self._sink is not None or self._debug_sink is not None,
            before=before)
        wall_s = time.perf_counter() - t0
        relocalized = self._relocalize_if_lost(int(summary[182]), gray)

        with span("engine.record"):
            record = self._summary_to_dict(summary, wall_s)
            if before is not None:
                record["replayed"] = int(self.runtime.replayed)
            if timed is not None:
                record["phase_times_us"] = dict(zip(
                    result_reader.PHASE_KEYS, spans.phase_times_us(timed)[0]))
                record["phase_times_source"] = "measured"
            if relocalized:
                record["relocalized"] = True
            self._write(record, gray_np, drawn)
        return record

    def _relocalize_if_lost(self, total_matches: int, gray) -> bool:
        """After ``relocalize_after`` frames in a row with fewer than
        ``lost_matches_threshold`` matches, drop the map, keep the pose and
        re-bootstrap from this frame; True if it did."""
        if self.relocalize_after <= 0:
            return False
        if total_matches < self.lost_matches_threshold:
            self.lost_streak += 1
        else:
            self.lost_streak = 0
        if self.lost_streak < self.relocalize_after:
            return False
        fresh = self.runtime.make_initial_state()
        self.state = checkpoint.reset_map(self.state, fresh)
        self.state = self.runtime.init_step(self.state, gray)
        self.lost_streak = 0
        self.relocalizations += 1
        if self.pose_graph is not None:
            # immediate keyframe: the re-bootstrap scene is the
            # place-recognition query for a loop-closure edge
            self._take_keyframe(gray)
        return True

    def _write(self, record: dict, gray_np: np.ndarray, drawn: dict) -> None:
        """The record to the engine's list, files and sinks."""
        self.records.append(record)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
        if self._log:
            p, q = record["position"], record["orientation"]
            self._log.write(
                f"step {record['frame']}\n"
                f"  position: {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n"
                f"  orientation: {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} "
                f"{q[3]:.9f}\n"
                f"  matches {record['total_matches']} inliers "
                f"{record['li_inliers']}+{record['hi_inliers']} "
                f"map {record['n_active']}\n")
        if self._map3d is not None:
            # self.records already ends with this frame's record
            traj = np.asarray([r["position"] for r in self.records])
            self._map3d.maybe_write(self.frame_index, self.state, traj)
        if self._sink is not None:
            from openekfmonoslam_tpu_torch.viz.draw import (
                draw_prediction_overlay)
            self._sink.write(draw_prediction_overlay(
                gray_np, drawn["pred_uv"], drawn["pred_S"], drawn["visible"],
                drawn["z"], drawn["matched"]))
        if self._debug_sink is not None:
            from openekfmonoslam_tpu_torch.viz.draw import draw_ransac_debug
            self._debug_sink.write(draw_ransac_debug(
                gray_np, drawn["z"], drawn["matched"], drawn["inliers"],
                drawn["new_uv"], drawn["new_ok"]))

    def _take_keyframe(self, gray: torch.Tensor) -> None:
        """Snapshot a keyframe into the pose graph, then try a loop closure
        against the older keyframes (graph/loop_closure.py)."""
        node_index = self._graph_nodes
        if node_index >= self.pose_graph.capacity[0]:
            # a full graph takes no node, so no edge can reach this frame
            return
        self.pose_graph = graph_mod.add_keyframe(
            self.pose_graph, self.state.x[0:3], self.state.x[3:7],
            self._odometry_info)
        self._graph_nodes += 1
        self.keyframe_frames.append(self.frame_index)

        kf = self.loop_closer.snapshot(self.state, node_index,
                                       self.frame_index)
        closure = self.loop_closer.try_close(gray, kf)
        if closure is None:
            return
        self.pose_graph = graph_mod.add_loop_edge(
            self.pose_graph, closure["i"], closure["j"], closure["dr"],
            closure["dq"], closure["info"])
        if self._log:
            self._log.write(
                f"loop closure: keyframe {closure['i']} <- {closure['j']} "
                f"(frames {closure['frame_i']} <- {closure['frame_j']}), "
                f"{closure['matches']} matches, rms "
                f"{closure['rms_px']:.2f}px\n")

    def _require_graph(self) -> None:
        if self.pose_graph is None:
            raise RuntimeError("pose graph disabled (keyframe_every=0)")

    def _graph_poses(self) -> tuple[np.ndarray, np.ndarray]:
        k = self._graph_nodes
        return (self.pose_graph.node_r[:k].cpu().numpy().astype(np.float64),
                self.pose_graph.node_q[:k].cpu().numpy().astype(np.float64))

    def corrected_trajectory(self, iterations: int = 40) -> np.ndarray:
        """Optimise the pose graph and return the (T, 3) drift-corrected
        per-frame camera positions (raw positions moved by each nearest
        preceding keyframe's graph correction)."""
        self._require_graph()
        raw_r, raw_q = self._graph_poses()
        self.optimize_pose_graph(iterations)
        opt_r, opt_q = self._graph_poses()
        rec_r = np.asarray([r["position"] for r in self.records])
        rec_q = np.asarray([r["orientation"] for r in self.records])
        return correct_trajectory(rec_r, rec_q, self.keyframe_frames,
                                  raw_r, raw_q, opt_r, opt_q)

    def add_loop_closure(self, i: int, j: int, dr, dq, info=None) -> None:
        """Add a loop-closure edge between keyframes i and j (when the
        camera re-observes keyframe j's scene)."""
        self._require_graph()
        self.pose_graph = graph_mod.add_loop_edge(self.pose_graph, i, j, dr,
                                                  dq, info)

    def optimize_pose_graph(self, iterations: int = 10) -> np.ndarray:
        """Gauss-Newton over the keyframe graph; returns the optimised
        (K, 3) keyframe positions."""
        self._require_graph()
        self.pose_graph = graph_mod.optimize(self.pose_graph, iterations)
        return self.pose_graph.node_r[:self._graph_nodes].cpu().numpy()

    # ------------------------------------------------------------------
    @property
    def state_vector(self) -> np.ndarray:
        return self.state.x.cpu().numpy()

    @property
    def covariance(self) -> np.ndarray:
        return self.state.P.cpu().numpy()

    @property
    def camera_position(self) -> np.ndarray:
        return self.state.x[0:3].cpu().numpy()

    def _summary_to_dict(self, s: np.ndarray, wall_s: float) -> dict:
        """The per-frame record dict from the one fetched summary."""
        x = s[0:13]
        c = s[182:]
        record = {
            "frame": self.frame_index,
            "position": x[0:3].tolist(),
            "orientation": x[3:7].tolist(),
            "linear_velocity": x[7:10].tolist(),
            "angular_velocity": x[10:13].tolist(),
            "covariance_cam": s[13:182].reshape(13, 13).tolist(),
            "total_matches": int(c[0]),
            "li_inliers": int(c[1]),
            "hi_inliers": int(c[2]),
            "n_active": int(c[3]),
            "n_visible": int(c[4]),
            "n_xyz": int(c[5]),
            "n_inverse_depth": int(c[6]),
            "wall_time_s": wall_s,
        }
        if len(c) > 7:
            record.update(zip(MAP_COUNTS, map(int, c[7:10])))
        return record

    def write_output_yml(self) -> Optional[str]:
        """Reference-shaped output.yml dump (EKF.cpp:614-629 layout incl.
        phase timings and the 13x13 covariance corner)."""
        if not self.output_path:
            return None
        path = os.path.join(self.output_path, "output.yml")
        return result_reader.write_output_yml(self.records, path)

    def save_checkpoint(self, path: str) -> None:
        """Exact-resume checkpoint of the full filter carry (and of the
        pose graph, beside it)."""
        checkpoint.save_checkpoint(path, self.state)
        if self.pose_graph is not None:
            checkpoint.save_pose_graph(path + ".graph.npz", self.pose_graph)

    def resume(self, path: str) -> None:
        """Restore a checkpoint (bit-exact continuation; the capability the
        reference left unimplemented, State.cpp:364-367)."""
        self.state = checkpoint.load_checkpoint(path, like=self.state)
        self.frame_index = int(self.state.frame)
        gpath = path + ".graph.npz"
        if self.pose_graph is not None and os.path.exists(gpath):
            self.pose_graph = checkpoint.load_pose_graph(gpath, self.device)
            self._graph_nodes = int(self.pose_graph.n_nodes)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._log:
            self._log.close()
            self._log = None
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        if self._debug_sink is not None:
            self._debug_sink.close()
            self._debug_sink = None
        self.write_output_yml()


def run_sequence(engine: SlamEngine, source, max_frames: Optional[int] = None,
                 progress_every: int = 0) -> list[dict]:
    """Drive an engine over a frame source (samples/EKF/main.cpp:123-167)."""
    it = iter(source)
    first = next(it)
    engine.init(first)
    for i, frame in enumerate(it):
        if max_frames is not None and i >= max_frames:
            break
        rec = engine.step(frame)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"frame {rec['frame']}: matches={rec['total_matches']} "
                  f"inliers={rec['li_inliers']}+{rec['hi_inliers']} "
                  f"map={rec['n_active']} {rec['wall_time_s']*1e3:.1f} ms")
    return engine.records
