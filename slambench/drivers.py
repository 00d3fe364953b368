"""The entries a traffic mix drives, closed loop: ``engine`` hands each
frame to ``SlamEngine.step`` (one camera), ``batch`` hands a frame of
every stream to the batched step of ``parallel.batch_runner`` and reads
the streams' poses back.  A driver bootstraps and warms up in ``setup``,
times calls in ``window``, runs a fixed number under the profiler in
``run_steps``, and keeps what the program produced on a sample of the
calls for the reference (``collect``): ``check_frames`` calls drawn from
the seed uniformly over all calls of the window (a reservoir sample, so
the window's length need not be known), every stream of each.

A call's frames are made before its time starts (``stage``), and what
the harness reads besides the poses (match and inlier counts) is read
after the window (``settle``), so a timed call holds the entry's work and
the pose's read alone.

Keeping a frame costs no copy on the device: the program returns new
tensors each step and writes none in place, so holding the states before
and after a step keeps them as they were.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from slambench.frames import PanSource
from slambench.reference.check import Program
from slambench.trace import FRAME

STATE_FIELDS = ("x", "P", "active", "is_xyz", "times_predicted",
                "times_matched", "frame", "descriptors")
RECORD_FIELDS = ("z", "matched", "visible", "pred_uv", "pred_S", "inliers",
                 "li_inliers", "hi_inliers", "new_uv", "new_ok", "new_slot")


def slam_config(cfg: dict):
    """The program's SlamConfig from a configuration file's groups."""
    from openekfmonoslam_tpu_torch import config as c

    groups = dict(camera=c.CameraCalibration, ekf=c.EKFParams,
                  detector=c.DetectorConfig, descriptor=c.DescriptorConfig)
    names = {f.name for f in dataclasses.fields(c.SlamConfig)}
    kw = {k: v for k, v in cfg.items() if k in names and k not in groups}
    kw.update({k: cls(**cfg[k]) for k, cls in groups.items()})
    return c.SlamConfig(**kw)


def _numpy(obj, fields, index=None) -> dict:
    out = {}
    for f in fields:
        v = getattr(obj, f)
        if index is not None:
            v = v[index]
        out[f] = v.detach().cpu().numpy()
    return out


class Driver:
    batched = False        # states and records lead with a stream axis

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        h, w = traffic["frame_hw"]
        self.sources = [PanSource((seed, b), h, w, traffic["texture_period"],
                                  pan)
                        for b, pan in enumerate(traffic["pan_px"])]
        self.pick = np.random.default_rng((seed, 1 << 20))
        self.t = 0                 # the next frame's index in its stream
        self.failed = 0
        self.kept: list = []       # (t, before, after, record)
        self.offered = 0           # calls offered to the sample
        self.bootstrap: dict = {}
        self.matches: list = []
        self.inliers: list = []
        self.adds = 0              # calls on which a stream added features
        self._used: list = []      # per call: (li rows, hi rows) a stream
        self.min_matches = cfg.get("ekf", {}).get("min_matches_per_image", 0)

    def stage(self) -> None:
        """Make the next call's frames, one a stream."""
        self.staged = [s.frame(self.t) for s in self.sources]

    def settle(self) -> list:
        """Take in what the calls so far left to read; returns the rows
        each call's two updates used a stream."""
        return self._used

    def _warm_up(self, t0: float) -> None:
        """The warm-up calls after the bootstrap begun at ``t0``; notes the
        seconds of each part of the set-up in ``setup_line``."""
        t1 = time.perf_counter()
        for _ in range(self.traffic["warmup_frames"]):
            self.stage()
            self.call(None, training=True)
        self.settle()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.setup_line = (f"program and bootstrap {t1 - t0:.3f}, "
                           f"{self.traffic['warmup_frames']} warm-up calls "
                           f"{t2 - t1:.3f}")

    def _offer(self):
        """Where to keep this call's frame in the sample: its index in
        ``kept``, or None."""
        i, k = self.offered, self.traffic["check_frames"]
        self.offered += 1
        if i < k:
            return i
        j = int(self.pick.integers(0, i + 1))
        return j if j < k else None

    def _store(self, at, item) -> None:
        if at == len(self.kept):
            self.kept.append(item)
        else:
            self.kept[at] = item

    def run_steps(self, n: int):
        """``n`` calls, offered to the sample: (calls, frames of every
        stream); ``settle`` then gives the rows their updates used."""
        self._used = []
        frames = 0
        for _ in range(n):
            self.stage()
            frames += self.call(self._offer())
        return n, frames

    def collect(self) -> dict:
        """What the program produced on the bootstrap and the kept frames,
        on the host (one stream's part of a batched state)."""
        def at(v, s):
            return v[s] if self.batched else v

        b = self.bootstrap
        streams = range(len(self.sources)) if self.batched else [None]
        out = {"bootstrap": [dict(
            after=_numpy(b["after"], STATE_FIELDS, s),
            gray=np.array(self.sources[s or 0].frame(0)), stream=s or 0,
            **{k: at(b[k], s).cpu().numpy() for k in ("uv", "ok", "slot")})
            for s in streams], "frames": []}
        for t, before, after, rec in self.kept:
            for s in streams:
                r = _numpy(rec, RECORD_FIELDS, s)
                r["t"], r["stream"] = t, s or 0
                out["frames"].append(Program(
                    _numpy(before, STATE_FIELDS, s),
                    _numpy(after, STATE_FIELDS, s), r,
                    np.array(self.sources[s or 0].frame(t))))
        return out

    def health(self) -> str:
        m = np.asarray(self.matches, dtype=np.float64)
        i = np.asarray(self.inliers, dtype=np.float64)
        if not len(m):
            return "no frames"
        ok = float(np.mean(i >= 0.5 * m))
        return (f"mean matches {m.mean():.2f}, mean inliers {i.mean():.2f}, "
                f"inliers >= half the matches on {ok:.3f} of frames")

    def window(self, seconds: float) -> tuple[list, int]:
        """Calls until ``seconds`` have passed: (the seconds of each call
        that ended inside the window, frames of every stream it
        completed)."""
        samples, frames = [], 0
        gc0 = [g["collections"] for g in gc.get_stats()]
        adds0 = self.adds
        start = time.perf_counter()
        end = start + seconds
        while True:
            self.stage()
            a = time.perf_counter()
            if a >= end:
                break
            n = self.call(self._offer())
            b = time.perf_counter()
            if b > end:
                break
            samples.extend([b - a] * n)
            frames += n
        gcs = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
        self.settle()
        half = len(samples) // 2
        if half:
            print(f"window: garbage collections by generation {gcs}; calls "
                  f"that added features {self.adds - adds0}; median ms of "
                  f"the first and second half "
                  f"{np.median(samples[:half]) * 1e3:.4f}, "
                  f"{np.median(samples[half:]) * 1e3:.4f}", flush=True)
        return samples, frames


class EngineDriver(Driver):
    """One camera through ``SlamEngine.step``."""

    def setup(self) -> None:
        from openekfmonoslam_tpu_torch.engine.engine import SlamEngine

        t0 = time.perf_counter()
        self.engine = SlamEngine(slam_config(self.cfg), device=self.device)
        rt = self.engine.runtime
        cfg = self.engine.config
        self.n_state, self.n_slots = cfg.padded_state_dim, cfg.max_features
        self._keep = None
        self._used = []
        step, init = rt.step, rt.init_step_recorded

        def kept_step(state, gray):
            new, rec = step(state, gray)
            if self._keep is not None:
                self._store(self._keep, (self.t, state, new, rec))
            return new, rec

        def kept_init(state, gray):
            out = init(state, gray)
            self.bootstrap = dict(after=out[0], uv=out[1], ok=out[2],
                                  slot=out[3])
            return out

        rt.step, rt.init_step_recorded = kept_step, kept_init
        self.engine.init(self.sources[0].frame(0))
        self.t = 1
        self._warm_up(t0)

    def call(self, keep, training: bool = False) -> int:
        """One call of the entry; ``keep``: where to keep it in the
        sample, or None."""
        self._keep = keep
        with torch.profiler.record_function(FRAME):
            rec = self.engine.step(self.staged[0])
        self._keep = None
        if not all(np.isfinite(rec["position"])):
            self.failed += 1
        self.adds += rec["li_inliers"] + rec["hi_inliers"] < self.min_matches
        if not training:
            self.matches.append(rec["total_matches"])
            self.inliers.append(rec["li_inliers"] + rec["hi_inliers"])
        self._used.append([(2 * rec["li_inliers"], 2 * rec["hi_inliers"])])
        self.t += 1
        return 1

    def close(self) -> None:
        self.kept = []
        self.bootstrap = {}
        self.engine.close()
        del self.engine


class BatchDriver(Driver):
    """B cameras through one batched step a frame."""

    batched = True

    def setup(self) -> None:
        from openekfmonoslam_tpu_torch.engine.step import SlamRuntime
        from openekfmonoslam_tpu_torch.parallel import batch_runner as br

        t0 = time.perf_counter()
        cfg = slam_config(self.cfg)
        self.rt = SlamRuntime(cfg, device=self.device)
        self.n_state, self.n_slots = cfg.padded_state_dim, cfg.max_features
        B = len(self.sources)
        self.step = br.make_batched_step(self.rt)
        states = br.make_batch_states(self.rt, B)
        grays = np.stack([s.frame(0) for s in self.sources])
        self.states, uv, ok, slot = br.batched_init_recorded(self.rt, states,
                                                             grays)
        self.bootstrap = dict(after=self.states, uv=uv, ok=ok, slot=slot)
        self.t = 1
        self._used = []
        self._pending = []
        self._warm_up(t0)

    def stage(self) -> None:
        self.staged = np.stack([s.frame(self.t) for s in self.sources])

    def call(self, keep, training: bool = False) -> int:
        with torch.profiler.record_function(FRAME):
            before = self.states
            self.states, rec = self.step(self.states, self.staged)
            pose = rec.x_cam.cpu().numpy()
        if keep is not None:
            self._store(keep, (self.t, before, self.states, rec))
        self.failed += int((~np.isfinite(pose).all(1)).sum())
        self._pending.append((rec.total_matches, rec.li_inliers,
                              rec.hi_inliers, training))
        self.t += 1
        return len(self.sources)

    def settle(self) -> list:
        if self._pending:
            m, li, hi = (torch.stack([c[i] for c in self._pending]).cpu()
                         .numpy().astype(np.int64) for i in range(3))
            for k, (_, _, _, training) in enumerate(self._pending):
                self.adds += bool((li[k] + hi[k] < self.min_matches).any())
                if not training:
                    self.matches.extend(m[k].tolist())
                    self.inliers.extend((li[k] + hi[k]).tolist())
                self._used.append([(2 * int(a), 2 * int(c))
                                   for a, c in zip(li[k], hi[k])])
            self._pending = []
        return self._used

    def close(self) -> None:
        self.kept = []
        self.bootstrap = {}
        del self.states, self.step, self.rt


def make(entry: str, cfg: dict, traffic: dict, seed: int, device="cuda"):
    kinds = {"engine": EngineDriver, "batch": BatchDriver}
    if entry not in kinds:
        raise ValueError(f"unknown entry {entry!r}; known: {sorted(kinds)}")
    return kinds[entry](cfg, traffic, seed, device)
