"""The per-frame SLAM step (port of engine/step.py; filter replay path).

``SlamRuntime.step_injected`` is the reference's HandMatching replay
(HandMatching.cpp:37-99): predict, measurement prediction, 1-point RANSAC,
low-innovation update, re-prediction + chi2 rescue, high-innovation update
and map management, on externally supplied per-slot matches.  The live
``step``/``init_step`` need the vision front end, which is the next slice
of the port.

On the GPU every frame runs four kinds of hand-written kernel (predict,
measure x2, joint update x2, init) and no host synchronisation: every
branch of the JAX step (``lax.cond`` around the add and conversion paths)
is computed masked and selected on the device, so a frame is queued
without waiting for the previous one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter import mapman
from openekfmonoslam_tpu_torch.filter import measure as meas_mod
from openekfmonoslam_tpu_torch.filter import predict as pred_mod
from openekfmonoslam_tpu_torch.filter import ransac as ransac_mod
from openekfmonoslam_tpu_torch.filter import update as upd_mod
from openekfmonoslam_tpu_torch.filter.state import SlamState, make_initial_state

_NEXT_SLICE = "vision front end: next slice"
PHASE_PREFIX = "step_injected."


class StepRecord(NamedTuple):
    """Per-frame observables (the output.yml record, EKF.cpp:405-628)."""

    x_cam: torch.Tensor          # (13,) camera state
    P_cam: torch.Tensor          # (13, 13) camera covariance corner
    total_matches: torch.Tensor  # () int32
    li_inliers: torch.Tensor     # () int32 low-innovation inliers
    hi_inliers: torch.Tensor     # () int32 rescued (high-innovation)
    n_active: torch.Tensor       # () int32 live landmarks
    n_visible: torch.Tensor      # () int32 predicted-visible landmarks
    pred_uv: torch.Tensor        # (F, 2) predicted pixels
    pred_S: torch.Tensor         # (F, 2, 2) innovation covariances
    visible: torch.Tensor        # (F,) bool
    z: torch.Tensor              # (F, 2) matched pixels
    matched: torch.Tensor        # (F,) bool
    inliers: torch.Tensor        # (F,) bool (low + high innovation)
    new_uv: torch.Tensor         # (C, 2) candidate pixels
    new_ok: torch.Tensor         # (C,) bool: actually added
    new_slot: torch.Tensor       # (C,) int32 slot id (F = dropped)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or the first CUDA device; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda", 0)


def _phase(name: str) -> torch.profiler.record_function:
    """A profiler range around one phase of ``step_injected``; it records
    nothing unless ``torch.profiler`` is on (tools/profile_torch_replay.py
    and chip_smoke.py read the ranges by their ``PHASE_PREFIX``)."""
    return torch.profiler.record_function(PHASE_PREFIX + name)


class SlamRuntime:
    """Static per-run context: config scalars, camera, device, dtype."""

    def __init__(self, config: SlamConfig, device=None):
        if config.reference_quirks:
            raise NotImplementedError("reference_quirks mode is not ported")
        if config.ransac_parity_visit:
            raise NotImplementedError("ransac_parity_visit is not ported")
        self.config = config
        self.device = resolve_device(device)
        self.dtype = (torch.float64 if config.dtype == "float64"
                      else torch.float32)
        self.camera = Camera.from_calibration(config.camera)
        # the covariance algebra outside the kernels (H P products, the
        # add-path placement, RANSAC) must stay true fp32: single-pass
        # reduced precision loses P's positive-definiteness within ~50
        # frames
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.hp_layout = config.hp_layout

    def make_initial_state(self) -> SlamState:
        return make_initial_state(self.config, self.dtype, self.device)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def init_step(self, state, gray):
        raise NotImplementedError(_NEXT_SLICE)

    def step(self, state, gray):
        raise NotImplementedError(_NEXT_SLICE)

    def step_injected(self, state: SlamState, z, matched, new_uv=None,
                      new_desc=None, new_valid=None, new_slot=None
                      ) -> tuple[SlamState, StepRecord]:
        """The filter pipeline with injected per-slot measurements.

        ``z`` (F, 2) measured pixels for the ``matched`` (F,) slots;
        optional new-feature candidates ``new_uv`` (C, 2) with
        ``new_valid`` are added afterwards, into ``new_slot`` when given
        (the recorder's slot ids) or the lowest free slots otherwise."""
        cfg = self.config
        ekf = cfg.ekf
        cam = self.camera
        pixel_error = cfg.camera.pixel_error_x
        z = self._tensor(z, self.dtype)
        matched = self._tensor(matched, torch.bool)

        with _phase("predict"):
            state = state._replace(frame=state.frame + 1)
            state = pred_mod.predict(state, cfg)
        with _phase("measure"):
            pred = meas_mod.predict_measurements(state, cam,
                                                 hp_layout=self.hp_layout)
            matched = matched & pred.visible
        with _phase("ransac"):
            res = ransac_mod.ransac(
                state, pred, z, matched, cam,
                ekf.ransac_threshold_predict_distance,
                ekf.ransac_all_inliers_probability, pixel_error,
                cfg.max_hypotheses)
        with _phase("update_li"):
            state = upd_mod.update(state, pred, z, res.inliers, pixel_error)
        with _phase("rescue"):
            pred2 = meas_mod.predict_measurements(state, cam,
                                                  hp_layout=self.hp_layout)
            rescued = ransac_mod.rescue_outliers(
                pred2, z, res.outliers, ekf.ransac_chi2_threshold)
        with _phase("update_hi"):
            state = upd_mod.update(state, pred2, z, rescued, pixel_error)
            inliers_all = res.inliers | rescued

        # map management mirrors the live pipeline (EKF.cpp:567-612):
        # counters every frame; cull/convert under the frequency gate
        with _phase("mapman"):
            state = mapman.update_counters(state, pred.visible, inliers_all,
                                           state.descriptors)
            freq = ekf.map_management_frequency
            do_mm = (state.frame % max(freq, 1) == 0) & (freq > 0)
            needed = ekf.min_matches_per_image - torch.sum(
                inliers_all, dtype=torch.int32)

            bad = mapman.bad_feature_mask(state,
                                          ekf.good_feature_matching_percent)
            state = mapman.remove_features(state, bad & do_mm)
            pressure = mapman.map_pressure(
                state, needed, ekf.always_remove_unseen_map_features,
                ekf.max_map_features_count, ekf.max_map_size)
            unseen = state.active & ~pred.visible
            state = mapman.remove_features(state, unseen & pressure & do_mm)
            state = mapman.convert_one_to_xyz(
                state, ekf.inverse_depth_linearity_index_threshold,
                enable=do_mm)

        F = state.n_features
        C = cfg.max_features
        dev = self.device
        rec_uv = torch.zeros((C, 2), dtype=self.dtype, device=dev)
        rec_ok = torch.zeros((C,), dtype=torch.bool, device=dev)
        rec_slot = torch.full((C,), F, dtype=torch.int32, device=dev)
        if new_uv is not None:
            with _phase("add"):
                new_uv = self._tensor(new_uv, self.dtype)
                n_new = new_uv.shape[0]
                if new_desc is None:
                    new_desc = torch.zeros(
                        (n_new,) + tuple(state.descriptors.shape[1:]),
                        dtype=state.descriptors.dtype, device=dev)
                else:
                    new_desc = self._tensor(new_desc)
                # the live path adds only when map management ran and the
                # inlier count fell short (EKF.cpp:597-611)
                new_valid = self._tensor(new_valid, torch.bool) & do_mm & (
                    needed > 0)
                if new_slot is not None:
                    new_slot = self._tensor(new_slot, torch.int32)
                    new_ok = new_valid
                    state = feat_mod.add_features_at(
                        state, cam, cfg, new_uv, new_desc, new_slot, new_valid)
                else:
                    new_slot, new_ok = feat_mod.assign_slots(state.active,
                                                             new_valid)
                    state = feat_mod.add_features(
                        state, cam, cfg, new_uv, new_desc, new_valid)
                rec_uv[:n_new] = new_uv
                rec_ok[:n_new] = new_ok
                rec_slot[:n_new] = new_slot

        def count(mask):
            return torch.sum(mask, dtype=torch.int32)

        record = StepRecord(
            x_cam=state.x[:13],
            P_cam=state.P[:13, :13],
            total_matches=count(matched),
            li_inliers=count(res.inliers),
            hi_inliers=count(rescued),
            n_active=count(state.active),
            n_visible=count(pred.visible),
            pred_uv=pred.uv,
            pred_S=pred.S,
            visible=pred.visible,
            z=z,
            matched=matched,
            inliers=inliers_all,
            new_uv=rec_uv,
            new_ok=rec_ok,
            new_slot=rec_slot,
        )
        return state, record
