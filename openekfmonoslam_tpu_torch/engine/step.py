"""The per-frame SLAM step (port of engine/step.py).

``SlamRuntime.step`` is EKF::step (EKF.cpp:242-666): predict, measurement
prediction, detection and description inside the gate ellipses (the
configured front end, vision/frontend.py), gated 2-NN matching with subpixel refinement, 1-point RANSAC,
low-innovation update, re-prediction + chi2 rescue, high-innovation update
and map management with new-feature detection.  ``init_step`` is EKF::init
(EKF.cpp:170-237).  ``step_injected`` is the reference's HandMatching
replay (HandMatching.cpp:37-99): the same filter on externally supplied
per-slot matches.

On the GPU a live frame runs up to six kinds of hand-written kernel:
predict, measure x2, STAR (the STAR detector), BRIEF (the BRIEF
descriptor), joint update x2, and init on frames that add features.  The
NCC matcher (``matcher="ncc"``, PATCH descriptors) replaces detection and
descriptor matching by patch correlation (PyTorch's convolutions).  Every ``lax.cond`` of the JAX step around rare state surgery is
computed masked and selected on the device.  The one exception is new-
feature detection (``phase_mapman``): the step reads (add?, needed) back
once a frame, skips detection on frames that need nothing, as the JAX
``cond`` does, and otherwise runs exactly ``min(needed, C)`` zone picks.
``step_injected`` reads nothing back.  Everything before that read
(``SlamRuntime.prefix``) is, on a single-device CUDA runtime, one CUDA
graph, captured on a key's second call and replayed after
(engine/step_graph.py); detection and addition stay eager.

The parity mode (``config.reference_quirks``, with
``config.ransac_parity_visit``) runs the reference's bug-compatible
filter, as the JAX package does: the quirks variant of the measure kernel,
the DELTA deadband (so every update takes the chain, and its S^-1 is the
S-inverse kernel on the card), the insertion-order RANSAC visit with the
adaptive visit bound, and the insertion-order conversion scan.  The order
keys are ``state.birth``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from openekfmonoslam_tpu_torch import spans
from openekfmonoslam_tpu_torch.config import SlamConfig
from openekfmonoslam_tpu_torch.core.camera import Camera
from openekfmonoslam_tpu_torch.engine import step_graph
from openekfmonoslam_tpu_torch.filter import features as feat_mod
from openekfmonoslam_tpu_torch.filter import mapman
from openekfmonoslam_tpu_torch.filter import measure as meas_mod
from openekfmonoslam_tpu_torch.filter import predict as pred_mod
from openekfmonoslam_tpu_torch.filter import ransac as ransac_mod
from openekfmonoslam_tpu_torch.filter import update as upd_mod
from openekfmonoslam_tpu_torch.filter.state import SlamState, make_initial_state
from openekfmonoslam_tpu_torch.spans import span
from openekfmonoslam_tpu_torch.vision import detect, fast, matching, ncc
from openekfmonoslam_tpu_torch.vision.frontend import (Frontend,
                                                       check_matcher,
                                                       make_frontend)

# span name prefixes of step_injected's and step's phases (spans.py)
PHASE_PREFIX = "step_injected."
LIVE_PHASE_PREFIX = "step."


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


class Prefix(NamedTuple):
    """What ``SlamRuntime.prefix`` hands to ``phase_mapman``."""

    state: SlamState             # after the conversion
    record: StepRecord           # with nothing added; x_cam, P_cam None
    ask: torch.Tensor            # (2,) int32: add?, needed
    pred: meas_mod.Prediction    # the frame-start prediction
    aux: dict                    # the front end's maps
    in_ellipse: torch.Tensor     # (H, W) bool: inside a gate ellipse


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or the first CUDA device; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda", 0)


class SlamRuntime:
    """Static per-run context: config scalars, camera, device, dtype."""

    # the step's prefix runs as a CUDA graph on the card (``_step_mode``)
    step_graphs = True

    def __init__(self, config: SlamConfig, device=None):
        check_matcher(config)
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
        # bug-compatible mode: quirky H chain, DELTA deadband,
        # insertion-order RANSAC visit and conversion scan
        self.quirks = bool(config.reference_quirks)
        ekf = config.ekf
        self.gate = (config.gate_scale ** 2) * config.chi2_95_2
        self.exclusion_radius = config.gate_scale * math.sqrt(
            ekf.detect_new_features_image_mask_ellipse_size
            * config.chi2_95_2)
        self.zones_in_a_row = int(
            2 ** ekf.detect_new_features_image_areas_divide_times)
        self._frontend: Frontend | None = None
        self._border_masks: dict = {}
        self._graphs = step_graph.StepGraphs()
        self.replayed = False       # the last step ran the prefix's graph

    @property
    def frontend(self) -> Frontend:
        """The vision front end, built at the first live call (the replay
        path runs without one)."""
        if self._frontend is None:
            self._frontend = make_frontend(self.config, self.device)
        return self._frontend

    def make_initial_state(self) -> SlamState:
        return make_initial_state(self.config, self.dtype, self.device)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _border_mask(self, shape) -> torch.Tensor:
        """(H, W) bool: pixels at least ``frontend.border`` from the edge."""
        shape = tuple(shape)
        if shape not in self._border_masks:
            h, w = shape
            m = self.frontend.border
            ys = torch.arange(h, device=self.device)[:, None]
            xs = torch.arange(w, device=self.device)[None, :]
            self._border_masks[shape] = ((ys >= m) & (ys < h - m)
                                         & (xs >= m) & (xs < w - m))
        return self._border_masks[shape]

    # ------------------------------------------------------------------
    def init_step(self, state: SlamState, gray) -> SlamState:
        """EKF::init (EKF.cpp:170-237): detect MinMatchesPerImage features
        zone-balanced over the whole image and add them to the map."""
        return self.init_step_recorded(state, gray)[0]

    def init_step_recorded(self, state: SlamState, gray):
        """init_step returning (state, uv, ok, slot) of the features added
        -- the bootstrap entry of the replay injection log."""
        cfg = self.config
        gray = self._tensor(gray)
        aux = self.frontend.precompute(gray)
        kps = fast.detect_keypoints(aux["score_nms"],
                                    self._border_mask(gray.shape),
                                    cfg.max_keypoints)
        kp_xy = torch.stack([kps.yx[:, 1], kps.yx[:, 0]], dim=-1)
        dev = self.device
        needed = cfg.ekf.min_matches_per_image
        picked = detect.select_zone_balanced(
            kp_xy.to(torch.float32), kps.score, kps.valid,
            torch.zeros((1, 2), dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev),
            max(needed, 0), self.exclusion_radius, self.zones_in_a_row,
            gray.shape[1], gray.shape[0], max_new=cfg.max_features)
        desc = self.frontend.describe(aux, kps.yx[picked.kp_index])
        uv = picked.uv.to(self.dtype)
        slots, ok = feat_mod.assign_slots(state.active, picked.valid)
        state = self.add_features(state, uv, desc, picked.valid)
        return state, uv, ok, slots

    # -- the pieces that touch P; parallel/sharding.py's ShardedRuntime
    # -- overrides each with its form on a tile of P --

    def predict_filter(self, state: SlamState) -> SlamState:
        """x[0:13] and P advanced by the motion model."""
        return pred_mod.predict(state, self.config)

    def predict_measurements(self, state: SlamState) -> meas_mod.Prediction:
        """h, H, H P and H P H^T of every slot."""
        return meas_mod.predict_measurements(state, self.camera,
                                             quirks=self.quirks,
                                             hp_layout=self.hp_layout)

    def update_filter(self, state: SlamState, pred, z, use) -> SlamState:
        """The joint update over the ``use`` slots."""
        return upd_mod.update(state, pred, z, use,
                              self.config.camera.pixel_error_x,
                              deadband=self.quirks)

    def remove_features(self, state: SlamState, remove) -> SlamState:
        return mapman.remove_features(state, remove)

    def convert_feature(self, state: SlamState, enable) -> SlamState:
        """At most one inverse-depth slot converted to XYZ, where
        ``enable``; the parity mode scans in insertion order."""
        return mapman.convert_one_to_xyz(
            state, self.config.ekf.inverse_depth_linearity_index_threshold,
            enable=enable, order_key=state.birth if self.quirks else None)

    def add_features(self, state: SlamState, uv, desc, valid) -> SlamState:
        return feat_mod.add_features(state, self.camera, self.config, uv,
                                     desc, valid)

    def camera_covariance(self, state: SlamState) -> torch.Tensor:
        """P[:13, :13], the record's camera block."""
        return state.P[:13, :13]

    # -- the reference phases, each a separate method (EKF.cpp:255-618) --

    def phase_predict(self, state: SlamState):
        """[1] predict + measurement prediction (EKF.cpp:273-292)."""
        state = state._replace(frame=state.frame + 1)
        state = self.predict_filter(state)
        return state, self.predict_measurements(state)

    def phase_match(self, state: SlamState, pred, gray: torch.Tensor):
        """[2] guided matching (EKF.cpp:330-345): front-end precompute,
        gate-region mask, then detection, gated 2-NN and subpixel
        refinement, or the detection-free NCC search (vision/ncc.py)."""
        cfg = self.config
        with span("match.precompute"):
            aux = self.frontend.precompute(gray)
        with span("match.gate"):
            in_ellipse = matching.ellipse_union_mask(
                tuple(gray.shape), pred.uv, pred.S, pred.visible, self.gate)
        if cfg.matcher == "ncc":
            with span("match.ncc"):
                return self.match_ncc(state, pred, aux), aux, in_ellipse
        with span("match.detect"):
            kps = fast.detect_keypoints(
                aux["score_nms"], in_ellipse & self._border_mask(gray.shape),
                cfg.max_keypoints)
        with span("match.describe"):
            kp_xy = torch.stack([kps.yx[:, 1], kps.yx[:, 0]],
                                dim=-1).to(self.dtype)
            kp_desc = self.frontend.describe(aux, kps.yx)
        with span("match.nn"):
            m = matching.match_predictions(
                pred.uv, pred.S, pred.visible, state.descriptors, kp_xy,
                kps.valid, kp_desc, self.gate,
                cfg.ekf.matching_comp_coef_second_best_vs_first,
                distance_fn=self.frontend.distance)
        if cfg.subpixel_matches:
            with span("match.subpixel"):
                m = m._replace(z=fast.subpixel_refine(
                    aux["score_raw"].to(self.dtype), m.z, m.matched))
        return m, aux, in_ellipse

    def match_ncc(self, state: SlamState, pred, aux) -> matching.Matches:
        """Correlate each landmark's stored patch over its gate region,
        with and without the homography-warped template when
        ``ncc_warp``."""
        cfg = self.config
        pr = cfg.descriptor.patch_radius
        corr_patches = None
        if cfg.ncc_warp:
            cam = self.camera
            corr_patches = ncc.warp_templates(
                state.descriptors, state.patch_pose, state.features,
                state.is_xyz, state.x[:7], pred.uv, pred.visible,
                cam.fx, cam.fy, cam.cx, cam.cy, pr)
        return ncc.ncc_match(
            aux["smoothed"], pred.uv, pred.S, pred.visible,
            state.descriptors, self.gate, pr, cfg.ncc_search_radius,
            cfg.ncc_min_corr, refresh_below=cfg.ncc_refresh_below,
            corr_patches=corr_patches)

    def phase_ransac(self, state: SlamState, pred, m):
        """[3] 1-point RANSAC (EKF.cpp:400-417)."""
        cfg = self.config
        return ransac_mod.ransac(
            state, pred, m.z, m.matched, self.camera,
            cfg.ekf.ransac_threshold_predict_distance,
            cfg.ekf.ransac_all_inliers_probability,
            cfg.camera.pixel_error_x, cfg.max_hypotheses,
            cfg.ransac_parity_visit,
            visit_key=state.birth if self.quirks else None,
            deadband=self.quirks)

    def phase_update_li(self, state: SlamState, pred, m, inliers):
        """[4] low-innovation joint update (EKF.cpp:423-437)."""
        return self.update_filter(state, pred, m.z, inliers)

    def phase_rescue(self, state: SlamState, m, outliers):
        """[5] re-predict + chi2 outlier rescue (EKF.cpp:443-517)."""
        pred2 = self.predict_measurements(state)
        rescued = ransac_mod.rescue_outliers(
            pred2, m.z, outliers, self.config.ekf.ransac_chi2_threshold)
        return pred2, rescued

    def phase_update_hi(self, state: SlamState, pred2, m, rescued):
        """[6] high-innovation joint update (EKF.cpp:522-540)."""
        return self.update_filter(state, pred2, m.z, rescued)

    def mapman_maintain(self, state: SlamState, pred, m, inliers_all):
        """Counters plus the bad-ratio and unseen-pressure culls
        (MapManagement.cpp:74-307, EKF.cpp:567-586).  Returns (state,
        do_mm, needed), the last two 0-dim tensors on the device."""
        with span("mapman.maintain"):
            ekf = self.config.ekf
            state = mapman.update_counters(state, pred.visible, inliers_all,
                                           m.desc, m.refreshed)
            freq = ekf.map_management_frequency
            do_mm = (state.frame % max(freq, 1) == 0) & (freq > 0)
            needed = ekf.min_matches_per_image - torch.sum(
                inliers_all, dtype=torch.int32)
            bad = mapman.bad_feature_mask(state,
                                          ekf.good_feature_matching_percent)
            state = self.remove_features(state, bad & do_mm)
            pressure = mapman.map_pressure(
                state, needed, ekf.always_remove_unseen_map_features,
                ekf.max_map_features_count, ekf.max_map_size)
            unseen = state.active & ~pred.visible
            state = self.remove_features(state, unseen & pressure & do_mm)
            return state, do_mm, needed

    def detect_candidates(self, state: SlamState, pred, aux, in_ellipse,
                          n_iter: int, limit: torch.Tensor | None = None):
        """New-feature detection, zone balancing and description away from
        the frame-start ellipses (DetectNewImageFeatures.cpp:323-419), with
        ``n_iter`` zone picks, and at most ``limit`` (a 0-dim tensor, the
        batched step's per-stream count) when given.  Returns (uv (C, 2)
        float32, desc (C, W), valid (C,))."""
        with span("mapman.detect"):
            cfg = self.config
            h, w = aux["score_nms"].shape
            out_mask = ~in_ellipse & self._border_mask((h, w))
            kps2 = fast.detect_keypoints(aux["score_nms"], out_mask,
                                         cfg.max_keypoints)
            kp2_xy = torch.stack([kps2.yx[:, 1], kps2.yx[:, 0]],
                                 dim=-1).to(torch.float32)
            picked = detect.select_zone_balanced(
                kp2_xy, kps2.score, kps2.valid, pred.uv.to(torch.float32),
                pred.visible, n_iter, self.exclusion_radius,
                self.zones_in_a_row, w, h, max_new=cfg.max_features,
                limit=limit)
            new_desc = self.frontend.describe(aux, kps2.yx[picked.kp_index])
            return picked.uv, new_desc, picked.valid

    def phase_mapman(self, prefix: Prefix
                     ) -> tuple[SlamState, StepRecord]:
        """[7] map management's new-feature detection and addition
        (EKF.cpp:597-612), after ``prefix``'s counters, culls and
        conversion.  Returns the step's (state, record).

        The host reads (add?, needed) back here, the step's one sync: a
        frame that needs no new feature skips detection and addition, as
        the JAX ``cond`` does; one that does runs min(needed, C) picks."""
        state, rec = prefix.state, prefix.record
        with span("read.add"):
            add, n_needed = prefix.ask.tolist()
        if add:
            cand_uv, cand_desc, cand_valid = self.detect_candidates(
                state, prefix.pred, prefix.aux, prefix.in_ellipse,
                min(n_needed, self.config.max_features))
            with span("mapman.add"):
                cand_uv = cand_uv.to(self.dtype)
                new_slot, new_ok = feat_mod.assign_slots(state.active,
                                                         cand_valid)
                state = self.add_features(state, cand_uv, cand_desc,
                                          cand_valid)
            rec = rec._replace(
                n_active=torch.sum(state.active, dtype=torch.int32),
                new_uv=cand_uv, new_ok=new_ok, new_slot=new_slot)
        return state, rec._replace(x_cam=state.x[:13],
                                   P_cam=self.camera_covariance(state))

    def prefix(self, state: SlamState, gray: torch.Tensor,
               mapman: contextlib.ExitStack) -> Prefix:
        """The step up to the read of ``phase_mapman``: predict .. the
        high-innovation update, then map management's counters, culls and
        conversion.  No host sync, and shapes fixed by the configuration:
        on the card it is the step's CUDA graph (engine/step_graph.py).
        Enters ``step.mapman`` on ``mapman``, which the caller closes after
        ``phase_mapman``."""
        with span("step.predict"):
            state, pred = self.phase_predict(state)
        with span("step.match"):
            m, aux, in_ellipse = self.phase_match(state, pred, gray)
        with span("step.ransac"):
            res = self.phase_ransac(state, pred, m)
        with span("step.update_li"):
            state = self.phase_update_li(state, pred, m, res.inliers)
        with span("step.rescue"):
            pred2, rescued = self.phase_rescue(state, m, res.outliers)
        with span("step.update_hi"):
            state = self.phase_update_hi(state, pred2, m, rescued)
        mapman.enter_context(span("step.mapman"))
        state, do_mm, needed = self.mapman_maintain(state, pred, m,
                                                    res.inliers | rescued)
        with span("mapman.convert"):
            state = self.convert_feature(state, do_mm)
        ask = torch.stack([(do_mm & (needed > 0)).to(torch.int32), needed])
        C, F, dev = self.config.max_features, state.n_features, self.device
        record = self.record_fields(
            state, pred, m, res, rescued,
            torch.zeros((C, 2), dtype=self.dtype, device=dev),
            torch.zeros((C,), dtype=torch.bool, device=dev),
            torch.full((C,), F, dtype=torch.int32, device=dev))
        return Prefix(state, record, ask, pred, aux, in_ellipse)

    def _prefix_alone(self, state: SlamState, gray: torch.Tensor
                      ) -> Prefix:
        """``prefix`` with its ``step.mapman`` closed at once: the form a
        graph captures."""
        with contextlib.ExitStack() as mapman:
            return self.prefix(state, gray, mapman)

    def _step_mode(self, state: SlamState, gray: torch.Tensor):
        """(mode, key): "eager", or "capture" / "replay" of the prefix's
        graph of ``key``.  Eager on the CPU, on a runtime whose class sets
        ``step_graphs`` False, while this thread collects spans (the
        phases' µs were asked for) and on a key's first call."""
        if (not self.step_graphs or self.device.type != "cuda"
                or spans.collecting()):
            return "eager", None
        key = step_graph.step_key(state, gray)
        return self._graphs.mode(key), key

    def step(self, state: SlamState, gray) -> tuple[SlamState, StepRecord]:
        """One full frame (EKF::step, EKF.cpp:242-666).  Eagerly, each
        phase is a ``step.<phase>`` span (spans.py); by the graph
        (``_step_mode``), ``step.replay`` holds the prefix and
        ``step.mapman`` the read and the additions."""
        gray = self._tensor(gray)
        mode, key = self._step_mode(state, gray)
        self.replayed = mode != "eager"
        with contextlib.ExitStack() as mapman:
            if mode == "eager":
                prefix = self.prefix(state, gray, mapman)
            else:
                with span("step.replay"):
                    prefix = self._graphs.run(mode, key, self._prefix_alone,
                                              state, gray)
                mapman.enter_context(span("step.mapman"))
            return self.phase_mapman(prefix)

    def record_fields(self, state: SlamState, pred, m, res, rescued,
                      new_uv, new_ok, new_slot) -> StepRecord:
        """A StepRecord from the phase outputs, without the camera's
        ``x_cam`` and ``P_cam`` (None)."""
        def count(mask):
            return torch.sum(mask, dtype=torch.int32)

        return StepRecord(
            x_cam=None,
            P_cam=None,
            total_matches=count(m.matched),
            li_inliers=count(res.inliers),
            hi_inliers=count(rescued),
            n_active=count(state.active),
            n_visible=count(pred.visible),
            pred_uv=pred.uv,
            pred_S=pred.S,
            visible=pred.visible,
            z=m.z,
            matched=m.matched,
            inliers=res.inliers | rescued,
            new_uv=new_uv,
            new_ok=new_ok,
            new_slot=new_slot,
        )

    def make_record(self, state: SlamState, pred, m, res, rescued,
                    new_uv, new_ok, new_slot) -> StepRecord:
        """A StepRecord from the phase outputs."""
        return self.record_fields(
            state, pred, m, res, rescued, new_uv, new_ok, new_slot
        )._replace(x_cam=state.x[:13], P_cam=self.camera_covariance(state))

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

        with span("step_injected.predict"):
            state = state._replace(frame=state.frame + 1)
            state = pred_mod.predict(state, cfg)
        with span("step_injected.measure"):
            pred = meas_mod.predict_measurements(state, cam,
                                                 quirks=self.quirks,
                                                 hp_layout=self.hp_layout)
            matched = matched & pred.visible
        with span("step_injected.ransac"):
            res = ransac_mod.ransac(
                state, pred, z, matched, cam,
                ekf.ransac_threshold_predict_distance,
                ekf.ransac_all_inliers_probability, pixel_error,
                cfg.max_hypotheses, cfg.ransac_parity_visit,
                visit_key=state.birth if self.quirks else None,
                deadband=self.quirks)
        with span("step_injected.update_li"):
            state = upd_mod.update(state, pred, z, res.inliers, pixel_error,
                                   deadband=self.quirks)
        with span("step_injected.rescue"):
            pred2 = meas_mod.predict_measurements(state, cam,
                                                  quirks=self.quirks,
                                                  hp_layout=self.hp_layout)
            rescued = ransac_mod.rescue_outliers(
                pred2, z, res.outliers, ekf.ransac_chi2_threshold)
        with span("step_injected.update_hi"):
            state = upd_mod.update(state, pred2, z, rescued, pixel_error,
                                   deadband=self.quirks)
            inliers_all = res.inliers | rescued

        # map management mirrors the live pipeline (EKF.cpp:567-612):
        # counters every frame; cull/convert under the frequency gate
        with span("step_injected.mapman"):
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
                enable=do_mm,
                order_key=state.birth if self.quirks else None)

        F = state.n_features
        C = cfg.max_features
        dev = self.device
        rec_uv = torch.zeros((C, 2), dtype=self.dtype, device=dev)
        rec_ok = torch.zeros((C,), dtype=torch.bool, device=dev)
        rec_slot = torch.full((C,), F, dtype=torch.int32, device=dev)
        if new_uv is not None:
            with span("step_injected.add"):
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
