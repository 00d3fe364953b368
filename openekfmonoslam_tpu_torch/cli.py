"""Command-line app of the port: the samples/EKF/main.cpp equivalent.

    python -m openekfmonoslam_tpu_torch.cli CONFIG SOURCE [OUTPUT] [options]

SOURCE is a directory of %05d-numbered PNG frames (FileSequenceImage
Generator semantics, main.cpp:50), a video file, or ``camera[:N]`` for a
live capture device.  Runs EKF init + step over the sequence (main.cpp:
123-167), writes records.jsonl, log.txt and output.yml (+ rendered
overlays with --render and --render-debug, 3D map views with --viz3d),
and emits the resultReader MATLAB report.  It runs on the first CUDA device; ``--device
cpu`` runs the plain versions on the CPU.

Modes:
  --mode interactive   one step call per frame (default; live sources)
  --mode scan          frames uploaded to the device once, then stepped
                       (engine/scan_runner.py; file sequences only)
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time


def build_source(spec: str, begin: int, end: int,
                 realtime_fps: float = 0.0):
    from openekfmonoslam_tpu_torch.io import native_loader
    from openekfmonoslam_tpu_torch.io.sources import (
        CameraSource,
        FileSequenceOnDemandSource,
        FileSequenceSource,
        VideoFileSource,
    )

    if spec.startswith("camera"):
        dev = int(spec.split(":")[1]) if ":" in spec else 0
        return CameraSource(dev)
    if os.path.isdir(spec):
        if realtime_fps > 0:
            # real-time simulation: frames skip with the wall clock
            # (FileSequenceOnDemandImageGenerator semantics)
            return FileSequenceOnDemandSource(spec, begin, end,
                                              frame_rate=realtime_fps)
        if native_loader.available():
            paths = native_loader.file_sequence_paths(spec, begin, end)
            paths = [p for p in paths if os.path.exists(p)]
            if paths:
                return native_loader.NativeFrameLoader(paths)
        return FileSequenceSource(spec, begin, end)
    return VideoFileSource(spec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="reference-format YML config file")
    ap.add_argument("source", help="frame directory / video file / camera[:N]")
    ap.add_argument("output", nargs="?", default=None,
                    help="output directory (records, output.yml, report)")
    ap.add_argument("--begin", type=int, default=1)
    ap.add_argument("--end", type=int, default=99999)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--mode", choices=("interactive", "scan"),
                    default="interactive")
    ap.add_argument("--render", action="store_true",
                    help="write overlay PNGs + video (EKF.cpp:294-305)")
    ap.add_argument("--render-debug", action="store_true",
                    help="write RANSAC inlier/outlier + new-feature debug "
                         "overlays to OUTPUT/debug (DEBUG_SHOW_RANSAC_INFO"
                         "/DEBUG_SHOW_NEW_FEATURES, EKF.cpp:198-222,542-544)")
    ap.add_argument("--max-features", type=int, default=None)
    ap.add_argument("--matcher", choices=("descriptor", "ncc"), default=None,
                    help="guided-matching backend: detected-keypoint "
                         "descriptors (reference Matching.cpp) or NCC "
                         "patch correlation (Davison active search, PATCH "
                         "descriptors)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save an exact-resume checkpoint to "
                         "OUTPUT/checkpoint.npz every N frames")
    ap.add_argument("--resume", default=None,
                    help="restore a checkpoint before processing "
                         "(frames should continue where the saved run left "
                         "off)")
    ap.add_argument("--realtime", type=float, default=0.0, metavar="FPS",
                    help="treat the frame directory as a live source at "
                         "FPS: skip frames by wall-clock time "
                         "(FileSequenceOnDemandImageGenerator)")
    ap.add_argument("--progress", type=int, default=30)
    ap.add_argument("--phase-timing", action="store_true",
                    help="emit the reference's 7-phase per-frame timings "
                         "(EKF.cpp:255-618) into records/output.yml: each "
                         "frame's phase spans on the host's clock, with no "
                         "device sync between phases")
    ap.add_argument("--keyframe-every", type=int, default=0,
                    help="enable the keyframe pose-graph layer: snapshot "
                         "a keyframe every N frames; loop closures are "
                         "detected on keyframes and the optimized "
                         "trajectory is exported to OUTPUT")
    ap.add_argument("--relocalize-after", type=int, default=0,
                    help="auto map-reset after N consecutive lost frames")
    ap.add_argument("--viz3d", type=int, default=0, metavar="N",
                    help="write a 3D map/trajectory debug view "
                         "(map3d_%%05d.png) every N frames (the "
                         "reference's PCL viewer, Draw.h:88-100, rendered "
                         "headlessly)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device; "
                         "'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    overrides = {}
    if args.max_features:
        overrides["max_features"] = args.max_features
    if args.matcher:
        overrides["matcher"] = args.matcher
        if args.matcher == "ncc":
            # NCC stores appearance patches in the descriptor slots
            from openekfmonoslam_tpu_torch.config import DescriptorConfig
            overrides["descriptor"] = DescriptorConfig(kind="PATCH")

    from openekfmonoslam_tpu_torch.engine.engine import (SlamEngine,
                                                         run_sequence)
    from openekfmonoslam_tpu_torch.eval.result_reader import (
        emit_matlab_report)
    from openekfmonoslam_tpu_torch.eval.trajectory import summarize

    src = build_source(args.source, args.begin, args.end, args.realtime)

    if args.mode == "scan":
        import numpy as np

        from openekfmonoslam_tpu_torch import spans
        from openekfmonoslam_tpu_torch.config import (auto_max_features,
                                                      load_config)
        from openekfmonoslam_tpu_torch.engine.scan_runner import (
            run_sequence_on_device)
        from openekfmonoslam_tpu_torch.engine.step import SlamRuntime

        cfg = load_config(args.config)
        cfg = dataclasses.replace(
            cfg, max_features=overrides.get(
                "max_features", auto_max_features(cfg.ekf)))
        rt = SlamRuntime(cfg, device=args.device)
        frames = []
        for i, f in enumerate(src):
            if args.max_frames is not None and i >= args.max_frames:
                break
            frames.append(f)
        frames = np.stack(frames)
        timing = (spans.collect() if args.phase_timing
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with timing as timed:
            state, records = run_sequence_on_device(rt, frames, chunk=64)
        dt = time.perf_counter() - t0
        print(f"{len(frames)-1} frames in {dt:.2f}s "
              f"({(len(frames)-1)/dt:.1f} fps incl. first calls)")
        summary = summarize(records)
        print(summary)
        if args.output:
            from openekfmonoslam_tpu_torch.eval.result_reader import (
                records_to_dicts,
                write_output_yml,
            )
            os.makedirs(args.output, exist_ok=True)
            np.save(os.path.join(args.output, "x_cam.npy"),
                    np.asarray(records.x_cam))
            phase_times, frame_us = None, None
            if timed is not None:
                phase_times = spans.phase_times_us(timed)
                frame_us = dt / max(len(frames) - 1, 1) * 1e6
            dicts = records_to_dicts(records, phase_times=phase_times,
                                     frame_time_us=frame_us)
            write_output_yml(dicts,
                             os.path.join(args.output, "output.yml"))
            emit_matlab_report(dicts, args.output)
        return

    engine = SlamEngine(args.config, output_path=args.output,
                        render=args.render, render_debug=args.render_debug,
                        phase_timing=args.phase_timing,
                        keyframe_every=args.keyframe_every,
                        relocalize_after=args.relocalize_after,
                        viz3d_every=args.viz3d, device=args.device,
                        **overrides)
    ckpt_path = (os.path.join(args.output, "checkpoint.npz")
                 if args.output else "checkpoint.npz")
    if args.resume:
        engine.resume(args.resume)
    t0 = time.perf_counter()
    if args.resume or args.checkpoint_every:
        # per-frame loop with checkpointing; resume skips EKF::init
        it = iter(src)
        if not args.resume:
            engine.init(next(it))
        for i, frame in enumerate(it):
            if args.max_frames is not None and i >= args.max_frames:
                break
            rec = engine.step(frame)
            if (args.checkpoint_every
                    and rec["frame"] % args.checkpoint_every == 0):
                engine.save_checkpoint(ckpt_path)
            if args.progress and (i + 1) % args.progress == 0:
                print(f"frame {rec['frame']}: "
                      f"matches={rec['total_matches']}")
    else:
        run_sequence(engine, src, max_frames=args.max_frames,
                     progress_every=args.progress)
    dt = time.perf_counter() - t0
    print(f"total {dt:.2f}s for {len(engine.records)} frames "
          f"({len(engine.records)/max(dt,1e-9):.1f} fps)")
    print(summarize(engine.records))
    if args.output:
        emit_matlab_report(engine.records, args.output)
    if (engine.loop_closer is not None and engine.loop_closer.closures
            and args.output):
        # the drift-corrected trajectory beside the raw one
        import numpy as np

        from openekfmonoslam_tpu_torch.eval.result_reader import (
            write_points3d)
        corrected = engine.corrected_trajectory()
        np.save(os.path.join(args.output, "trajectory_corrected.npy"),
                corrected)
        write_points3d(
            os.path.join(args.output, "cameraPositionsCorrected.m"),
            "cameraPositionsCorrected", corrected)
        with open(os.path.join(args.output, "loop_closures.json"),
                  "w") as f:
            json.dump([{k: (v.tolist() if hasattr(v, "tolist") else v)
                        for k, v in c.items()}
                       for c in engine.loop_closer.closures], f, indent=2)
        print(f"{len(engine.loop_closer.closures)} loop closure(s); "
              "corrected trajectory written")
    engine.close()


if __name__ == "__main__":
    main()
