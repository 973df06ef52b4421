"""mono_slam CLI (reference src/main.cc), on the card.

Port of `ceres_mono_orb_slam2_tpu/cli.py`:

    python -m ceres_mono_orb_slam2_tpu_torch.cli --config configs/TUM2.yaml \\
        --images rgbd_dataset_freiburg2_desk [--voc ORBvoc.txt] [--output-dir out] \\
        [--threaded] [--pipelined] [--localization] [--load-map map.npz] \\
        [--stats-out stats.jsonl] [--profile-dir trace] [--viewer] [--live-viewer PORT] \\
        [--device cuda|cpu]

Reads a reference-format YAML config and a TUM, KITTI or EuRoC image folder
(or renders `--synthetic N` frames), optionally paces playback to the
timestamps (main.cc:97-106), feeds every frame to `MonoSLAM`, prints the
median and mean tracking time at exit (main.cc:111-118) and writes
KeyFrameTrajectory.txt, FrameTrajectory.txt, map.npz and map.yaml to the
output directory. It runs on the card (`--device cuda`, the default) and
raises where CUDA is absent; `--device cpu` runs the kernels' plain
versions. `--load-map` leaves the tracker lost, so the first frame
relocalizes against the loaded map. `--viewer` writes map snapshots to
viewer_out/ in the current directory; `--live-viewer PORT` serves the
interactive viewer over HTTP on 127.0.0.1 (its URL is logged).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Monocular ORB-SLAM on a CUDA card (PyTorch port)")
    ap.add_argument("--config", required=True, help="camera/ORB YAML (reference configs/*.yaml format)")
    ap.add_argument("--images", help="dataset directory (TUM/KITTI/EuRoC auto-detected)")
    ap.add_argument("--voc", help="ORBvoc.txt vocabulary (enables loop closing + relocalization)")
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--realtime", action="store_true", help="pace playback to timestamps")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--synthetic", type=int, default=0, help="run on N synthetic frames instead of --images")
    ap.add_argument("--localization", action="store_true", help="localization-only mode")
    ap.add_argument("--load-map", help="load a map.npz saved by either package before tracking; the "
                    "first frame relocalizes against it")
    ap.add_argument("--viewer", action="store_true",
                    help="write a map snapshot every 10 frames to viewer_out/ in the current directory")
    ap.add_argument("--live-viewer", type=int, default=None, metavar="PORT",
                    help="serve the interactive map/frame viewer with the Pangolin-menu controls on this "
                         "HTTP port (0 = ephemeral)")
    ap.add_argument("--threaded", action="store_true",
                    help="run local mapping and loop closing on a worker thread (reference architecture)")
    ap.add_argument("--pipelined", action="store_true",
                    help="pipelined tracking: dispatch each frame before consuming the previous one "
                         "(poses report with one frame of latency)")
    ap.add_argument("--stats-out", help="write per-frame structured stats as JSONL")
    ap.add_argument("--profile-dir", help="write a torch.profiler trace of the run (CPU and CUDA activity)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _synthetic_config(config):
    """The synthetic renderer is an ideal pinhole with the principal point at
    the image centre, and its level-0 corner density needs ~1500 features to
    clear the 100-match initialization gate; demo-sized BA and matching
    buffers, as the JAX package's CLI sets them."""
    from ceres_mono_orb_slam2_tpu_torch.utils.config import SlamConfig, StaticShapes

    for k in ("k1", "k2", "p1", "p2", "k3"):
        setattr(config.camera, k, 0.0)
    config.camera.cx, config.camera.cy = 320.0, 240.0
    return SlamConfig(camera=config.camera,
                      orb=dataclasses.replace(config.orb, n_features=max(config.orb.n_features, 1500)),
                      viewer=config.viewer,
                      shapes=StaticShapes(max_local_points=4096, max_local_keyframes=12,
                                          max_ba_points=2048, max_ba_obs=8192))


def _profiler(path: str, device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(path))


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.synthetic and not args.images:
        ap.error("one of --images or --synthetic is required")

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.utils.config import load_config
    from ceres_mono_orb_slam2_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises where CUDA is absent
    config = load_config(args.config)
    if args.synthetic:
        from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_sequence

        config = _synthetic_config(config)
        seq = make_sequence(n_frames=args.synthetic, fx=config.camera.fx, fy=config.camera.fy, step=0.12)
        frames = [(seq.images[i], seq.timestamps[i]) for i in range(seq.n_frames)]
    else:
        from ceres_mono_orb_slam2_tpu_torch.utils.datasets import load_auto, reader

        ds = load_auto(args.images)
        n = len(ds) if not args.max_frames else min(len(ds), args.max_frames)
        print(f"{n} frames from {args.images}; image reader: {reader()}", flush=True)
        frames = ds.iter_prefetch(n)  # decodes ahead of the tracker

    vocabulary = None
    if args.voc:
        from ceres_mono_orb_slam2_tpu_torch.ops.bow import parse_orbvoc_text

        vocabulary = parse_orbvoc_text(args.voc)

    slam = MonoSLAM(config, device=device, vocabulary=vocabulary, threaded=args.threaded,
                    pipelined=args.pipelined, use_viewer=args.viewer, live_viewer_port=args.live_viewer)
    if args.load_map:
        slam.load_map(args.load_map)
        print("loaded map: %d keyframes, %d map points" % (slam.map.n_keyframes(), slam.map.n_map_points()))
    if args.localization:
        slam.activate_localization_mode()

    prof = _profiler(args.profile_dir, device) if args.profile_dir else None
    if prof is not None:
        prof.__enter__()
    track_times = []
    last_ts = None
    try:
        for img, ts in frames:
            t0 = time.perf_counter()
            slam.track_monocular(img, ts)
            dt = time.perf_counter() - t0
            track_times.append(dt)
            if args.realtime and last_ts is not None and dt < ts - last_ts:
                time.sleep(ts - last_ts - dt)
            last_ts = ts
        slam.shutdown()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        print("profiler trace written to", args.profile_dir)

    tt = np.array(track_times) if track_times else np.zeros(1)
    # the reference prints median and mean tracking time at exit (main.cc:111-118)
    print("-------")
    print("median tracking time: %.6f" % float(np.median(tt)))
    print("mean tracking time: %.6f" % float(np.mean(tt)))
    print("tracked %d frames, state %s, %d keyframes, %d map points"
          % (len(track_times), slam.get_tracking_state(), slam.map.n_keyframes(), slam.map.n_map_points()))
    print("re-tracked %d frames" % slam.tracker.n_retracked_frames)

    os.makedirs(args.output_dir, exist_ok=True)
    slam.save_keyframe_trajectory_tum(os.path.join(args.output_dir, "KeyFrameTrajectory.txt"))
    slam.save_frame_trajectory_tum(os.path.join(args.output_dir, "FrameTrajectory.txt"))
    slam.save_map(os.path.join(args.output_dir, "map.npz"))
    # the reference-format OpenCV-YAML dump as well (main.cc:121 SaveMap("map.yaml"))
    slam.save_map_yaml(os.path.join(args.output_dir, "map.yaml"))
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            for rec in slam.tracker.frame_stats:
                f.write(json.dumps(rec, default=lambda v: v.item()) + "\n")  # numpy scalars
        print("per-frame stats written to", args.stats_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
