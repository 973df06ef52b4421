"""Where the port's per-frame time goes, on one CUDA device.

    python tools/prof_torch_slam.py [--frames 30] [--warmup 15] [--prof-frames 4]
                                    [--out prof_out] [--vocab]

Renders the spiral ring world at 1241x376 (the chip_smoke.py sequence) and
runs the serial MonoSLAM on the GPU three times, measuring the frames after
`--warmup` in each:
  1. host wall time per frame, split into tracking (grab_image) and local
     mapping (process_queue), each ending in torch.cuda.synchronize();
  2. torch.profiler over the first `--prof-frames` of them (the profiler
     records every launch; post-processing tens of thousands of events a
     frame takes minutes): device kernel time, kernel launches per frame,
     the device busy share of the profiled wall time, and the top operators
     by self CUDA and self CPU time; then over the ORB extraction of the
     same frames alone: the extractor's device launches per frame, and the
     launches of its two hand-written kernels (`launch_counts`);
  3. cProfile: cumulative host time of the port's own functions.
With `--vocab` the system runs with a vocabulary trained on every fourth
frame's descriptors (k=10, levels=4), so that the BoW transform and the loop
closer's queue run on every keyframe; pass 1 then also reports the loop
closer's share of a frame and the summary its counters.
Writes `summary.json`, `ops.txt` and `cprofile.txt` under --out and prints
the summary. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence  # noqa: E402


def _config(h, w):
    return SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=w / 2.0, cy=h / 2.0, fps=30.0),
                      orb=ORBConfig(n_features=2000),
                      shapes=StaticShapes(max_local_points=4096))


def _frame(slam, seq, i):
    """(tracking ms, mapping ms, loop-closing ms) of frame i, each ended by a
    device sync; the last is 0 without a vocabulary."""
    t0 = time.perf_counter()
    slam.tracker.grab_image(seq.images[i], float(seq.timestamps[i]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    slam.local_mapper.process_queue()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if slam.loop_closer is not None:
        slam.loop_closer.process_queue()
        torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3


def _train_vocabulary(seq, cfg):
    from ceres_mono_orb_slam2_tpu_torch.ops import bow
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import ORBExtractor

    ex = ORBExtractor(cfg.orb, device="cuda")
    corpus = []
    for i in range(0, seq.n_frames, 4):
        fe = ex.extract(seq.images[i])
        corpus.append(fe.desc[0][fe.valid[0]].cpu().numpy())
    return bow.train_vocabulary(np.concatenate(corpus), k=10, levels=4, seed=0, docs=corpus,
                                device="cuda")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=15)
    ap.add_argument("--prof-frames", type=int, default=4)
    ap.add_argument("--out", default="prof_out")
    ap.add_argument("--vocab", action="store_true",
                    help="run with a trained vocabulary (BoW database and loop closer)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prof_torch_slam: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    h, w = 376, 1241
    seq = make_rendered_sequence(args.frames, h, w, 500.0, 500.0, motion="spiral", step=0.06,
                                 seed=11, device="cuda")
    window = range(args.warmup, args.frames)
    voc = _train_vocabulary(seq, _config(h, w)) if args.vocab else None

    def fresh():
        slam = MonoSLAM(_config(h, w), vocabulary=voc, device="cuda")
        for i in range(args.warmup):
            _frame(slam, seq, i)
        return slam

    n = len(window)
    # pass 1: wall-clock split, no profiler attached
    slam = fresh()
    split = np.asarray([_frame(slam, seq, i) for i in window])
    print(f"pass 1: frame ms median {np.median(split.sum(1)):.2f} (tracking "
          f"{np.median(split[:, 0]):.2f}, mapping {np.median(split[:, 1]):.2f}, loop closing mean "
          f"{split[:, 2].mean():.2f})", flush=True)
    loop_counters = None if slam.loop_closer is None else {
        "n_detects": slam.loop_closer.n_detects,
        "n_candidate_events": slam.loop_closer.n_candidate_events,
        "n_loops_closed": slam.loop_closer.n_loops_closed,
        "words_indexed": len(slam.keyframe_db.inverted)}

    # pass 2: torch.profiler over the start of the same window, fresh run
    slam = fresh()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pw = window[:args.prof_frames]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for i in pw:
            _frame(slam, seq, i)
    prof_wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    print(f"pass 2: {len(dev_events) / len(pw):.0f} launches/frame, device "
          f"{dev_ms / len(pw):.2f} ms/frame of {prof_wall_ms / len(pw):.2f} ms profiled", flush=True)
    # the extractor alone over the same frames
    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as xprof:
        for i in pw:
            slam.extractor.extract(seq.images[i])
        torch.cuda.synchronize()
    x_launches = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in xprof.events())
    orb_launches = {k: v / len(pw) for k, v in kernels.launch_counts.items()}
    print(f"pass 2: extractor {x_launches / len(pw):.0f} device launches/frame, of which "
          f"hand-written kernels {orb_launches}", flush=True)
    evs = prof.key_averages()
    dev_key = ("self_device_time_total" if hasattr(evs[0], "self_device_time_total")
               else "self_cuda_time_total")
    with open(os.path.join(args.out, "ops.txt"), "w") as f:
        f.write(evs.table(sort_by=dev_key, row_limit=30))
        f.write("\n")
        f.write(evs.table(sort_by="self_cpu_time_total", row_limit=30))

    # pass 3: cProfile over the same window of a fresh run
    slam = fresh()
    pr = cProfile.Profile()
    pr.enable()
    for i in window:
        _frame(slam, seq, i)
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(45)
    with open(os.path.join(args.out, "cprofile.txt"), "w") as f:
        f.write(s.getvalue())

    summary = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(),
        "frames_profiled": n,
        "frame_ms_median": float(np.median(split.sum(1))),
        "tracking_ms_median": float(np.median(split[:, 0])),
        "mapping_ms_median": float(np.median(split[:, 1])),
        "mapping_ms_mean": float(split[:, 1].mean()),
        "vocabulary_words": None if voc is None else voc.n_words,
        "loop_closing_ms_mean": float(split[:, 2].mean()),
        "loop_closing_ms_max": float(split[:, 2].max()),
        "loop_closer": loop_counters,
        "frames_under_torch_profiler": len(pw),
        "profiled_wall_ms_per_frame": prof_wall_ms / len(pw),
        "device_kernel_ms_per_frame": dev_ms / len(pw),
        "kernel_launches_per_frame": len(dev_events) / len(pw),
        "extractor_launches_per_frame": x_launches / len(pw),
        "orb_kernel_launches_per_frame": orb_launches,
        "device_busy_share_under_profiler": dev_ms / prof_wall_ms,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print(s.getvalue()[:6000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
