"""Where the port's per-frame time goes, on one CUDA device.

    python tools/prof_torch_slam.py [--frames 30] [--warmup 15] [--prof-frames 4]
                                    [--out prof_out] [--vocab] [--streams S]
                                    [--threaded] [--pipelined] [--graphs both|on|off]

Renders the spiral ring world at 1241x376 (the chip_smoke.py sequence) and
runs the serial MonoSLAM on the GPU, measuring the frames after `--warmup`.
With `--graphs both` (the default) passes 1 and 2 run once with the
tracker's captured programs replayed (`graphs=True`) and once op by op
(`graphs=False`); `on` / `off` runs one of the two (the multi-stream and
threaded modes take `off` as graphs=False, anything else as True). Every
profiler pass also counts the host's API calls a frame: kernel launches
(`cudaLaunchKernel` and kin), graph launches (`cudaGraphLaunch`, one per
replay) and copies (`cudaMemcpyAsync`), beside the device's launches. The
passes:
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
With `--streams S` (S > 1) the same three passes run `MultiStreamSLAM` with S
streams (the spiral under S seeds and steps) and measure a batch frame: its
wall time and its split into prepare / dispatch / fetch / consume
(`phase_s`), device launches and device time per batch frame, the device
busy share, and the host's cumulative times.
With `--threaded` and / or `--pipelined` the system is
`MonoSLAM(threaded=..., pipelined=...)` fed at full rate, and the passes
measure: 1. the host's wall time of each `track_monocular` call (the pose is
on the host when it returns), the window's wall time with the final drain,
and the mapper's per-stage ms (`pass_ms`); 2. a per-thread profile by stack
sampling (cProfile on Python 3.12 is one process-wide profiler that cannot
tell threads apart): for the tracker (`MainThread`), `mapper` and `gba`
threads, the share of samples each function was on the thread's stack, and
the share in which the thread sat in a Python-level wait (the mapper's idle
`queue.get`, a join; a wait inside a C call, such as for the map lock or a
device copy, shows as the calling function); 3. the device busy share and
launches a frame under torch.profiler, last, since the profiler stretches
the threaded frames most.
Writes `summary.json`, `ops.txt` and `cprofile.txt` (`sampling.txt` for the
threaded modes) under --out and prints the summary. Needs a CUDA device.
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
import threading
import time
from collections import Counter

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


STREAM_VARIANTS = [(11, 0.06), (11, 0.05), (11, 0.055), (11, 0.065), (11, 0.07), (12, 0.06),
                   (13, 0.06), (11, 0.0525)]  # (seed, step) of each stream's spiral


def _api_calls(prof) -> dict:
    """Host API calls in a torch.profiler run: kernel launches, graph
    launches (replays) and copies."""
    names = Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("cu"))
    return {"kernel_launches": sum(n for k, n in names.items() if "Launch" in k and "Graph" not in k),
            "graph_launches": sum(n for k, n in names.items() if "GraphLaunch" in k),
            "copies": sum(n for k, n in names.items() if "Memcpy" in k)}


def _per_frame(calls: dict, n: int) -> dict:
    return {k: v / n for k, v in calls.items()}


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def profile_streams(args, h: int, w: int) -> int:
    """The three passes over `MultiStreamSLAM` with args.streams streams."""
    from ceres_mono_orb_slam2_tpu_torch.parallel.multisystem import MultiStreamSLAM

    S = args.streams
    seqs = [make_rendered_sequence(args.frames, h, w, 500.0, 500.0, motion="spiral", step=step,
                                   seed=seed, device="cuda")
            for seed, step in (STREAM_VARIANTS * S)[:S]]
    window = range(args.warmup, args.frames)

    def batch_frame(system, i):
        t0 = time.perf_counter()
        system.track_batch([q.images[i] for q in seqs], [float(q.timestamps[i]) for q in seqs])
        torch.cuda.current_stream().synchronize()  # a device-wide sync would break a mapper capture
        return (time.perf_counter() - t0) * 1e3

    def fresh():
        system = MultiStreamSLAM(_config(h, w), n_streams=S, device="cuda", graphs=args.graphs != "off")
        for i in range(args.warmup):
            batch_frame(system, i)
        system.phase_s.update(prepare=0.0, dispatch=0.0, fetch=0.0, consume=0.0, frames=0)
        return system

    # pass 1: wall clock and the system's own phase split, no profiler
    system = fresh()
    frame_ms = np.asarray([batch_frame(system, i) for i in window])
    ph = dict(system.phase_s)
    n_b = max(ph["frames"], 1)
    phase_ms = {k: ph[k] / n_b * 1e3 for k in ("prepare", "dispatch", "fetch", "consume")}
    print(f"pass 1: batch frame ms median {np.median(frame_ms):.2f} over {len(frame_ms)} frames "
          f"({ph['frames']} batched); per batched frame {phase_ms}", flush=True)
    # pass 2: torch.profiler over the first frames of the window
    system = fresh()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pw = window[:args.prof_frames]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for i in pw:
            batch_frame(system, i)
    prof_wall_ms = (time.perf_counter() - t0) * 1e3
    orb_launches = {k: v / len(pw) for k, v in kernels.launch_counts.items()}
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    api = _per_frame(_api_calls(prof), len(pw))
    print(f"pass 2: {len(dev_events) / len(pw):.0f} launches/batch frame, device "
          f"{dev_ms / len(pw):.2f} ms of {prof_wall_ms / len(pw):.2f} ms profiled; host API calls "
          f"per batch frame {api}", flush=True)
    evs = prof.key_averages()
    dev_key = ("self_device_time_total" if hasattr(evs[0], "self_device_time_total")
               else "self_cuda_time_total")
    with open(os.path.join(args.out, "ops.txt"), "w") as f:
        f.write(evs.table(sort_by=dev_key, row_limit=30))
        f.write("\n")
        f.write(evs.table(sort_by="self_cpu_time_total", row_limit=30))
    # pass 3: cProfile over the window of a fresh run
    system = fresh()
    pr = cProfile.Profile()
    pr.enable()
    for i in window:
        batch_frame(system, i)
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(45)
    with open(os.path.join(args.out, "cprofile.txt"), "w") as f:
        f.write(buf.getvalue())
    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": _smi(), "streams": S,
        "stream_variants_seed_step": (STREAM_VARIANTS * S)[:S],
        "frames_profiled": len(frame_ms), "batched_frames": ph["frames"],
        "batch_frame_ms_median": float(np.median(frame_ms)),
        "batch_frame_ms_p95": float(np.percentile(frame_ms, 95)),
        "aggregate_frames_per_s": S / float(np.median(frame_ms)) * 1e3,
        "phase_ms_per_batched_frame": phase_ms,
        "frames_under_torch_profiler": len(pw),
        "profiled_wall_ms_per_batch_frame": prof_wall_ms / len(pw),
        "device_kernel_ms_per_batch_frame": dev_ms / len(pw),
        "kernel_launches_per_batch_frame": len(dev_events) / len(pw),
        "host_api_calls_per_batch_frame": api, "graphs": args.graphs != "off",
        "orb_kernel_launches_per_batch_frame": orb_launches,
        "device_busy_share_under_profiler": dev_ms / prof_wall_ms,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print(buf.getvalue()[:6000])
    return 0


class ThreadSampler:
    """Samples every thread's Python stack each `interval` seconds on a
    thread of its own: per thread, how many samples each function was on the
    stack (once per sample), and how many found the thread in a Python-level
    wait."""

    WAITS = {"wait", "get", "join", "_wait_for_tstate_lock"}

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self.samples = Counter()  # thread name -> samples
        self.waiting = Counter()  # thread name -> samples spent waiting
        self.funcs = {}  # thread name -> Counter of "file:line(function)"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="sampler", daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                name = names.get(ident, str(ident))
                self.samples[name] += 1
                if frame.f_code.co_name in self.WAITS:
                    self.waiting[name] += 1
                seen = set()
                while frame is not None:
                    code = frame.f_code
                    seen.add(f"{os.path.basename(code.co_filename)}:{code.co_firstlineno}({code.co_name})")
                    frame = frame.f_back
                self.funcs.setdefault(name, Counter()).update(seen)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def report(self, top: int = 25) -> str:
        out = []
        for name, n in self.samples.most_common():
            out.append(f"thread {name}: {n} samples, waiting in {self.waiting[name] / n:.3f} of them")
            for fn, c in self.funcs[name].most_common(top):
                out.append(f"  {c / n:7.3f}  {fn}")
        return "\n".join(out)


def profile_concurrent(args, seq, voc, h: int, w: int) -> int:
    """The three passes over `MonoSLAM(threaded=..., pipelined=...)` fed at
    full rate."""
    window = range(args.warmup, args.frames)

    def fresh():
        slam = MonoSLAM(_config(h, w), vocabulary=voc, device="cuda", threaded=args.threaded,
                        pipelined=args.pipelined, graphs=args.graphs != "off")
        for i in range(args.warmup):
            slam.track_monocular(seq.images[i], float(seq.timestamps[i]))
        slam.wait_mapper_idle(timeout=600.0)
        torch.cuda.current_stream().synchronize()  # a device-wide sync would break a mapper capture
        slam.local_mapper.pass_ms.clear()
        return slam

    def run(slam, frames):
        """Per-call host ms of the frames, then the wall time through the
        drain (mapper idle, pipeline consumed, device synchronised)."""
        ms = []
        t0 = time.perf_counter()
        for i in frames:
            t = time.perf_counter()
            slam.track_monocular(seq.images[i], float(seq.timestamps[i]))
            ms.append((time.perf_counter() - t) * 1e3)
        slam.flush_pipeline()
        slam.wait_mapper_idle(timeout=600.0)
        torch.cuda.current_stream().synchronize()  # a device-wide sync would break a mapper capture
        return np.asarray(ms), (time.perf_counter() - t0) * 1e3

    # pass 1: wall clock, no profiler
    slam = fresh()
    frame_ms, wall_ms = run(slam, window)
    lm, tr = slam.local_mapper, slam.tracker
    stages = ("process_new", "cull_mp", "triangulate", "fuse", "lba", "cull_kf")
    stage_ms = {st: float(np.mean([p[st] for p in lm.pass_ms if st in p] or [0.0])) for st in stages}
    counters = {"mapping_passes": len(lm.pass_ms), "n_local_ba": lm.n_local_ba,
                "n_ba_aborted": lm.n_ba_aborted, "n_chained_frames": tr.n_chained_frames,
                "n_discarded_chained": tr.n_discarded_chained, "n_retracked_frames": tr.n_retracked_frames}
    slam.shutdown()
    print(f"pass 1: frame ms median {np.median(frame_ms):.2f}, p95 {np.percentile(frame_ms, 95):.2f}; "
          f"window {wall_ms:.1f} ms for {len(frame_ms)} frames with the drain; mapper stages {stage_ms}; "
          f"{counters}", flush=True)

    # pass 2: per-thread stack sampling over the window of a fresh run
    slam = fresh()
    with ThreadSampler() as sampler:
        run(slam, window)
    slam.shutdown()
    text = sampler.report()
    with open(os.path.join(args.out, "sampling.txt"), "w") as f:
        f.write(text)
    # pass 3: torch.profiler over the start of the window of a fresh run
    slam = fresh()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pw = window[:args.prof_frames]
    kernels.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall_ms = run(slam, pw)
    orb_launches = {k: v / len(pw) for k, v in kernels.launch_counts.items()}
    slam.shutdown()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    api = _per_frame(_api_calls(prof), len(pw))
    print(f"pass 3: {len(dev_events) / len(pw):.0f} launches/frame, device {dev_ms / len(pw):.2f} "
          f"ms/frame of {prof_wall_ms / len(pw):.2f} ms profiled; host API calls per frame {api}",
          flush=True)
    evs = prof.key_averages()
    dev_key = ("self_device_time_total" if hasattr(evs[0], "self_device_time_total")
               else "self_cuda_time_total")
    with open(os.path.join(args.out, "ops.txt"), "w") as f:
        f.write(evs.table(sort_by=dev_key, row_limit=30))
        f.write("\n")
        f.write(evs.table(sort_by="self_cpu_time_total", row_limit=30))

    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
        "threaded": args.threaded, "pipelined": args.pipelined,
        "vocabulary_words": None if voc is None else voc.n_words,
        "frames_profiled": len(frame_ms),
        "frame_ms_median": float(np.median(frame_ms)),
        "frame_ms_p95": float(np.percentile(frame_ms, 95)),
        "window_ms_with_drain": wall_ms, "mapper_stage_ms_mean": stage_ms, "counters": counters,
        "frames_under_torch_profiler": len(pw),
        "profiled_wall_ms_per_frame": prof_wall_ms / len(pw),
        "device_kernel_ms_per_frame": dev_ms / len(pw),
        "kernel_launches_per_frame": len(dev_events) / len(pw),
        "host_api_calls_per_frame": api, "graphs": args.graphs != "off",
        "orb_kernel_launches_per_frame": orb_launches,
        "device_busy_share_under_profiler": dev_ms / prof_wall_ms,
        "thread_samples": dict(sampler.samples),
        "thread_waiting_share": {k: sampler.waiting[k] / n for k, n in sampler.samples.items()},
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print(text[:6000])
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=15)
    ap.add_argument("--prof-frames", type=int, default=4)
    ap.add_argument("--out", default="prof_out")
    ap.add_argument("--vocab", action="store_true",
                    help="run with a trained vocabulary (BoW database and loop closer)")
    ap.add_argument("--streams", type=int, default=1,
                    help="S > 1: profile MultiStreamSLAM with S streams instead of the serial MonoSLAM")
    ap.add_argument("--threaded", action="store_true",
                    help="MonoSLAM(threaded=True): local mapping and loop closing on the mapper thread")
    ap.add_argument("--pipelined", action="store_true",
                    help="MonoSLAM(pipelined=True): frame k dispatched before frame k-1 is consumed")
    ap.add_argument("--graphs", choices=("both", "on", "off"), default="both",
                    help="replay the captured programs (on), run op by op (off), or the serial "
                         "passes 1 and 2 both ways (both)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prof_torch_slam: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    h, w = 376, 1241
    if args.streams > 1:
        return profile_streams(args, h, w)
    seq = make_rendered_sequence(args.frames, h, w, 500.0, 500.0, motion="spiral", step=0.06,
                                 seed=11, device="cuda")
    window = range(args.warmup, args.frames)
    voc = _train_vocabulary(seq, _config(h, w)) if args.vocab else None
    if args.threaded or args.pipelined:
        return profile_concurrent(args, seq, voc, h, w)

    def fresh(graphs):
        slam = MonoSLAM(_config(h, w), vocabulary=voc, device="cuda", graphs=graphs)
        for i in range(args.warmup):
            _frame(slam, seq, i)
        return slam

    n = len(window)
    modes = {"both": (True, False), "on": (True,), "off": (False,)}[args.graphs]
    by_mode = {}
    for graphs in modes:
        mode = "graphs" if graphs else "eager"
        # pass 1: wall-clock split, no profiler attached
        slam = fresh(graphs)
        split = np.asarray([_frame(slam, seq, i) for i in window])
        print(f"pass 1 ({mode}): frame ms median {np.median(split.sum(1)):.2f} (tracking "
              f"{np.median(split[:, 0]):.2f}, mapping {np.median(split[:, 1]):.2f}, loop closing mean "
              f"{split[:, 2].mean():.2f})", flush=True)
        loop_counters = None if slam.loop_closer is None else {
            "n_detects": slam.loop_closer.n_detects,
            "n_candidate_events": slam.loop_closer.n_candidate_events,
            "n_loops_closed": slam.loop_closer.n_loops_closed,
            "words_indexed": len(slam.keyframe_db.inverted)}

        # pass 2: torch.profiler over the start of the same window, fresh run
        slam = fresh(graphs)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        pw = window[:args.prof_frames]
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            for i in pw:
                _frame(slam, seq, i)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
        dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
        api = _per_frame(_api_calls(prof), len(pw))
        print(f"pass 2 ({mode}): {len(dev_events) / len(pw):.0f} launches/frame, device "
              f"{dev_ms / len(pw):.2f} ms/frame of {prof_wall_ms / len(pw):.2f} ms profiled; host API "
              f"calls per frame {api}", flush=True)
        # the extractor alone over the same frames
        kernels.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as xprof:
            for i in pw:
                slam.extractor.extract(seq.images[i])
            torch.cuda.synchronize()
        x_launches = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in xprof.events())
        orb_launches = {k: v / len(pw) for k, v in kernels.launch_counts.items()}
        print(f"pass 2 ({mode}): extractor {x_launches / len(pw):.0f} device launches/frame, of which "
              f"hand-written kernels {orb_launches}", flush=True)
        if not by_mode:
            evs = prof.key_averages()
            dev_key = ("self_device_time_total" if hasattr(evs[0], "self_device_time_total")
                       else "self_cuda_time_total")
            with open(os.path.join(args.out, "ops.txt"), "w") as f:
                f.write(evs.table(sort_by=dev_key, row_limit=30))
                f.write("\n")
                f.write(evs.table(sort_by="self_cpu_time_total", row_limit=30))
        by_mode[mode] = {
            "frame_ms_median": float(np.median(split.sum(1))),
            "tracking_ms_median": float(np.median(split[:, 0])),
            "mapping_ms_median": float(np.median(split[:, 1])),
            "mapping_ms_mean": float(split[:, 1].mean()),
            "loop_closing_ms_mean": float(split[:, 2].mean()),
            "loop_closing_ms_max": float(split[:, 2].max()),
            "loop_closer": loop_counters,
            "profiled_wall_ms_per_frame": prof_wall_ms / len(pw),
            "device_kernel_ms_per_frame": dev_ms / len(pw),
            "kernel_launches_per_frame": len(dev_events) / len(pw),
            "host_api_calls_per_frame": api,
            "extractor_launches_per_frame": x_launches / len(pw),
            "orb_kernel_launches_per_frame": orb_launches,
            "device_busy_share_under_profiler": dev_ms / prof_wall_ms,
            "programs": slam.tracker.programs(),
        }

    # pass 3: cProfile over the same window of a fresh run of the first mode
    slam = fresh(modes[0])
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
        "nvidia_smi": _smi(),
        "frames_profiled": n,
        "frames_under_torch_profiler": len(window[:args.prof_frames]),
        "vocabulary_words": None if voc is None else voc.n_words,
        "cprofile_mode": "graphs" if modes[0] else "eager",
        **by_mode,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print(s.getvalue()[:6000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
