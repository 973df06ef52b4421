"""Keyframe decisions of the threaded MonoSLAM at full rate, on one GPU.

    python tools/diag_threaded_keyframes.py [--world spiral|geo-circle] [--frames 32]
                                            [--runs serial,threaded,eager,paced] [--no-wait] [--prewarm]
                                            [--sample] [--split]

`--world spiral` (the default) renders the spiral ring world at 1241x376
(chip_smoke.py's sequence, 2000 features); `--world geo-circle` runs
chip_smoke.py's closed geometric circle (72 frames at 640x480, 2000
projected keypoints from 24,000 landmarks, its vocabulary), which closes a
loop near its end. The first `--frames` frames (default: 32 of the spiral,
all 72 of the circle) go through the MonoSLAM of each run: `serial`,
`threaded` (graphs, fed at full rate), `eager` (threaded, graphs=False,
full rate) and `paced` (threaded, graphs, `wait_mapper_idle` after each
frame). For each run it prints the ATE of the tracked centres, the
keyframes, the loops closed, the mapper's passes and seconds, the median
and p95 frame ms, the mean ms of each mapping stage over every pass and
over the passes after the first (a threaded mapper's first pass waits for
the tracker's first captures unless the system is prewarmed), the keyframes
an idle mapper would have taken and the busy one could not (not taken), the
tracker's calls of `LocalMapping.interrupt_ba`, the frames that waited for
local mapping (`MonoSLAM.n_keyframe_waits`) and the longest wait, the wall
ms of the first fused frame, and per keyframe decision (frame, keyframes,
inliers, the reference keyframe's tracked points, mapper idle, queued
keyframes, new keyframe, not taken); then each frame's method, inliers and
ms, each mapping pass's stage ms and each closure's stage ms. `--no-wait`
turns off the facade's wait after a wanted keyframe (the reference's
behaviour: the keyframe is dropped); `--prewarm` calls `MonoSLAM.prewarm`
before frame 0 and prints its phases; `--sample` prints
per-thread stack samples of the threaded runs (tools/prof_torch_slam.py's
ThreadSampler); `--split` prints, per mapping pass on average, where the
mapping thread's wall time went: waiting for and holding `map.update_lock`,
inside the device calls of the triangulation (and within it the wait for
its queued work before the eigensolver, and the eigensolver with its host
check), the fuse and the local BA (their enqueue and the host checks
within), inside `graphs.fetch` (the stages' read-backs) and the rest (host
Python), and how long the tracker's thread held the lock a frame. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ceres_mono_orb_slam2_tpu_torch.models import tracking  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.ops import bow, mapping_batch, optim, twoview  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils import graphs  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils.config import (  # noqa: E402
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (  # noqa: E402
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, make_rendered_sequence  # noqa: E402
from prof_torch_slam import ThreadSampler  # noqa: E402

H, W = 376, 1241
# chip_smoke.py's [loop] world: a closed circle of 72 frames, step 0.1
GEO_H, GEO_W, GEO_FRAMES, GEO_STEP, GEO_LANDMARKS = 480, 640, 72, 0.1, 24000


class GeoCircle:
    """chip_smoke.py's closed geometric circle: frames, timestamps, the
    ground-truth centres, and a MonoSLAM with its vocabulary and front end."""

    def __init__(self, n: int):
        self.Rcw, self.tcw = make_geo_trajectory(GEO_FRAMES, "circle", GEO_STEP)
        self.world = GeoWorld(np.random.default_rng(0), GEO_LANDMARKS, shape="ring")
        self.voc = bow.train_vocabulary(self.world.desc[:4000], k=8, levels=3, seed=0, device="cuda")
        self.cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=GEO_W / 2.0, cy=GEO_H / 2.0,
                                                  fps=30.0),
                              orb=ORBConfig(n_features=2000), shapes=StaticShapes(max_local_points=16384))
        self.images = [frame_image(i, GEO_H, GEO_W) for i in range(n)]
        self.timestamps = np.arange(n) / 30.0

    def gt_centers(self):
        return np.einsum("tij,tj->ti", self.Rcw.transpose(0, 2, 1), -self.tcw)

    def system(self, **kw):
        slam = MonoSLAM(self.cfg, vocabulary=self.voc, device="cuda", **kw)
        slam.tracker.extractor = GeoExtractor(self.world, self.cfg.camera.K, self.Rcw, self.tcw, 2000, GEO_H,
                                              GEO_W, px_noise=0.3, bit_noise=2, seed=3, device="cuda")
        return slam


def _logged_decision(need):
    """`Tracking._need_new_keyframe` that appends its inputs and result to
    `tracker.decisions`: a keyframe is not taken where an idle mapper
    would have taken it and the busy one could not (asked again with the
    mapper idle, which leaves the state as it was)."""
    def decide(self):
        m = self.map
        n_kfs = m.n_keyframes()
        ref_kf = m.keyframes.get(self.ref_kf_id)
        ref_matches = ref_kf.tracked_map_points(3 if n_kfs > 2 else 2, m) if ref_kf else 0
        lm = self.local_mapper
        idle = lm.accepting()
        new = dropped = need(self)
        if not idle:  # would an idle mapper have taken a keyframe?
            wanted, lm.accepting = self.keyframe_wanted, lambda: True
            try:
                dropped = need(self)
            finally:
                del lm.accepting
                self.keyframe_wanted = wanted
        self.decisions.append((self.current.id, n_kfs, self.matches_inliers, ref_matches, idle,
                               len(lm.queue), new, dropped and not new))
        return new

    return decide


class _Split:
    """Wall ms a mapping pass spends in each part (see `--split`), summed
    over the passes, on whichever thread runs them; the lock's waits and
    holds of the other threads (the tracker's) apart."""

    def __init__(self, slam):
        self.ms, self.per_pass, self.local = Counter(), [], threading.local()
        self.lock, lm = slam.map.update_lock, slam.local_mapper
        slam.map.update_lock = self
        process = lm._process

        def timed_pass(kf):
            before = Counter({k: v for k, v in self.ms.items() if not k.startswith("other")})
            self.local.in_pass, t = True, time.perf_counter()
            try:
                return process(kf)
            finally:
                self.local.in_pass = False
                self.ms["pass"] += (time.perf_counter() - t) * 1e3
                self.per_pass.append(Counter({k: v for k, v in self.ms.items()
                                              if not k.startswith("other")}) - before)

        lm._process = timed_pass

    def key(self, name: str) -> str:
        return name if getattr(self.local, "in_pass", False) else "other thread " + name

    def timed(self, name: str, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms[self.key(name)] += (time.perf_counter() - t) * 1e3
        return call

    def eigensolver(self, fn):
        """The triangulation's eigensolver, after a synchronisation of the
        current stream: the wait for the work queued before it apart from
        the solver's own time (its host check included)."""
        def call(*a, **kw):
            t = time.perf_counter()
            torch.cuda.current_stream().synchronize()
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.ms[self.key("of which the wait before the eigensolver")] += (t1 - t) * 1e3
                self.ms[self.key("of which the eigensolver")] += (time.perf_counter() - t1) * 1e3
        return call

    def __enter__(self):
        t = time.perf_counter()
        self.lock.acquire()
        now = time.perf_counter()
        self.ms[self.key("lock wait")] += (now - t) * 1e3
        self.ms[self.key("lock takes")] += 1
        depth = getattr(self.local, "depth", 0)
        if depth == 0:
            self.local.held_at = now
        self.local.depth = depth + 1
        return self

    def __exit__(self, *exc):
        self.local.depth -= 1
        if self.local.depth == 0:
            self.ms[self.key("lock held")] += (time.perf_counter() - self.local.held_at) * 1e3
        self.lock.release()

    @staticmethod
    def _parts(passes) -> dict:
        n = max(len(passes), 1)
        parts = {k: round(sum(p[k] for p in passes) / n, 2)
                 for k in sorted({k for p in passes for k in p})}
        inner = sum(v for k, v in parts.items()
                    if k not in ("pass", "lock held", "lock takes") and not k.startswith("of which"))
        parts["rest (host Python)"] = round(parts.get("pass", 0.0) - inner, 2)
        return parts

    def report(self, frame_holds: list) -> str:
        """The first pass's split, the mean split of the later ones, and the
        ms the tracker's thread held the lock a frame (median and p95 over
        frames 10+)."""
        steady = np.asarray(frame_holds[10:] or [0.0])
        return (f"first pass {self._parts(self.per_pass[:1])}; ms a pass over the {len(self.per_pass) - 1} "
                f"later passes {self._parts(self.per_pass[1:])}; the tracker's thread held the lock "
                f"median {np.median(steady):.2f} ms, p95 {np.percentile(steady, 95):.2f} ms a frame (frames "
                f"10+), waited for it {self.ms['other thread lock wait'] / max(len(frame_holds), 1):.2f} ms "
                f"a frame on average")


_SPLIT_CALLS = ((mapping_batch, "triangulate_with_neighbors", "triangulation call"),
                (mapping_batch, "fuse_into_targets", "fuse call"),
                (optim, "bundle_adjustment", "local BA call"),
                (graphs, "fetch", "fetch"),
                (twoview, "smallest_eigvecs", None))


def run(name: str, seq, cfg, n: int, no_wait: bool, prewarm: bool, sample: bool, split: bool):
    threaded = name != "serial"
    kw = dict(threaded=threaded, graphs=name != "eager")
    slam = seq.system(**kw) if isinstance(seq, GeoCircle) else MonoSLAM(cfg, device="cuda", **kw)
    slam.tracker.decisions = []
    interrupts, interrupt = [], slam.local_mapper.interrupt_ba

    def counted_interrupt():
        interrupts.append(slam.tracker.current.id)
        interrupt()

    slam.local_mapper.interrupt_ba = counted_interrupt
    if no_wait:
        slam._wait_for_wanted_keyframe = lambda: None
    if prewarm:
        h, w = np.asarray(seq.images[0]).shape[-2:]
        print(f"{name}: prewarm phases (s since its start) {slam.prewarm(h, w)}", flush=True)
    splitter, plain = (_Split(slam), [getattr(mod, fn) for mod, fn, _ in _SPLIT_CALLS]) if split else (None, [])
    for (mod, fn, key), f in zip(_SPLIT_CALLS, plain):
        setattr(mod, fn, splitter.eigensolver(f) if key is None else splitter.timed(key, f))
    sampler = ThreadSampler(0.002) if sample and threaded else None
    poses, frame_ms = [], []
    t0 = time.perf_counter()
    if sampler:
        sampler.__enter__()
    frame_holds = []  # ms the tracker's thread held map.update_lock a frame (`--split`)
    fused = []  # the frames that fused
    for i in range(n):
        held = splitter.ms["other thread lock held"] if splitter else 0.0
        n_fused = slam.tracker.n_fused_frames
        t = time.perf_counter()
        poses.append(slam.track_monocular(seq.images[i], float(seq.timestamps[i])))
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if slam.tracker.n_fused_frames > n_fused:
            fused.append(i)
        if splitter:
            frame_holds.append(splitter.ms["other thread lock held"] - held)
        if name == "paced":
            slam.wait_mapper_idle(timeout=600.0)
    if sampler:
        sampler.__exit__(None, None, None)
    slam.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for (mod, fn, _), f in zip(_SPLIT_CALLS, plain):
        setattr(mod, fn, f)
    first_fused = f"{frame_ms[fused[0]]:.1f}" if fused else "n/a"
    idx = [i for i, T in enumerate(poses) if T is not None]
    first = min(idx) if idx else n
    tracked_pct = 100.0 * len(idx) / max(n - first, 1)
    est = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in poses if T is not None])
    gt = seq.gt_centers()[idx]
    ate = 100.0 * ate_rmse(est, gt) / float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    lm, lc = slam.local_mapper, slam.loop_closer
    mapper_s = sum(sum(v for k, v in p.items() if k != "kf") for p in lm.pass_ms) / 1e3
    stages = ("process_new", "cull_mp", "triangulate", "fuse", "lba", "cull_kf")
    stage_ms = [{st: round(float(np.mean([p[st] for p in passes if st in p] or [0.0])), 2) for st in stages}
                for passes in (lm.pass_ms, lm.pass_ms[1:])]
    print(f"{name}: init frame {first}, tracked {tracked_pct:.1f}% after init, mean stage ms {stage_ms[0]}, "
          f"after the first pass {stage_ms[1]}, local BAs {lm.n_local_ba} ({lm.n_ba_aborted} cut short)")
    print(f"{name}: ATE {ate!r} %, sum of centres {float(est.sum())!r}, keyframes {slam.map.n_keyframes()}, "
          f"loops closed {lc.n_loops_closed if lc else 0}, passes {len(lm.pass_ms)}, mapper {mapper_s:.2f} s, "
          f"wall {wall:.2f} s, frame ms (10+) median {np.median(frame_ms[10:]):.1f}, p95 "
          f"{np.percentile(frame_ms[10:], 95):.1f}, max {max(frame_ms):.1f}, first fused frame {first_fused} ms, "
          f"keyframes not taken {sum(d[-1] for d in slam.tracker.decisions)}, local BAs interrupted by the "
          f"tracker {len(interrupts)}, keyframe waits {slam.n_keyframe_waits}, longest "
          f"{slam.max_keyframe_wait_ms:.1f} ms, waits ms {[round(w, 1) for w in slam.keyframe_wait_ms]}",
          flush=True)
    if splitter:
        print(f"{name}: split: {splitter.report(frame_holds)}", flush=True)
    print("  decisions (frame, keyframes, inliers, reference tracked points, mapper idle, queued, new, "
          "not taken):",
          slam.tracker.decisions)
    print("  frames (id, method, inliers, ms):", [(st["frame_id"], st["method"], st.get("inliers_local"),
                                                   round(st["track_ms"])) for st in slam.tracker.frame_stats])
    print("  passes (stage ms):", [{k: round(v) for k, v in p.items()} for p in lm.pass_ms])
    if lc is not None:
        print("  closures (stage ms):", [{k: round(v, 1) if isinstance(v, float) else v for k, v in st.items()}
                                         for st in lc.loop_stats])
    if sampler:
        print(sampler.report(top=30)[:12000])
    return ate


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", choices=("spiral", "geo-circle"), default="spiral")
    ap.add_argument("--frames", type=int, default=None, help="default: 32 (spiral), 72 (geo-circle)")
    ap.add_argument("--runs", default="serial,threaded,eager,paced")
    ap.add_argument("--no-wait", action="store_true",
                    help="drop a keyframe the busy mapper cannot take, as the reference does")
    ap.add_argument("--prewarm", action="store_true", help="MonoSLAM.prewarm before frame 0")
    ap.add_argument("--sample", action="store_true", help="per-thread stack samples of threaded runs")
    ap.add_argument("--split", action="store_true", help="where a mapping pass's wall time goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diag_threaded_keyframes: no CUDA device", file=sys.stderr)
        return 1
    if args.world == "geo-circle":
        n = args.frames or GEO_FRAMES
        cfg, seq = None, GeoCircle(n)
    else:
        n = args.frames or 32
        cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=W / 2.0, cy=H / 2.0, fps=30.0),
                         orb=ORBConfig(n_features=2000), shapes=StaticShapes(max_local_points=4096))
        seq = make_rendered_sequence(n, H, W, 500.0, 500.0, motion="spiral", step=0.06, seed=11,
                                     device="cuda")
    tracking.Tracking._need_new_keyframe = _logged_decision(tracking.Tracking._need_new_keyframe)
    print(torch.cuda.get_device_name(0), flush=True)
    for name in args.runs.split(","):
        run(name, seq, cfg, n, args.no_wait, args.prewarm, args.sample, args.split)
    return 0


if __name__ == "__main__":
    sys.exit(main())
