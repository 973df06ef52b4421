"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels of `ceres_mono_orb_slam2_tpu_torch/csrc/` with
     nvcc (one process per source, started together);
  2. hold each kernel bit-exact to its plain PyTorch version on packed
     pyramids: the 8-level KITTI 1241x376 pyramid at B=1 and B=8 and the
     8-level TUM 640x480 one at B=1, u8-valued and float pyramids, FAST
     margins 0 and EDGE, both patch sets, keypoints on the clamp edge; then
     on frame 0's own pyramid and keypoints, where each kernel and its plain
     version are timed (`time_ms`) beside the kernel's bound;
  3. solve one bundle-adjustment problem on the card twice and require
     bit-identical results;
  4. run the serial `MonoSLAM` over 60 rendered frames of the spiral ring
     world at 1241x376 with 2000 ORB features, asserting initialisation,
     tracking, mapping, exactly one launch of each kernel per frame and
     trajectory accuracy;
  5. print the card's name and power limit.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Needs one CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H, W, N_FRAMES = 376, 1241, 60  # the KITTI-width spiral sequence
# NVIDIA H100 SXM peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
SCORE_OPS = 118  # f32 min/max/sub of one FAST score in csrc/fast_nms.cu
NMS_OPS = 8  # f32 max/compare of one suppression

TIMING_CALLS = 50  # fn() calls captured back to back in one CUDA graph
TIMING_REPLAYS = 5


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, calls: int = TIMING_CALLS, replays: int = TIMING_REPLAYS) -> float:
    """Device ms of one fn() call.

    After warm-up, `calls` calls of fn are captured back to back into one
    CUDA graph, so their outputs are allocated once, at capture, and no host
    work (Python, ctypes, allocation) sits between the launches. Each replay
    runs between one CUDA-event pair; the result is the median replay over
    `calls`. The inputs stay in the 50 MB L2 from one call to the next, as
    on the main path, where the extractor has just written the pyramid.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def phase_build():
    from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.load()._name
    log(f"[build] {path} nvcc {cuda_build.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")


def slam_config():
    from ceres_mono_orb_slam2_tpu_torch.utils.config import (
        CameraConfig, ORBConfig, SlamConfig, StaticShapes)

    return SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=W / 2.0, cy=H / 2.0, fps=30.0),
                      orb=ORBConfig(n_features=2000, n_levels=8, scale_factor=1.2,
                                    ini_th_fast=20, min_th_fast=7),
                      shapes=StaticShapes(max_local_points=4096))


def random_pyramid(layout, B: int, integer: bool, g) -> torch.Tensor:
    if integer:
        return torch.randint(0, 256, (B, layout.total), device="cuda", generator=g).float()
    return torch.rand((B, layout.total), device="cuda", generator=g) * 255.0


def random_keypoints(layout, counts, B: int, g):
    """Level-major (B, N) int32 centres: per level the 4 level corners (their
    patches clamp on two sides), then random ones inside the EDGE margin."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.kernels import EDGE

    ys, xs = [], []
    for (h, w), n in zip(layout.shapes, counts):
        y = torch.randint(EDGE, h - EDGE, (B, n), device="cuda", generator=g)
        x = torch.randint(EDGE, w - EDGE, (B, n), device="cuda", generator=g)
        m = min(n, 4)
        y[:, :m] = torch.tensor([0, 0, h - 1, h - 1][:m], device="cuda")
        x[:, :m] = torch.tensor([0, w - 1, 0, w - 1][:m], device="cuda")
        ys.append(y)
        xs.append(x)
    return (torch.cat(ys, 1).to(torch.int32).contiguous(),
            torch.cat(xs, 1).to(torch.int32).contiguous())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, where: str) -> float:
    """Max |got - want|, raising unless the two are equal (tolerance 0)."""
    e = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version at {where}: max err {e}")
    return e


def bound(n_bytes: float, n_ops: float):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_nms_work(layout, B: int, edge: int):
    """(bytes, ops) of fast_nms_pyramid with margin `edge`: one FAST score
    for every pixel that an output outside the margin reads (rows and
    columns edge-1 .. size-edge) and one suppression for every such output;
    the pixels those scores read (edge-4 .. size-edge+3, every pixel at
    edge 0) read once, and the whole output written once."""
    def band(pad: int) -> int:  # pixels per frame within size - 2 * edge + pad
        return sum(max(min(h, h - 2 * edge + pad), 0) * max(min(w, w - 2 * edge + pad), 0)
                   for h, w in layout.shapes)

    return 4 * B * (band(8) + layout.total), B * (SCORE_OPS * band(2) + NMS_OPS * band(0))


def gather_work(layout, ys: torch.Tensor, xs: torch.Tensor, counts):
    """(bytes, ops) of gather_pyramid_patches on these keypoints: the
    distinct pyramid pixels the patches cover (each read once), the centres,
    and both outputs written once (31x31 float32, 39x39 uint8); a bf16
    rounding per value, and to_u8's add and clamp per 39x39 value."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.kernels import DESC_R, HALF_PATCH

    B, N = ys.shape
    b = torch.arange(B, device=ys.device)[:, None]
    covered, start = 0, 0
    for (h, w), n in zip(layout.shapes, counts):
        centres = torch.zeros((B, 1, h, w), device=ys.device)
        centres[b, 0, ys[:, start:start + n].long(), xs[:, start:start + n].long()] = 1.0
        for r in (HALF_PATCH, DESC_R):
            covered += int((F.max_pool2d(centres, 2 * r + 1, stride=1, padding=r) > 0).sum())
        start += n
    s31, s39 = (2 * HALF_PATCH + 1) ** 2, (2 * DESC_R + 1) ** 2
    return 4 * covered + 8 * B * N + B * N * (4 * s31 + s39), B * N * (s31 + 4 * s39)


def phase_kernels(seq, cfg):
    """Bit-exact checks of both kernels on packed pyramids, then their
    main-path times on frame 0 (B=1), beside their bounds. Returns the
    per-kernel JSON rows."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor, _level_sizes
    from ceres_mono_orb_slam2_tpu_torch.utils.config import ORBConfig

    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"fast_nms": 0.0, "gather_patches": 0.0}
    kitti = k.PyramidLayout.of(_level_sizes(H, W, 8, 1.2))
    tum = k.PyramidLayout.of(_level_sizes(480, 640, 8, 1.2))
    kitti_n = [int(n) for n in cfg.orb.features_per_level]
    tum_n = [int(n) for n in ORBConfig(n_features=1000).features_per_level]
    for name, layout, counts, B in (("KITTI 1241x376", kitti, kitti_n, 1),
                                    ("KITTI 1241x376", kitti, kitti_n, 8),
                                    ("TUM 640x480", tum, tum_n, 1)):
        for integer in (True, False):
            raw = random_pyramid(layout, B, integer, g)
            blurred = random_pyramid(layout, B, integer, g)
            where = f"{name} B={B} {'u8-valued' if integer else 'float'}"
            for edge in (0, k.EDGE):
                err["fast_nms"] = max(err["fast_nms"], check_equal(
                    "fast_nms", k.fast_nms_pyramid(raw, layout, edge),
                    k.fast_nms_pyramid_plain(raw, layout, edge), f"{where} edge={edge}"))
            ys, xs = random_keypoints(layout, counts, B, g)
            got = k.gather_pyramid_patches(raw, blurred, layout, ys, xs, counts)
            want = k.gather_pyramid_patches_plain(raw, blurred, layout, ys, xs, counts)
            for a, b, r in zip(got, want, (k.HALF_PATCH, k.DESC_R)):
                err["gather_patches"] = max(err["gather_patches"],
                                            check_equal(f"gather_patches r={r}", a, b, where))
        log(f"[kernels] {name} B={B}, {len(layout.shapes)} levels, N={sum(counts)}: fast_nms "
            f"(edge 0 and {k.EDGE}) and gather_patches (r=15 float32, r=19 uint8, corner "
            f"keypoints clamped) bit-exact on u8-valued and float pyramids (torch.equal)")
    # the one-level calls of both kernels
    img = random_pyramid(kitti, 2, False, g)[:, :H * W].reshape(2, H, W).contiguous()
    one = k.PyramidLayout.of([(H, W)])
    ys, xs = random_keypoints(one, [300], 2, g)
    check_equal("fast_nms", k.fast_nms(img), k.nms3(k.fast_score_map(img)), "one level")
    for r in (k.HALF_PATCH, k.DESC_R):
        check_equal(f"gather_patches r={r}", k.gather_patches(img, ys, xs, r),
                    k.gather_patches_plain(img, ys, xs, r), "one level")
    log(f"[kernels] one-level fast_nms and gather_patches (r=15, 19) at 2x{H}x{W}: bit-exact")

    # the main path's inputs: frame 0's packed pyramid and its keypoints
    ex = ORBExtractor(cfg.orb, device="cuda")
    frame = np.clip(seq.images[0] + 0.5, 0.0, 255.0).astype(np.uint8)
    layout, raw, blurred = ex.pyramid(torch.from_numpy(frame)[None].cuda().float())
    ys, xs, _, valid, counts = ex.detect(raw, layout)
    ys = torch.where(valid, ys, k.EDGE).to(torch.int32).contiguous()
    xs = torch.where(valid, xs, k.EDGE).to(torch.int32).contiguous()
    fast = (lambda: k.fast_nms_pyramid(raw, layout, k.EDGE),
            lambda: k.fast_nms_pyramid_plain(raw, layout, k.EDGE))
    gather = (lambda: k.gather_pyramid_patches(raw, blurred, layout, ys, xs, counts),
              lambda: k.gather_pyramid_patches_plain(raw, blurred, layout, ys, xs, counts))
    check_equal("fast_nms", fast[0](), fast[1](), "frame 0")
    for a, b in zip(gather[0](), gather[1]()):
        check_equal("gather_patches", a, b, "frame 0")
    torch.cuda.synchronize()
    rows = []
    for name, fns, work, line in (
            ("fast_nms", fast, fast_nms_work(layout, 1, k.EDGE), 75),
            ("gather_patches", gather, gather_work(layout, ys, xs, counts), 270)):
        ms, plain_ms = time_ms(fns[0]), time_ms(fns[1])
        bound_ms, bound_by = bound(*work)
        rows.append({"name": name, "route": "cuda",
                     "source": f"ceres_mono_orb_slam2_tpu_torch/csrc/{name}.cu",
                     "replaces": f"ceres_mono_orb_slam2_tpu/ops/orb/kernels.py:{line}",
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
                     "library_ms": None})
        log(f"[kernels] {name}, frame 0 (B=1, 8 levels, {int(valid.sum())} keypoints): "
            f"{ms * 1e3:.2f} us per frame (plain {plain_ms * 1e3:.2f} us); bound {bound_ms * 1e3:.2f} us "
            f"by {bound_by} ({work[0] / 1e6:.3f} MB, {work[1] / 1e9:.4f} GOP), share {bound_ms / ms:.3f}")
    return rows


def ba_problem(seed: int = 0, P: int = 20, M: int = 3000, per_point: int = 4):
    """A local-BA-sized problem on the card: P poses along a line, M points
    seen by `per_point` poses each, pixel noise and 2% gross outliers."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 620.0], [0, 500.0, 188.0], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-6, 6, M), rng.uniform(-2, 2, M), rng.uniform(6, 20, M)], -1)
    R = np.repeat(np.eye(3)[None], P, 0)
    t = np.stack([-0.3 * np.arange(P), np.zeros(P), np.zeros(P)], -1)
    op = np.stack([rng.choice(P, per_point, replace=False) for _ in range(M)]).reshape(-1)
    oj = np.repeat(np.arange(M), per_point)
    Xc = pts[oj] + t[op]
    uv = K[:2, :2].diagonal() * Xc[:, :2] / Xc[:, 2:] + K[:2, 2]
    uv += rng.standard_normal(uv.shape) * 0.7
    bad = rng.random(len(uv)) < 0.02
    uv[bad] += rng.uniform(20, 60, (bad.sum(), 2))
    t0 = t + rng.standard_normal(t.shape) * 0.02
    t0[:2] = t[:2]
    fixed = np.zeros(P, bool)
    fixed[:2] = True
    dev = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")  # noqa: E731
    return (dev(K), dev(R), dev(t0), dev(pts + rng.standard_normal(pts.shape) * 0.05),
            dev(op, torch.int64), dev(oj, torch.int64), dev(uv), dev(rng.choice([1.0, 0.69], len(op))),
            dev(np.ones(len(op), bool), torch.bool), dev(fixed, torch.bool),
            dev(np.ones(M, bool), torch.bool))


def phase_ba():
    """Bundle adjustment twice on one CUDA problem: bit-identical results."""
    from ceres_mono_orb_slam2_tpu_torch.ops import optim

    args = ba_problem()
    runs = [optim.bundle_adjustment(*args) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"[ba] P={args[1].shape[0]} M={args[3].shape[0]} O={args[4].shape[0]}: cost "
        f"{float(runs[0].cost):.6f} / {float(runs[1].cost):.6f}, inliers "
        f"{int(runs[0].inlier_obs.sum())}, two calls bit-identical: {same}")
    if not same:
        raise AssertionError("bundle_adjustment is not deterministic on the card")


def render_sequence():
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence

    t0 = time.perf_counter()
    seq = make_rendered_sequence(N_FRAMES, H, W, 500.0, 500.0, motion="spiral", step=0.06,
                                 seed=11, device="cuda")
    log(f"[slam] rendered {N_FRAMES} frames {W}x{H} in {time.perf_counter() - t0:.1f} s")
    return seq


def phase_slam(seq, cfg):
    """The serial MonoSLAM over the 60 rendered KITTI-width frames."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    n_frames = N_FRAMES
    # the extractor's CUDA path against its CPU path on the first frame
    fc = ORBExtractor(cfg.orb, device="cuda").extract(seq.images[0])
    fh = ORBExtractor(cfg.orb, device="cpu").extract(seq.images[0])
    fc = [a.cpu() for a in fc]
    l0 = fh.octave[0] == 0
    if not (torch.equal(fc[0][0][l0], fh.xy[0][l0]) and torch.equal(fc[4][0][l0], fh.desc[0][l0])):
        raise AssertionError("extractor: level-0 keypoints/descriptors differ between CUDA and CPU")
    same = (fc[0] == fh.xy).all(-1) & (fc[4] == fh.desc).all(-1)
    log(f"[slam] extractor CUDA vs CPU on frame 0: level 0 bit-exact, "
        f"{float(same.float().mean()) * 100:.2f}% of all keypoints identical")

    slam = MonoSLAM(cfg, device="cuda")
    k.reset_launch_counts()
    poses, frame_ms = [], []
    for i in range(n_frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        poses.append(slam.track_monocular(seq.images[i], float(seq.timestamps[i])))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(k.launch_counts)

    tracked = [p is not None for p in poses]
    first = tracked.index(True) if any(tracked) else n_frames
    est, gt = [], []
    for i, T in enumerate(poses):
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(seq.gt_centers()[i])
    est, gt = np.asarray(est), np.asarray(gt)
    traj_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()) if len(gt) > 1 else 0.0
    ate_pct = 100.0 * ate_rmse(est, gt) / traj_len if traj_len > 0 else float("inf")
    n_after = n_frames - first
    frac = sum(tracked[first:]) / max(n_after, 1)
    steady = np.asarray(frame_ms[10:])
    log(f"[slam] init frame {first}, tracked {sum(tracked)}/{n_frames} "
        f"({100 * frac:.1f}% after init), keyframes {slam.map.n_keyframes()}, "
        f"map points {slam.map.n_map_points()}, n_local_ba {slam.local_mapper.n_local_ba}, "
        f"n_fused_frames {slam.tracker.n_fused_frames}, launches {launches}")
    log(f"[slam] ATE {ate_pct:.4f}% of {traj_len:.3f} m; per-frame ms (frames 10+): "
        f"median {np.median(steady):.2f}, p95 {np.percentile(steady, 95):.2f}, "
        f"max {steady.max():.2f}")
    # bit-level fingerprints, to compare runs of the same code
    log(f"[slam] repeat check: ATE {ate_pct!r} %, sum of camera centres {float(est.sum())!r}")
    checks = {
        "initialises within 10 frames": first < 10,
        "tracks >= 90% after init": frac >= 0.9,
        ">= 3 keyframes": slam.map.n_keyframes() >= 3,
        "n_local_ba >= 1": slam.local_mapper.n_local_ba >= 1,
        "n_fused_frames > 0": slam.tracker.n_fused_frames > 0,
        "fast_nms launched once per frame": launches["fast_nms"] == n_frames,
        "gather_patches launched once per frame": launches["gather_patches"] == n_frames,
        "ATE < 1% of trajectory": ate_pct < 1.0,
        "finite poses": all(np.isfinite(T).all() for T in poses if T is not None),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slam checks failed: {failed}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build()
    cfg = slam_config()
    seq = render_sequence()
    rows = phase_kernels(seq, cfg)
    phase_ba()
    launches = phase_slam(seq, cfg)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["launches_per_frame"] = launches[r["name"]] / N_FRAMES
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
