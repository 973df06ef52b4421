"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels of `ceres_mono_orb_slam2_tpu_torch/csrc/` with nvcc;
  2. hold each kernel bit-exact to its plain PyTorch version at the 8 KITTI
     pyramid-level shapes (B=1 and B=8, both patch radii, u8-valued and float
     inputs) and time both with CUDA events;
  3. render 60 frames of the spiral ring world at 1241x376 on the GPU and run
     the serial `MonoSLAM` over them with 2000 ORB features, asserting
     initialisation, tracking, mapping, kernel use and trajectory accuracy;
  4. print the card's name and power limit.
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

# the 8 pyramid levels of a 1241x376 frame at scale 1.2, and the per-level
# keypoint budgets of 2000 features
KITTI_LEVELS = [(376, 1241), (313, 1034), (261, 862), (218, 718), (181, 598),
                (151, 499), (126, 416), (105, 346)]
N_PER_LEVEL = [434, 362, 302, 251, 209, 175, 145, 122]
TIMING_RUNS = 25


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median CUDA-event time of fn() over `runs` launches after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_build():
    from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.load()._name
    log(f"[build] {path} nvcc {cuda_build.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")


def phase_kernels():
    """Bit-exact checks at every level shape; returns per-kernel JSON rows
    with the B=1 main-path time summed over the 8 levels."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k

    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"fast_nms": 0.0, "gather_patches": 0.0}
    ms = {"fast_nms": [0.0, 0.0], "gather_patches": [0.0, 0.0]}
    for (H, W), n in zip(KITTI_LEVELS, N_PER_LEVEL):
        for B in (1, 8):
            u8 = torch.randint(0, 256, (B, H, W), device="cuda", generator=g).float()
            fl = torch.rand((B, H, W), device="cuda", generator=g) * 255.0
            ys = torch.randint(19, H - 19, (B, n), device="cuda", generator=g, dtype=torch.int32)
            xs = torch.randint(19, W - 19, (B, n), device="cuda", generator=g, dtype=torch.int32)
            for img in (u8, fl):
                a = k.fast_nms(img)
                b = k.nms3(k.fast_score_map(img))
                e = float((a - b).abs().max())
                if not torch.equal(a, b):
                    raise AssertionError(f"fast_nms differs at {(B, H, W)}: max err {e}")
                err["fast_nms"] = max(err["fast_nms"], e)
                for r in (15, 19):
                    a = k.gather_patches(img, ys, xs, r)
                    b = k.gather_patches_plain(img, ys, xs, r)
                    e = float((a - b).abs().max())
                    if not torch.equal(a, b):
                        raise AssertionError(f"gather_patches r={r} differs at {(B, H, W)}: {e}")
                    err["gather_patches"] = max(err["gather_patches"], e)
            t_fast = time_ms(lambda: k.fast_nms(fl))
            t_fast_p = time_ms(lambda: k.nms3(k.fast_score_map(fl)))
            t_g = sum(time_ms(lambda r=r: k.gather_patches(fl, ys, xs, r)) for r in (15, 19))
            t_g_p = sum(time_ms(lambda r=r: k.gather_patches_plain(fl, ys, xs, r)) for r in (15, 19))
            log(f"[kernels] B={B} {H}x{W} n={n}: fast_nms {t_fast:.4f} ms (plain {t_fast_p:.4f}); "
                f"gather r15+r19 {t_g:.4f} ms (plain {t_g_p:.4f}); "
                f"bit-exact (torch.equal, tolerance 0)")
            if B == 1:
                ms["fast_nms"][0] += t_fast
                ms["fast_nms"][1] += t_fast_p
                ms["gather_patches"][0] += t_g
                ms["gather_patches"][1] += t_g_p
    torch.cuda.synchronize()
    rows = [
        {"name": "fast_nms", "route": "cuda",
         "source": "ceres_mono_orb_slam2_tpu_torch/csrc/fast_nms.cu",
         "replaces": "ceres_mono_orb_slam2_tpu/ops/orb/kernels.py:75",
         "max_abs_err": err["fast_nms"], "ms": ms["fast_nms"][0], "plain_ms": ms["fast_nms"][1]},
        {"name": "gather_patches", "route": "cuda",
         "source": "ceres_mono_orb_slam2_tpu_torch/csrc/gather_patches.cu",
         "replaces": "ceres_mono_orb_slam2_tpu/ops/orb/kernels.py:270",
         "max_abs_err": err["gather_patches"], "ms": ms["gather_patches"][0],
         "plain_ms": ms["gather_patches"][1]},
    ]
    log("[kernels] per-frame (B=1, 8 levels) ms: " + ", ".join(
        f"{r['name']} {r['ms']:.4f} (plain {r['plain_ms']:.4f})" for r in rows))
    return rows


def phase_slam():
    """The serial MonoSLAM over 60 rendered KITTI-width frames."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
    from ceres_mono_orb_slam2_tpu_torch.utils.config import (
        CameraConfig, ORBConfig, SlamConfig, StaticShapes)
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, make_rendered_sequence

    h, w, n_frames = 376, 1241, 60
    t0 = time.perf_counter()
    seq = make_rendered_sequence(n_frames, h, w, 500.0, 500.0, motion="spiral", step=0.06,
                                 seed=11, device="cuda")
    log(f"[slam] rendered {n_frames} frames {w}x{h} in {time.perf_counter() - t0:.1f} s")
    cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=w / 2.0, cy=h / 2.0, fps=30.0),
                     orb=ORBConfig(n_features=2000, n_levels=8, scale_factor=1.2,
                                   ini_th_fast=20, min_th_fast=7),
                     shapes=StaticShapes(max_local_points=4096))

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
    checks = {
        "initialises within 10 frames": first < 10,
        "tracks >= 90% after init": frac >= 0.9,
        ">= 3 keyframes": slam.map.n_keyframes() >= 3,
        "n_local_ba >= 1": slam.local_mapper.n_local_ba >= 1,
        "n_fused_frames > 0": slam.tracker.n_fused_frames > 0,
        "fast_nms launched": launches["fast_nms"] > 0,
        "gather_patches launched": launches["gather_patches"] > 0,
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
    rows = phase_kernels()
    launches = phase_slam()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
