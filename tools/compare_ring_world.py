"""Run the JAX package and the PyTorch port over one rendered ring-world
spiral on the CPU and print where their per-frame outcomes part.

    JAX_PLATFORMS=cpu python tools/compare_ring_world.py --seed 14 [--frames 60] [--trace-init]
    python tools/compare_ring_world.py --port-only --device cuda --seed 14

The sequence is the multi-stream phase's stream at KITTI width (1241x376,
fx = fy = 500, 2000 features, spiral, step 0.06) rendered once by the JAX
package; both serial MonoSLAMs track the same images, the port fed the JAX
tracker's RANSAC draws. Per frame it prints both tracking methods, inlier
counts and camera centres, then each run's ATE in percent of the trajectory
length (Sim(3)-aligned) and the first frame where the two differ. With
`--trace-init` it also prints every two-view initialization attempt of
each package: matches, success, model and triangulated points. With
`--port-only` (no JAX needed, so it runs on the card) the port alone renders
the sequence on `--device` and tracks it with its own RANSAC draws, as the
multi-stream phase's stream does.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils import config as tconfig  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, make_rendered_sequence  # noqa: E402


class JaxTrackerNoise:
    """The JAX tracker's PRNGKey(0) split chain, one split per draw."""

    def __init__(self):
        import jax

        self.jax = jax
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, k = self.jax.random.split(self.key)
        return torch.from_numpy(np.array(self.jax.random.uniform(k, tuple(shape))))


def make_config(cfg_mod, h: int, w: int):
    return cfg_mod.SlamConfig(
        camera=cfg_mod.CameraConfig(fx=500.0, fy=500.0, cx=w / 2.0, cy=h / 2.0, fps=30.0),
        orb=cfg_mod.ORBConfig(n_features=2000, n_levels=8, scale_factor=1.2, ini_th_fast=20, min_th_fast=7),
        shapes=cfg_mod.StaticShapes(max_local_points=4096))


def run(slam, seq, n_frames: int):
    centres, tracked = [], []
    for k in range(n_frames):
        T = slam.track_monocular(seq.images[k], float(seq.timestamps[k]))
        tracked.append(T is not None)
        centres.append(-T[:3, :3].T @ T[:3, 3] if T is not None else np.full(3, np.nan))
    return np.asarray(centres), tracked


def ate_pct(centres, tracked, gt):
    sel = np.asarray(tracked)
    g = gt[sel]
    traj = float(np.linalg.norm(np.diff(g, axis=0), axis=1).sum())
    return 100.0 * ate_rmse(centres[sel], g) / traj


def trace_initialization(port_only: bool):
    """Print each package's two-view initialization attempts."""
    from ceres_mono_orb_slam2_tpu_torch.models import tracking as ttracking

    mods = [("port", ttracking)]
    if not port_only:
        from ceres_mono_orb_slam2_tpu.models import tracking as jtracking

        mods.insert(0, ("jax", jtracking))
    for name, mod in mods:
        orig = mod.twoview.initialize_two_view

        def traced(*a, _orig=orig, _name=name, **kw):
            res = _orig(*a, **kw)
            print(f"init {_name}: matches {int(a[-1].sum())}, success {bool(res.success)}, "
                  f"homography {bool(res.used_homography)}, triangulated "
                  f"{int(res.triangulated.sum())}", flush=True)
            return res

        mod.twoview.initialize_two_view = traced


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--step", type=float, default=0.06)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--trace-init", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.trace_init:
        trace_initialization(args.port_only)
    torch.set_num_threads(4)
    h, w = args.height, args.width
    if args.port_only:
        seq = make_rendered_sequence(args.frames, h, w, 500.0, 500.0, motion="spiral", step=args.step,
                                     seed=args.seed, device=args.device)
        slam = MonoSLAM(make_config(tconfig, h, w), device=args.device)
        centres, tracked = run(slam, seq, args.frames)
        st = slam.tracker.frame_stats
        print(f"port on {args.device}: first tracked frame {tracked.index(True) if any(tracked) else None}, "
              f"tracked {sum(tracked)}/{args.frames}, keyframes {slam.map.n_keyframes()}, map points "
              f"{slam.map.n_map_points()}, methods {[s['method'] for s in st]}; ATE "
              f"{ate_pct(centres, tracked, seq.gt_centers()):.4f}% of the trajectory")
        return
    from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
    from ceres_mono_orb_slam2_tpu.utils import config as jconfig
    from ceres_mono_orb_slam2_tpu.utils.synthetic import make_rendered_sequence_device
    from ceres_mono_orb_slam2_tpu_torch.utils.convert import config_from_reference

    seq = make_rendered_sequence_device(args.frames, h, w, 500.0, 500.0, motion="spiral",
                                        step=args.step, seed=args.seed)
    cfg = make_config(jconfig, h, w)
    jslam = JaxSLAM(cfg)
    tslam = MonoSLAM(config_from_reference(cfg), device="cpu")
    tslam.tracker.uniform_noise = JaxTrackerNoise()
    runs = {}
    for name, slam in (("jax", jslam), ("port", tslam)):
        centres, tracked = run(slam, seq, args.frames)
        runs[name] = (centres, tracked, slam.tracker.frame_stats,
                      slam.map.n_keyframes(), slam.map.n_map_points())
        print(f"{name}: tracked {sum(tracked)}/{args.frames}, keyframes {runs[name][3]}, "
              f"map points {runs[name][4]}", flush=True)
    gt = seq.gt_centers()
    (jc, jt, js, _, _), (tc, tt, ts, _, _) = runs["jax"], runs["port"]
    jstat = {s["frame_id"]: s for s in js}
    tstat = {s["frame_id"]: s for s in ts}
    first_diff = None
    for k in range(args.frames):
        a, b = jstat.get(k, {}), tstat.get(k, {})
        key = lambda s: (s.get("method"), s.get("ok"), s.get("inliers_frame"), s.get("inliers_local"))  # noqa: E731
        d = float(np.linalg.norm(jc[k] - tc[k])) if jt[k] and tt[k] else float("nan")
        print(f"frame {k:3d}: jax {key(a)} port {key(b)} centre distance {d:.3e}")
        if first_diff is None and (key(a) != key(b) or jt[k] != tt[k]):
            first_diff = k
    print(f"ATE jax {ate_pct(jc, jt, gt):.4f}% port {ate_pct(tc, tt, gt):.4f}% of the trajectory; "
          f"first frame whose outcome differs: {first_diff}")


if __name__ == "__main__":
    main()
