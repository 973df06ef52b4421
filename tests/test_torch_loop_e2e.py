"""Loop closing end to end through the port's full system, on the CPU.

The port alone over the scenario of tests/test_loop_e2e.py: the geometric
front end (`utils/geosim`) on a closed 72-frame circle drives detect -> Sim(3)
-> correct -> essential graph -> global BA through `MonoSLAM`. The asserts
are that test's: state OK at the end, at most 5 frames untracked, at least
one loop closed, ATE under 2% of the trajectory length; plus a completed
global BA and the `map_changed()` protocol (true once, then false)."""

import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

torch.set_num_threads(2)
N_FRAMES, STEP, H, W = 72, 0.1, 480, 640  # 0.1 rad a frame: revisit after ~63 frames


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    cfg = SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=600),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )
    Rcw, tcw = make_geo_trajectory(N_FRAMES, "circle", STEP)
    world = GeoWorld(rng, 2500, shape="ring")
    voc = bow.train_vocabulary(world.desc[:1500], k=8, levels=3, seed=0, device="cpu")
    slam = MonoSLAM(cfg, vocabulary=voc, device="cpu")
    slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                          px_noise=0.3, bit_noise=2, seed=3, device="cpu")
    gt_c = np.einsum("tij,tj->ti", Rcw.transpose(0, 2, 1), -tcw)
    est, gt = [], []
    for k in range(N_FRAMES):
        T = slam.track_monocular(frame_image(k, H, W), k / 30.0)
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(gt_c[k])
    return slam, np.stack(est), np.stack(gt)


def test_circle_loop_closes_through_full_system(run):
    slam, est, gt = run
    assert slam.get_tracking_state() == "OK"
    assert len(est) >= N_FRAMES - 5, "tracking must survive the full circle"
    assert slam.loop_closer.n_loops_closed >= 1, "loop closure never fired"
    traj = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    rmse = ate_rmse(est, gt)
    assert rmse < 0.02 * traj, (rmse, traj)


def test_global_ba_ran_and_map_change_is_reported_once(run):
    slam, _, _ = run
    lc = slam.loop_closer
    assert lc.n_gba_runs >= 1
    stat = lc.loop_stats[0]
    assert stat["solver"] == "dense" and stat["edges"] > 0
    assert stat["P"] == slam.map.n_keyframes() or stat["P"] > 0
    assert slam.map_changed()
    assert not slam.map_changed()
    kf = slam.map.keyframes[stat["kf"]]
    assert stat["match_kf"] in kf.loop_edges
    slam.shutdown()
    assert slam.get_tracking_state() == "OK"
