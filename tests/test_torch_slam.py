"""Port parity of the slice as a whole: the serial, vocabulary-free MonoSLAM.

The sequence and configuration of tests/test_slam_e2e.py (40 frames of
strafe at 480x640, 1500 features) run through the JAX MonoSLAM and through
the port's MonoSLAM on the CPU, with the port's RANSAC noise source fed the
JAX tracker's own `jax.random` draws.

Float reductions are ordered differently by XLA:CPU and PyTorch, and the
pyramid levels >= 1 differ by up to ~1e-2 between the two antialiased
resizes, which can flip borderline matching and chi2 decisions; so the bar
is agreement of outcomes, not an identical map: initialisation frames,
tracked-frame counts and keyframe counts within +-1, map points within 5%,
the two trajectories within 0.5% of the trajectory length of each other
(RMSE after Sim(3) alignment), and each ATE under 1%."""

import numpy as np
import jax
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils.convert import config_from_reference
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

torch.set_num_threads(2)


def small_config():
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=1500),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )


class JaxTrackerNoise:
    """The uniform draws of the JAX tracker's initializer: the same
    PRNGKey(0) split chain as Tracking._next_key, one split per attempt."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))


def _run(slam, seq):
    poses = [slam.track_monocular(seq.images[k], seq.timestamps[k]) for k in range(seq.n_frames)]
    tracked = [p is not None for p in poses]
    centres = np.array([-p[:3, :3].T @ p[:3, 3] if p is not None else np.full(3, np.nan)
                        for p in poses])
    return tracked, centres


@pytest.fixture(scope="module")
def runs():
    seq = make_sequence(n_frames=40, seed=11, motion="strafe", step=0.12)
    cfg = small_config()
    jslam = JaxSLAM(cfg)
    jrun = _run(jslam, seq)
    tslam = MonoSLAM(config_from_reference(cfg), device="cpu")
    tslam.tracker.uniform_noise = JaxTrackerNoise()
    trun = _run(tslam, seq)
    return seq, (jslam, jrun), (tslam, trun)


def test_tracking_outcomes_match(runs):
    _, (jslam, (jt, _)), (tslam, (tt, _)) = runs
    assert any(jt) and any(tt)
    assert abs(jt.index(True) - tt.index(True)) <= 1
    assert abs(sum(jt) - sum(tt)) <= 1
    assert tslam.get_tracking_state() == "OK"
    assert all(tt[tt.index(True):])
    assert abs(jslam.map.n_keyframes() - tslam.map.n_keyframes()) <= 1
    nj, nt = jslam.map.n_map_points(), tslam.map.n_map_points()
    assert abs(nj - nt) <= 0.05 * nj, (nj, nt)
    assert tslam.local_mapper.n_local_ba >= 1
    assert tslam.tracker.n_fused_frames > 0


def test_trajectories_match(runs):
    seq, (_, (jt, jc)), (_, (tt, tc)) = runs
    gt = seq.gt_centers()
    traj_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    for tracked, est in ((jt, jc), (tt, tc)):
        sel = np.asarray(tracked)
        assert ate_rmse(est[sel], gt[sel]) < 0.01 * traj_len
    both = np.asarray(jt) & np.asarray(tt)
    assert ate_rmse(tc[both], jc[both]) < 0.005 * traj_len


def test_keyframe_trajectory_file(runs, tmp_path):
    _, _, (tslam, _) = runs
    p = tmp_path / "kf.txt"
    tslam.save_keyframe_trajectory_tum(str(p))
    rows = np.array([line.split() for line in p.read_text().strip().split("\n")], np.float64)
    assert rows.shape == (tslam.map.n_keyframes(), 8)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
    ts, pos = tslam.get_frame_trajectory()
    assert len(ts) == len(pos) >= 30 and np.isfinite(pos).all()
