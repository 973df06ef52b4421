"""Port parity of the distorted-lens path (tests/test_distortion_e2e.py):
frames rendered through the TUM2 lens, each output pixel's ray traced
through the inverse lens model, and both systems tracking them with the
lens's coefficients configured (keypoint undistortion, undistorted image
bounds).

Stated bars: the port's lens render equals the JAX package's within 2e-2
grey levels at any pixel and 1e-3 on average (both invert the lens by the
same 8 fixed-point iterations in float32; the libraries round the steps
differently, and a last-ulp change of a ray moves a texture sample by the
texture gradient); the lens warps the image by more than 5 grey levels on
average. Over 20 frames of the JAX render at 320x240, the port fed the JAX
draws: the same tracked-frame count, both ATEs under 1% of the trajectory
length and within 0.5% of it of each other, and the image bounds equal to
1e-4. About 35 s alone on two threads."""

import jax
import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_rendered_sequence_device
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils.convert import config_from_reference
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, make_rendered_sequence

torch.set_num_threads(2)
# the reference's configs/TUM2.yaml: Freiburg2 Kinect coefficients
TUM2_DIST = np.array([0.231222, -0.784899, -0.003257, -0.000105, 0.917205], np.float32)
H, W = 240, 320
FX = FY = 260.0  # TUM2's fx at half resolution; the coefficients act on normalised coordinates
N_FRAMES = 20


class JaxTrackerNoise:
    """The JAX tracker's PRNGKey(0) split chain, one split per draw."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, k = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))


def test_lens_render_matches_jax():
    ref = make_rendered_sequence_device(2, H, W, FX, FY, seed=5, noise=0.0, dist=TUM2_DIST)
    new = make_rendered_sequence(2, H, W, FX, FY, seed=5, noise=0.0, dist=TUM2_DIST)
    pinhole = make_rendered_sequence(2, H, W, FX, FY, seed=5, noise=0.0)
    d = np.abs(new.images - ref.images)
    assert d.max() < 2e-2 and d.mean() < 1e-3, (d.max(), d.mean())
    assert np.abs(new.images - pinhole.images).mean() > 5.0  # the lens is material
    np.testing.assert_array_equal(new.poses_tcw, ref.poses_tcw)


@pytest.fixture(scope="module")
def runs():
    seq = make_rendered_sequence_device(N_FRAMES, H, W, FX, FY, motion="strafe", step=0.16, seed=5,
                                        noise=1.0, dist=TUM2_DIST)
    cfg = SlamConfig(
        camera=CameraConfig(fx=FX, fy=FY, cx=W / 2.0, cy=H / 2.0, fps=30.0,
                            k1=float(TUM2_DIST[0]), k2=float(TUM2_DIST[1]), p1=float(TUM2_DIST[2]),
                            p2=float(TUM2_DIST[3]), k3=float(TUM2_DIST[4])),
        orb=ORBConfig(n_features=1200),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096))
    jslam = JaxSLAM(cfg)
    tslam = MonoSLAM(config_from_reference(cfg), device="cpu")
    tslam.tracker.uniform_noise = JaxTrackerNoise()
    out = []
    for slam in (jslam, tslam):
        poses = [slam.track_monocular(seq.images[k], seq.timestamps[k]) for k in range(N_FRAMES)]
        out.append((slam, poses))
    return seq, out


def _ate_pct(seq, poses):
    idx = [k for k, T in enumerate(poses) if T is not None]
    est = np.stack([-poses[k][:3, :3].T @ poses[k][:3, 3] for k in idx])
    gt = seq.gt_centers()[idx]
    return 100.0 * ate_rmse(est, gt) / np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()


def test_tracks_through_the_lens_like_jax(runs):
    seq, ((jslam, jposes), (tslam, tposes)) = runs
    jt, tt = [T is not None for T in jposes], [T is not None for T in tposes]
    assert sum(jt) == sum(tt) > 0
    assert tslam.get_tracking_state() == "OK"
    first = tt.index(True)
    assert first < 10 and all(tt[first:])  # no loss after initialisation
    ja, ta = _ate_pct(seq, jposes), _ate_pct(seq, tposes)
    assert ja < 1.0 and ta < 1.0 and abs(ja - ta) < 0.5, (ja, ta)
    assert tslam.tracker.n_fused_frames > 0  # the fused step undistorts on the device


def test_undistorted_bounds_match_jax(runs):
    _, ((jslam, _), (tslam, _)) = runs
    b = tslam.tracker.bounds
    np.testing.assert_allclose(b, np.asarray(jslam.tracker.bounds), atol=1e-4)
    assert np.abs(b - np.array([0.0, W, 0.0, H], np.float32)).max() > 0.5, b
