"""Port parity of pipelined tracking (`MonoSLAM(pipelined=True)`,
`Tracking._grab_pipelined`).

The JAX package's pipelined MonoSLAM and the port's run the sequence and
configuration of tests/test_pipelined.py (strafe at 480x640, 1500
features; its first 24 frames, in which both chain 8 times) on the CPU, the
port fed the JAX tracker's RANSAC draws. A
pipelined frame is dispatched before its predecessor is consumed, so a pose
returns one frame late; both trajectories are read from the drained log.
Float reductions are ordered differently by XLA:CPU and PyTorch (see
tests/test_torch_slam.py), so the bars are outcomes: initialisation frame,
tracked frames and keyframes within +-1, map points within 5%, chained
frames within max(2, 20%), no discarded chain in either, the two
trajectories within 0.5% of the path length of each other and each ATE
under 1%. Then the port alone: the chained constant-velocity prediction
against the JAX expression, a paced threaded + pipelined run equal to the
unthreaded pipelined run to the bit, and the geometric front end, which the
port chains too (the JAX package cannot: its `GeoExtractor` has no jitted
frontend)."""

import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.system import MonoSLAM as JaxSLAM
from ceres_mono_orb_slam2_tpu.ops import lie as jlie
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models import fused_track
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.convert import config_from_reference
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse
from test_torch_slam import JaxTrackerNoise, small_config

torch.set_num_threads(2)
TIMEOUT_S = 300.0
N_FRAMES = 24  # of the 40-frame strafe
PACED_FRAMES = 12


# worker threads alive before this file's tests ran (other files of the same
# process); every thread a test here starts must be stopped when it ends
_THREADS_BEFORE = set(threading.enumerate())


@pytest.fixture(autouse=True)
def no_worker_thread_left():
    """After each test no `mapper` or `gba` thread that this file started is
    alive: a leaked one would keep taking the GIL from later tests."""
    yield
    left = [t.name for t in threading.enumerate()
            if t.name in ("mapper", "gba") and t.is_alive() and t not in _THREADS_BEFORE]
    assert not left, f"worker threads left alive: {left}"


def _resolved(slam, seq):
    """(timestamps, estimated centres, ground-truth centres) of the drained
    trajectory log."""
    ts, est = slam.get_frame_trajectory()
    frame_of = {float(t): k for k, t in enumerate(seq.timestamps)}
    gt = seq.gt_centers()[[frame_of[float(t)] for t in ts]]
    return np.asarray(ts), est, gt


def _run(slam, seq, n_frames, pace=False):
    """(per-call poses, chained frames after each call, whether a frame was
    in flight before `shutdown`)."""
    poses, chained = [], []
    for k in range(n_frames):
        poses.append(slam.track_monocular(seq.images[k], seq.timestamps[k]))
        chained.append(slam.tracker.n_chained_frames)
        if pace:
            assert slam.wait_mapper_idle(timeout=TIMEOUT_S)
    pending_before = slam.tracker._pending is not None
    slam.shutdown()
    return poses, chained, pending_before


def _traj_len(seq, n):
    return np.linalg.norm(np.diff(seq.gt_centers()[:n], axis=0), axis=1).sum()


@pytest.fixture(scope="module")
def runs():
    seq = make_sequence(n_frames=40, seed=11, motion="strafe", step=0.12)
    cfg = small_config()
    jslam = JaxSLAM(cfg, pipelined=True)
    jrun = _run(jslam, seq, N_FRAMES)
    tslam = MonoSLAM(config_from_reference(cfg), device="cpu", pipelined=True)
    tslam.tracker.uniform_noise = JaxTrackerNoise()
    trun = _run(tslam, seq, N_FRAMES)
    return seq, (jslam, jrun), (tslam, trun)


def test_pipelined_outcomes_match_jax(runs):
    seq, (jslam, (jposes, _, _)), (tslam, (tposes, _, _)) = runs
    jt, tt = [T is not None for T in jposes], [T is not None for T in tposes]
    assert any(jt) and any(tt)
    assert abs(jt.index(True) - tt.index(True)) <= 1
    assert abs(sum(jt) - sum(tt)) <= 1
    assert abs(jslam.map.n_keyframes() - tslam.map.n_keyframes()) <= 1
    nj, nt = jslam.map.n_map_points(), tslam.map.n_map_points()
    assert abs(nj - nt) <= 0.05 * nj, (nj, nt)
    cj, ct = jslam.tracker.n_chained_frames, tslam.tracker.n_chained_frames
    assert abs(cj - ct) <= max(2, 0.2 * cj), (cj, ct)
    assert jslam.tracker.n_discarded_chained == tslam.tracker.n_discarded_chained == 0

    jts, jc, jgt = _resolved(jslam, seq)
    tts, tc, tgt = _resolved(tslam, seq)
    traj_len = _traj_len(seq, N_FRAMES)
    assert ate_rmse(jc, jgt) < 0.01 * traj_len
    assert ate_rmse(tc, tgt) < 0.01 * traj_len
    both = np.intersect1d(jts, tts)
    assert len(both) >= N_FRAMES - 8
    pick = lambda ts, c: c[np.searchsorted(ts, both)]  # noqa: E731
    assert ate_rmse(pick(tts, tc), pick(jts, jc)) < 0.005 * traj_len


def test_pipelined_drains_and_chains(runs):
    """tests/test_pipelined.py's bars on the port's run."""
    _, _, (tslam, (_, _, pending_before)) = runs
    tr = tslam.tracker
    assert pending_before or tr.n_chained_frames > 0
    assert tr._pending is None  # shutdown drained the pipeline
    assert tslam.get_tracking_state() == "OK"
    assert len(tr.frame_stats) >= N_FRAMES - 6
    assert tr.n_chained_frames >= 5, tr.n_chained_frames
    assert tslam.map.n_keyframes() >= 3 and tslam.local_mapper.n_local_ba >= 1


def test_chained_prediction_matches_jax():
    """The on-device constant-velocity composition of the JAX frontend
    (models/tracking.py:248-251) on seeded near-rotations."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = rng.normal(0.0, 0.3, (2, 3)).astype(np.float32)
        pR, ppR = (np.asarray(jlie.so3_exp(jnp.asarray(v))) + rng.normal(0.0, 1e-4, (3, 3))
                   for v in w)
        pR, ppR = pR.astype(np.float32), ppR.astype(np.float32)
        pt, ppt = rng.normal(0.0, 2.0, (2, 3)).astype(np.float32)
        Rv = jlie.so3_project(jnp.asarray(pR) @ jnp.asarray(ppR).T)
        tv = jnp.asarray(pt) - Rv @ jnp.asarray(ppt)
        jR, jt = jlie.so3_project(Rv @ jnp.asarray(pR)), Rv @ jnp.asarray(pt) + tv
        tR, tt = fused_track.chained_prediction(*(torch.from_numpy(a) for a in (pR, pt, ppR, ppt)))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)


def test_paced_threaded_pipelined(runs):
    """Threaded and pipelined at once (the JAX package's bench mode),
    paced: the mapper thread runs each pass where the unthreaded pipelined
    run maps, after the frame's grab, so every call returns that run's pose
    to the bit and chains where it chains; ATE under 1%, no discarded
    chain, drained."""
    seq, _, (_, (tposes, tchained, _)) = runs
    n = PACED_FRAMES
    slam = MonoSLAM(config_from_reference(small_config()), device="cpu", threaded=True,
                    pipelined=True)
    slam.tracker.uniform_noise = JaxTrackerNoise()
    poses, chained, _ = _run(slam, seq, n, pace=True)
    tr = slam.tracker
    assert tr._pending is None and not slam._worker.is_alive()
    assert slam.get_tracking_state() == "OK"
    assert [T is None for T in poses] == [T is None for T in tposes[:n]]
    for a, b in zip(poses, tposes):
        if a is not None:
            assert np.array_equal(a, b)
    assert chained == tchained[:n] and chained[-1] > 0
    assert sum(T is not None for T in poses) >= n - 5 and tr.n_discarded_chained == 0
    assert slam.local_mapper.n_local_ba >= 1
    _, est, gt = _resolved(slam, seq)
    assert ate_rmse(est, gt) < 0.01 * _traj_len(seq, n)


def test_pipelined_geo_frontend_tracks_and_drains():
    """tests/test_pipelined.py's geometric case over the first 12 of its
    frames (chaining starts at frame 5): the port's fused path takes any
    extractor, so geometric frames chain as well."""
    n_frames, h, w = 12, 480, 640
    cfg = SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=600),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe")
    world = GeoWorld(np.random.default_rng(0), 2500)
    slam = MonoSLAM(cfg, device="cpu", pipelined=True)
    slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, h, w,
                                          px_noise=0.3, bit_noise=2, seed=3, device="cpu")
    tracked = sum(slam.track_monocular(frame_image(k, h, w), k / 30.0) is not None
                  for k in range(n_frames))
    slam.shutdown()
    tr = slam.tracker
    assert tr._pending is None
    assert slam.get_tracking_state() == "OK"
    assert tracked >= n_frames - 5
    assert tr.n_chained_frames > 0 and tr.n_discarded_chained == 0
