"""Port parity of the integrated multi-stream system (parallel/multisystem.py)
and of the prepare / finish / consume split of the fused tracking path.

The scenario of tests/test_multisystem.py: S=3 strafe sequences of 13 frames
at 640x480 with 1500 features. The port's `MultiStreamSLAM` must make the
decisions of its own three sequential `MonoSLAM`s frame by frame, with camera
centres within 1e-3 (the reference's own bar for its batch against its
sequential runs), and one of its streams agrees with the JAX
`MultiStreamSLAM` within the bars of tests/test_torch_slam.py. Every port
tracker draws its initializer's RANSAC noise from the JAX tracker's
`jax.random` chain."""

import threading

import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.parallel.multisystem import MultiStreamSLAM as JaxMultiStreamSLAM
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig, StaticShapes
from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models import fused_track
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.parallel.multisystem import MultiStreamSLAM
from ceres_mono_orb_slam2_tpu_torch.utils.convert import config_from_reference
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse
from test_torch_slam import JaxTrackerNoise

torch.set_num_threads(2)
N_FRAMES = 13
SEEDS = (11, 12, 13)
JAX_STREAMS = 1  # the JAX system runs the first sequence (a lone stream: its single path)


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


def _config():
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=1500),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )


def _centres(poses):
    return [None if T is None else -T[:3, :3].T @ T[:3, 3] for T in poses]


def _track_batch(ms, sequences, k):
    S = ms.n_streams
    return ms.track_batch([sequences[s].images[k] for s in range(S)],
                          [sequences[s].timestamps[k] for s in range(S)])


@pytest.fixture(scope="module")
def sequences():
    return [make_sequence(n_frames=N_FRAMES, motion="strafe", step=0.12, seed=s) for s in SEEDS]


@pytest.fixture(scope="module")
def port_runs(sequences):
    """(sequential poses per stream, the batch system, its poses per stream)."""
    cfg = config_from_reference(_config())
    seq_poses = []
    for seq in sequences:
        slam = MonoSLAM(cfg, device="cpu")
        slam.tracker.uniform_noise = JaxTrackerNoise()
        seq_poses.append([slam.track_monocular(seq.images[k], seq.timestamps[k])
                          for k in range(N_FRAMES)])
        slam.shutdown()
    ms = MultiStreamSLAM(cfg, n_streams=len(SEEDS), device="cpu")
    for s in ms.streams:
        s.tracker.uniform_noise = JaxTrackerNoise()
    batch_poses = [[] for _ in SEEDS]
    for k in range(N_FRAMES):
        for s, T in enumerate(_track_batch(ms, sequences, k)):
            batch_poses[s].append(T)
    ms.shutdown()
    return seq_poses, ms, batch_poses


def test_multistream_matches_sequential(port_runs):
    """Decisions equal frame by frame, camera centres within 1e-3 of the
    sequential runs (measured ~5e-6: the batched reductions sum in another
    order), and the batched device path really ran."""
    seq_poses, ms, batch_poses = port_runs
    assert ms.n_batched_frames >= 5, ms.n_batched_frames
    assert ms.phase_s["frames"] == ms.n_batched_frames
    assert all(ms.phase_s[k] > 0 for k in ("prepare", "dispatch", "fetch", "consume"))
    for s in range(len(SEEDS)):
        errs = []
        for a, b in zip(_centres(seq_poses[s]), _centres(batch_poses[s])):
            assert (a is None) == (b is None), s
            if a is not None:
                errs.append(np.linalg.norm(a - b))
        assert len(errs) >= N_FRAMES - 4, (s, len(errs))
        assert max(errs) < 1e-3, (s, max(errs))
        assert ms.streams[s].map.n_keyframes() >= 2  # each map grew on its own
        assert ms.streams[s].tracker.n_fused_frames >= 5


def test_streams_share_one_extractor_and_fused_step(port_runs):
    _, ms, _ = port_runs
    for s in ms.streams:
        assert s.extractor is ms.extractor and s.tracker.extractor is ms.extractor
        assert s.tracker._fused_step is ms.fused_step
    assert len({id(s.map) for s in ms.streams}) == len(SEEDS)
    # every frame of every stream went one way or the other
    fused_batched = sum(s.tracker.n_fused_frames for s in ms.streams)
    assert ms.n_single_frames + fused_batched >= len(SEEDS) * N_FRAMES - ms.n_batched_frames


def test_multistream_matches_jax(sequences, port_runs):
    """The JAX `MultiStreamSLAM` over the first sequence against the same
    stream of the port's batch of three: initialisation frame and tracked-frame
    count within 1, keyframe counts within 1, the two trajectories within
    0.5% of the trajectory length of each other (RMSE after Sim(3)
    alignment), each under 1% ATE: the bars of tests/test_torch_slam.py."""
    _, ms, batch_poses = port_runs
    jms = JaxMultiStreamSLAM(_config(), n_streams=JAX_STREAMS)
    jposes = [[] for _ in range(JAX_STREAMS)]
    for k in range(N_FRAMES):
        for s, T in enumerate(_track_batch(jms, sequences, k)):
            jposes[s].append(T)
    jms.shutdown()
    assert jms.n_single_frames == JAX_STREAMS * N_FRAMES
    for s in range(JAX_STREAMS):
        jt = [T is not None for T in jposes[s]]
        tt = [T is not None for T in batch_poses[s]]
        assert abs(jt.index(True) - tt.index(True)) <= 1 and abs(sum(jt) - sum(tt)) <= 1
        assert abs(jms.streams[s].map.n_keyframes() - ms.streams[s].map.n_keyframes()) <= 1
        gt = sequences[s].gt_centers()
        traj_len = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
        both = np.asarray(jt) & np.asarray(tt)
        jc = np.array([c for c, ok in zip(_centres(jposes[s]), both) if ok])
        tc = np.array([c for c, ok in zip(_centres(batch_poses[s]), both) if ok])
        assert ate_rmse(tc, gt[both]) < 0.01 * traj_len
        assert ate_rmse(jc, gt[both]) < 0.01 * traj_len
        assert ate_rmse(tc, jc) < 0.005 * traj_len, (s, ate_rmse(tc, jc), traj_len)


def test_grab_fused_is_finish_of_prepare(sequences):
    """One frame through `_grab_fused` and through `_fused_finish(
    *_fused_prepare())` on two trackers in the same state: equal control
    buffers, and the host inputs of `args` are numpy."""
    cfg = config_from_reference(_config())
    seq = sequences[0]
    slams = [MonoSLAM(cfg, device="cpu") for _ in range(2)]
    k = 0
    for slam in slams:
        slam.tracker.uniform_noise = JaxTrackerNoise()
    while not slams[0].tracker._can_fuse():
        for slam in slams:
            slam.track_monocular(seq.images[k], seq.timestamps[k])
        k += 1
    assert k < N_FRAMES and slams[1].tracker._can_fuse()
    image = np.clip(seq.images[k] + 0.5, 0.0, 255.0).astype(np.uint8)
    captured = [[], []]
    for slam, got in zip(slams, captured):
        consume = slam.tracker._fused_consume
        slam.tracker._fused_consume = (
            lambda aux, out, feats, host, c=consume, g=got: (g.append(host.copy()),
                                                             c(aux, out, feats, host)))
    a, b = slams
    a.tracker._grab_fused(image, seq.timestamps[k])
    args, aux = b.tracker._fused_prepare(image, seq.timestamps[k])
    for i in (4, 5, 6, 7, 8, 10):  # last_pos, last_ok, last_local_row, R_pred, t_pred, slots
        assert isinstance(args[i], np.ndarray), i
    assert isinstance(args[9], np.ndarray) and args[9].shape == () and args[9].dtype == np.float32
    assert isinstance(args[1], torch.Tensor)
    b.tracker._fused_finish(args, aux)
    assert len(captured[0]) == len(captured[1]) == 1
    np.testing.assert_array_equal(captured[0][0], captured[1][0])
    L = cfg.shapes.max_local_points
    assert captured[0][0].shape == (fused_track.CTL_HEADER + cfg.orb.n_features + L,)
    assert a.tracker.current.pose_set and b.tracker.current.pose_set
    np.testing.assert_array_equal(a.tracker.current.Rcw, b.tracker.current.Rcw)
    assert a.tracker.n_fused_frames == b.tracker.n_fused_frames >= 1


def test_batched_consume_retracks_a_corrected_stream(sequences, port_runs):
    """A whole-map rewrite (what a global-BA apply or a loop correction
    marks, `Map.note_all_mp_dirty`) lands on stream 0's map from another
    thread while the batch's device phase runs: stream 0 tracks that frame
    again on its own path, the other stream consumes the batch. Decisions
    stay those of the sequential runs, camera centres within 1e-3, and the
    extractions are the batched frames, the single-path frames and the
    re-tracks."""
    n_frames, S = 8, 2
    seq_poses = port_runs[0]
    ms = MultiStreamSLAM(config_from_reference(_config()), n_streams=S, device="cpu")
    for s in ms.streams:
        s.tracker.uniform_noise = JaxTrackerNoise()
    n_extract, frontend, extract = [0], ms._batched_frontend, ms.extractor.extract
    m0 = ms.streams[0].map

    def counted_extract(images):
        n_extract[0] += 1
        return extract(images)

    def rewrite():
        with m0.update_lock:
            m0.note_all_mp_dirty()

    def frontend_under_rewrite(args):
        if ms.n_batched_frames == 3:
            t = threading.Thread(target=rewrite)
            t.start()
            t.join(timeout=60.0)
            assert not t.is_alive(), "the batched device phase holds a stream's map lock"
        return frontend(args)

    ms.extractor.extract = counted_extract
    ms._batched_frontend = frontend_under_rewrite
    poses = [[] for _ in range(S)]
    for k in range(n_frames):
        for s, T in enumerate(_track_batch(ms, sequences, k)):
            poses[s].append(T)
    ms.shutdown()
    assert [s.tracker.n_retracked_frames for s in ms.streams] == [1, 0]
    assert n_extract[0] == ms.n_batched_frames + ms.n_single_frames + 1
    for s in range(S):
        pairs = list(zip(_centres(seq_poses[s][:n_frames]), _centres(poses[s])))
        assert all((a is None) == (b is None) for a, b in pairs), s
        assert max(np.linalg.norm(a - b) for a, b in pairs if a is not None) < 1e-3, s


def test_multistream_threaded_smoke(sequences):
    """tests/test_multisystem.py's threaded case: each stream's mapping and
    loop closing on its own mapper thread behind the batched front end;
    tracking survives the interleavings and each worker builds its map."""
    S = len(SEEDS)
    ms = MultiStreamSLAM(config_from_reference(_config()), n_streams=S, threaded=True, device="cpu")
    for s in ms.streams:
        s.tracker.uniform_noise = JaxTrackerNoise()
    assert all(s.threaded and not s.tracker.pipelined for s in ms.streams)
    n_ok = [0] * S
    for k in range(N_FRAMES):
        for s, T in enumerate(_track_batch(ms, sequences, k)):
            n_ok[s] += T is not None
    assert ms.n_batched_frames >= 5, ms.n_batched_frames
    assert all(s._worker.is_alive() for s in ms.streams)
    ms.shutdown()
    for s in range(S):
        assert not ms.streams[s]._worker.is_alive()
        assert n_ok[s] >= N_FRAMES - 4, (s, n_ok)
        assert ms.streams[s].map.n_keyframes() >= 2
        assert ms.streams[s].map.n_map_points() > 50


def test_defaults_to_the_card():
    """Without CUDA the default device refuses to start, as every entry
    point of the port does."""
    from ceres_mono_orb_slam2_tpu_torch.parallel.multistream import make_multistream_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device starts")
    cfg = config_from_reference(_config())
    with pytest.raises(RuntimeError):
        MultiStreamSLAM(cfg, n_streams=2)
    with pytest.raises(RuntimeError):
        make_multistream_step(cfg, 480, 640)
