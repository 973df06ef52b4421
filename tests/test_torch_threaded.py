"""The port's threaded modes: the mapper thread of `MonoSLAM(threaded=True)`,
the global-BA thread of `LoopClosing(threaded_gba=True)`, and the lazy
host copies of `Frame` / `KeyFrame` under two threads.

- A paced threaded run (the tracker waits for the mapper after each frame)
  makes the serial run's every decision to the bit: the per-stage locking
  and the prep / solve / apply split of local mapping change no arithmetic.
  With tests/test_torch_slam.py, which holds the serial port against the
  JAX package, this holds the threaded port against it too.
- Ports of tests/test_threaded.py (unpaced, geometric front end) and of
  tests/test_noterase.py (the SetNotErase protocol, and a threaded loop
  closure with the global-BA thread under aggressive keyframe culling).
- A reset from another thread while a fused frame is in its device phase
  makes the frame be tracked again against the emptied map.
- `run_global_ba` on a thread of its own stops between chunks when its
  `stop_cb` says so and then leaves the map as it was.
- A frame that wanted a keyframe the busy mapper could not take makes the
  next frame wait for local mapping; the wait ends when local mapping is
  idle, while a loop closure on the mapper thread runs on, and a wait that
  runs into its timeout raises. The keyframe decision itself is the JAX
  package's on the same state.
- `graphs.fetch`, the mapper's one read-back a stage, gives the bits of
  `.cpu().numpy()`."""

import sys
import threading
import types

import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.utils.synthetic import make_sequence
from ceres_mono_orb_slam2_tpu_torch.models import localmapping, system
from ceres_mono_orb_slam2_tpu_torch.models.frame import Frame
from ceres_mono_orb_slam2_tpu_torch.models.map import KeyFrame, Map
from ceres_mono_orb_slam2_tpu_torch.models.optimization import run_global_ba
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import FrameFeatures
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

torch.set_num_threads(2)
H, W = 480, 640
PACED_FRAMES = 24
TIMEOUT_S = 300.0


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


def _config(n_features: int):
    return SlamConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
        orb=ORBConfig(n_features=n_features),
        shapes=StaticShapes(max_local_points=2048, max_local_keyframes=12,
                            max_ba_points=1024, max_ba_obs=4096),
    )


def _run_paced(seq, **kw):
    slam = MonoSLAM(_config(1500), device="cpu", **kw)
    poses = []
    for k in range(PACED_FRAMES):
        poses.append(slam.track_monocular(seq.images[k], seq.timestamps[k]))
        assert slam.wait_mapper_idle(timeout=TIMEOUT_S)
    alive = slam._worker is not None and slam._worker.is_alive()
    slam.shutdown()
    return slam, poses, alive


def test_paced_threaded_equals_serial_to_the_bit():
    seq = make_sequence(n_frames=40, seed=11, motion="strafe", step=0.12)
    serial, sp, _ = _run_paced(seq)
    threaded, tp, alive = _run_paced(seq, threaded=True)
    assert alive and not threaded._worker.is_alive()
    assert [T is None for T in sp] == [T is None for T in tp]
    assert sum(T is not None for T in tp) >= PACED_FRAMES - 4
    for a, b in zip(sp, tp):
        if a is not None:
            assert np.array_equal(a, b)
    assert sorted(serial.map.keyframes) == sorted(threaded.map.keyframes)
    assert serial.map.n_map_points() == threaded.map.n_map_points()
    assert serial.local_mapper.n_local_ba == threaded.local_mapper.n_local_ba >= 1
    # every mapping pass records its stages
    assert len(threaded.local_mapper.pass_ms) == len(serial.local_mapper.pass_ms) >= 1
    assert {"process_new", "cull_mp", "triangulate", "fuse"} <= set(threaded.local_mapper.pass_ms[-1])


@pytest.fixture(scope="module")
def geo_run():
    """Unpaced threaded run over the geometric strafe (tests/test_threaded.py)."""
    n_frames = 25
    cfg = _config(600)
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    slam = MonoSLAM(cfg, device="cpu", threaded=True)
    slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                          px_noise=0.3, bit_noise=2, seed=5, device="cpu")
    gt_c = np.einsum("tij,tj->ti", Rcw.transpose(0, 2, 1), -tcw)
    est, gt = [], []
    for k in range(n_frames):
        T = slam.track_monocular(frame_image(k, H, W), k / 30.0)
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(gt_c[k])
    alive = slam._worker.is_alive()
    slam.shutdown()
    return slam, n_frames, np.stack(est), np.stack(gt), alive


def test_threaded_pipeline_tracks(geo_run):
    slam, n_frames, est, gt, alive = geo_run
    assert alive and not slam._worker.is_alive()
    assert slam.get_tracking_state() == "OK"
    assert len(est) >= n_frames - 4
    assert slam.map.n_keyframes() >= 2
    # the worker mapped: local BA ran or points were triangulated past the init map
    assert slam.local_mapper.n_local_ba >= 1 or slam.map.n_map_points() > 300
    traj = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert ate_rmse(est, gt) < 0.05 * traj
    slam.shutdown()  # a second shutdown is a no-op


def test_global_ba_on_a_thread_stops_between_chunks(geo_run):
    """A stop_cb that fires after the first chunk: the solve returns False
    and no keyframe pose moves; the callback ran on the solving thread."""
    slam = geo_run[0]
    m = slam.map
    before = {k: (kf.Rcw.copy(), kf.tcw.copy()) for k, kf in m.keyframes.items()}
    big = m.big_change_idx
    calls, result = [], []

    def stop():
        calls.append(threading.current_thread().name)
        return True

    t = threading.Thread(target=lambda: result.append(run_global_ba(
        m, slam.config, max(m.keyframes), n_iters=50, stop_cb=stop, device="cpu")), name="gba")
    t.start()
    t.join(timeout=TIMEOUT_S)
    assert not t.is_alive()
    assert result == [False] and calls == ["gba"]
    for k, kf in m.keyframes.items():
        assert np.array_equal(kf.Rcw, before[k][0]) and np.array_equal(kf.tcw, before[k][1])
        assert kf.Tcw_gba is None
    assert m.big_change_idx == big


def test_global_ba_in_the_device_phase_retracks_the_frame(monkeypatch):
    """Unpaced, threaded, with a vocabulary: a global BA runs on a `gba`
    thread from its snapshot to its apply while a fused frame is in its
    device phase. The thread finishes (the phase does not hold
    map.update_lock), its apply moves `Map.correction_epoch`, and the frame
    is tracked again against the corrected map before it is consumed: one
    re-track, one extra extraction, one trajectory entry per frame."""
    n_frames = 14
    cfg = _config(600)
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    voc = bow.train_vocabulary(world.desc[:1500], k=8, levels=3, seed=0, device="cpu")
    slam = MonoSLAM(cfg, vocabulary=voc, device="cpu", threaded=True)
    tr, m = slam.tracker, slam.map
    gx = tr.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                     px_noise=0.3, bit_noise=2, seed=5, device="cpu")
    n_extract, applied, moved = [0], [], []
    extract, dispatch = gx.extract, tr._fused_dispatch

    def counted_extract(image):
        n_extract[0] += 1
        return extract(image)

    def gba():
        with m.update_lock:
            loop_kf = max(m.keyframes)
        applied.append(run_global_ba(m, cfg, loop_kf, n_iters=10, device="cpu"))

    def dispatch_under_gba(args):
        if not moved and tr.n_fused_frames >= 3:
            epoch = m.correction_epoch
            t = threading.Thread(target=gba, name="gba")
            t.start()
            t.join(timeout=TIMEOUT_S)
            assert not t.is_alive(), "the device phase holds map.update_lock"
            moved.append(m.correction_epoch - epoch)
        return dispatch(args)

    monkeypatch.setattr(gx, "extract", counted_extract)
    monkeypatch.setattr(tr, "_fused_dispatch", dispatch_under_gba)
    gt_c = np.einsum("tij,tj->ti", Rcw.transpose(0, 2, 1), -tcw)
    est, gt = [], []
    for k in range(n_frames):
        T = slam.track_monocular(frame_image(k, H, W), k / 30.0)
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(gt_c[k])
    slam.shutdown()
    assert applied == [True] and moved and moved[0] >= 1
    assert tr.n_retracked_frames == 1 and tr.n_discarded_chained == 0
    assert n_extract[0] == n_frames + 1
    stamps = [entry[3] for entry in tr.trajectory]
    assert len(stamps) == len(set(stamps))
    assert slam.get_tracking_state() == "OK" and len(est) >= n_frames - 4
    traj = np.linalg.norm(np.diff(np.stack(gt), axis=0), axis=1).sum()
    assert ate_rmse(np.stack(est), np.stack(gt)) < 0.05 * traj


def test_reset_in_the_device_phase_retracks_the_frame(monkeypatch):
    """Threaded, paced: a reset from another thread (the live viewer's menu)
    runs while a fused frame is in its device phase. The reset moves
    `Map.correction_epoch`, so the frame is tracked again, as the first
    frame of a new initialization, instead of consumed into the emptied map:
    no keyframe, map point or trajectory entry from before the reset
    survives, and tracking initialises again."""
    n_frames = 12
    cfg = _config(600)
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    slam = MonoSLAM(cfg, device="cpu", threaded=True)
    tr, m = slam.tracker, slam.map
    gx = tr.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                     px_noise=0.3, bit_noise=2, seed=5, device="cpu")
    n_extract, reset_ids, k_reset = [0], [], None
    extract, dispatch = gx.extract, tr._fused_dispatch

    def counted_extract(image):
        n_extract[0] += 1
        return extract(image)

    def dispatch_under_reset(args):
        if not reset_ids and tr.n_fused_frames >= 3:
            reset_ids.append(tr.last_frame.id + 1)  # the frame in its device phase
            t = threading.Thread(target=slam.reset, name="viewer-menu")
            t.start()
            t.join(timeout=TIMEOUT_S)
            assert not t.is_alive(), "the device phase holds map.update_lock"
            assert m.n_keyframes() == 0 and m.n_map_points() == 0
        return dispatch(args)

    monkeypatch.setattr(gx, "extract", counted_extract)
    monkeypatch.setattr(tr, "_fused_dispatch", dispatch_under_reset)
    for k in range(n_frames):
        slam.track_monocular(frame_image(k, H, W), k / 30.0)
        assert slam.wait_mapper_idle(timeout=TIMEOUT_S)
        if reset_ids and k_reset is None:
            # the re-tracked frame starts the new initialization
            k_reset = k
            assert tr.state.name == "NOT_INITIALIZED" and tr.init_ref is not None
            assert tr.init_ref.id == reset_ids[0] and m.n_keyframes() == 0
    slam.shutdown()
    assert tr.n_resets == 1 and tr.n_retracked_frames == 1
    assert n_extract[0] == n_frames + 1
    assert min(ts for *_, ts, _ in tr.trajectory) >= k_reset / 30.0
    assert m.n_keyframes() >= 2 and slam.get_tracking_state() == "OK"
    assert all(kf.frame_id >= reset_ids[0] for kf in m.all_keyframes())
    for mp in m.all_map_points():
        assert mp.ref_kf_id in m.keyframes and set(mp.observations) <= set(m.keyframes)


def test_worker_exception_is_raised_on_the_callers_thread(monkeypatch):
    slam = MonoSLAM(_config(600), device="cpu", threaded=True)

    def fail():
        raise ValueError("mapping failed")

    monkeypatch.setattr(slam.local_mapper, "process_queue", fail)
    slam._wake_mapper()
    slam._worker.join(timeout=TIMEOUT_S)
    assert not slam._worker.is_alive()
    with pytest.raises(RuntimeError, match="mapper thread failed") as err:
        slam.wait_mapper_idle(timeout=1.0)
    assert isinstance(err.value.__cause__, ValueError)
    with pytest.raises(RuntimeError):
        slam.shutdown()


def test_flushed_keyframe_wakes_the_mapper(monkeypatch):
    """A keyframe that the pipeline flush inserts (the in-flight frame's
    consume) reaches the mapper thread, so wait_mapper_idle returns."""
    slam = MonoSLAM(_config(600), device="cpu", threaded=True, pipelined=True)
    lm, passes = slam.local_mapper, []

    def process_queue():
        passes.append(list(lm.queue))
        lm.queue.clear()

    monkeypatch.setattr(lm, "process_queue", process_queue)
    monkeypatch.setattr(slam.tracker, "flush_pipeline", lambda: lm.queue.append(7))
    slam.flush_pipeline()
    assert slam.wait_mapper_idle(timeout=TIMEOUT_S)
    assert passes == [[7]]
    slam.shutdown()


def test_a_wanted_keyframe_waits_for_a_slow_mapper(monkeypatch):
    """Unpaced, threaded, with a mapper slowed to 0.6 s a keyframe (a
    tracker that outruns it, as the card's replayed frames do): a frame that
    wants a keyframe the busy mapper cannot take makes the next frame wait
    for the mapper (`MonoSLAM.n_keyframe_waits`) instead of dropping it
    again, so the map keeps up and tracking stays OK."""
    n_frames = 12
    cfg = _config(600)
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    slam = MonoSLAM(cfg, device="cpu", threaded=True)
    slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                          px_noise=0.3, bit_noise=2, seed=5, device="cpu")
    process, waits = slam.local_mapper._process, []

    def slow_process(kf):
        threading.Event().wait(0.6)
        return process(kf)

    wait = slam.wait_local_mapping_idle

    def counted_wait(timeout=30.0):
        waits.append(slam.tracker.keyframe_wanted)
        return wait(timeout)

    monkeypatch.setattr(slam.local_mapper, "_process", slow_process)
    monkeypatch.setattr(slam, "wait_local_mapping_idle", counted_wait)
    gt_c = np.einsum("tij,tj->ti", Rcw.transpose(0, 2, 1), -tcw)
    est, gt = [], []
    for k in range(n_frames):
        T = slam.track_monocular(frame_image(k, H, W), k / 30.0)
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(gt_c[k])
    slam.shutdown()
    # every wait came from a wanted keyframe, whose flag it cleared first
    assert slam.n_keyframe_waits == len(waits) == len(slam.keyframe_wait_ms) >= 1 and not any(waits)
    assert 0.0 < slam.max_keyframe_wait_ms < 60e3
    assert slam.get_tracking_state() == "OK" and slam.map.n_keyframes() >= 3  # the serial run's 3
    traj = np.linalg.norm(np.diff(np.stack(gt), axis=0), axis=1).sum()
    assert ate_rmse(np.stack(est), np.stack(gt)) < 0.05 * traj


class _BlockedLoopCloser:
    """A loop closer whose every drain blocks until `release` is set."""

    gba_error = gba_thread = None

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def process_queue(self):
        self.entered.set()
        assert self.release.wait(TIMEOUT_S)


def _wanted_keyframe_wait(slam):
    """`_wait_for_wanted_keyframe` after a frame that wanted a keyframe, on a
    thread of its own: (the thread, what it raised)."""
    slam.tracker.keyframe_wanted = True
    raised = []

    def wait():
        try:
            slam._wait_for_wanted_keyframe()
        except RuntimeError as e:
            raised.append(e)

    th = threading.Thread(target=wait)
    th.start()
    return th, raised


def test_keyframe_wait_ends_at_local_mapping_idle_during_a_closure(monkeypatch):
    """A keyframe wait that meets local mapping and then a loop closure on
    the mapper thread ends when local mapping is idle, while the closure
    still runs (the reference's loop closer has a thread of its own), and
    records its ms."""
    slam = MonoSLAM(_config(600), device="cpu", threaded=True)
    closer = slam.loop_closer = _BlockedLoopCloser()
    drained, process_queue = threading.Event(), slam.local_mapper.process_queue

    def slow_drain():
        threading.Event().wait(0.3)
        process_queue()
        drained.set()

    monkeypatch.setattr(slam.local_mapper, "process_queue", slow_drain)
    try:
        slam.local_mapper.queue.append(10 ** 6)  # no such keyframe: the drain skips it
        slam._wake_mapper()
        th, raised = _wanted_keyframe_wait(slam)
        th.join(timeout=10.0)
        assert not th.is_alive() and not raised
        assert drained.is_set() and not slam.local_mapper.queue
        assert closer.entered.wait(10.0) and not slam.wait_mapper_idle(timeout=0.05)
        assert slam.n_keyframe_waits == 1 and len(slam.keyframe_wait_ms) == 1
    finally:
        closer.release.set()
        slam.shutdown()


def test_keyframe_wait_past_its_timeout_raises(monkeypatch):
    """A keyframe wait that local mapping does not end within
    `JOIN_TIMEOUT_S` raises and names the stage it waited for."""
    slam = MonoSLAM(_config(600), device="cpu", threaded=True)
    entered, release = threading.Event(), threading.Event()

    def stuck_drain():
        entered.set()
        release.wait(TIMEOUT_S)

    monkeypatch.setattr(slam.local_mapper, "process_queue", stuck_drain)
    monkeypatch.setattr(system, "JOIN_TIMEOUT_S", 0.2)
    try:
        slam._wake_mapper()
        assert entered.wait(10.0)  # the drain runs: local mapping is busy
        th, raised = _wanted_keyframe_wait(slam)
        th.join(timeout=10.0)
        assert not th.is_alive() and len(raised) == 1 and "local mapping" in str(raised[0])
    finally:
        release.set()
        monkeypatch.undo()  # shutdown joins the mapper within the real timeout
        slam.shutdown()


class _StubKeyFrame:
    def __init__(self, tracked: int):
        self.tracked = tracked

    def tracked_map_points(self, min_obs, map_):
        return self.tracked


class _StubMapper:
    def __init__(self, idle: bool):
        self.idle, self.n_interrupts = idle, 0

    def accepting(self):
        return self.idle

    def interrupt_ba(self):
        self.n_interrupts += 1


class _StubMap:
    def __init__(self, n_kfs: int, ref_tracked: int, last_kf_frame: int):
        self.keyframes = {1: _StubKeyFrame(ref_tracked), 2: None}
        self._n_kfs, self.last_kf_frame = n_kfs, last_kf_frame

    def n_keyframes(self):
        return self._n_kfs


class _StubTracker:
    """What `_need_new_keyframe` reads of a tracker, in either package."""

    def __init__(self, frame: int, n_kfs: int, inliers: int, ref_tracked: int, idle: bool,
                 last_kf_frame: int, last_reloc: int):
        self.map = _StubMap(n_kfs, ref_tracked, last_kf_frame)
        self.current = types.SimpleNamespace(id=frame)
        self.last_reloc_frame_id, self.max_frames, self.min_frames = last_reloc, 30, 0
        self.ref_kf_id, self.last_kf_id = 1, 2
        self.matches_inliers = inliers
        self.local_mapper = _StubMapper(idle)

    def last_kf_frame_id(self):
        return self.map.last_kf_frame


# case: ((frame, keyframes, inliers, the reference keyframe's tracked
# points, mapper idle, the last keyframe's frame, the last relocalization's
# frame), (new keyframe, calls of interrupt_ba))
_DECISIONS = {
    "idle mapper: insert": ((40, 5, 60, 100, True, 38, -100), (True, 0)),
    "busy mapper past max_frames (c1a): drop, interrupt BA": ((80, 5, 60, 100, False, 40, -100), (False, 1)),
    "busy mapper before max_frames: drop": ((41, 5, 60, 100, False, 40, -100), (False, 0)),
    "idle mapper past max_frames (c1a): insert": ((80, 5, 60, 100, True, 40, -100), (True, 0)),
    "inliers near the reference keyframe's (no c2): none": ((80, 5, 95, 100, True, 40, -100), (False, 0)),
    "15 inliers or fewer (no c2): none": ((80, 5, 15, 100, False, 40, -100), (False, 0)),
    "relocalization gate: none": ((50, 40, 60, 100, True, 10, 45), (False, 0)),
    "relocalization gate open with few keyframes: insert": ((50, 20, 60, 100, True, 10, 45), (True, 0)),
}


@pytest.mark.parametrize("case", list(_DECISIONS))
def test_need_new_keyframe_equals_the_jax_package(case):
    """`Tracking._need_new_keyframe` of the port against the JAX package's
    on the same tracker state: the same decision and the same calls of
    `interrupt_ba`, for an idle and a busy mapper, the c1a gate (max_frames
    since the last keyframe), c2 (the inliers against the reference
    keyframe) and the relocalization gate."""
    from ceres_mono_orb_slam2_tpu.models.tracking import Tracking as JaxTracking
    from ceres_mono_orb_slam2_tpu_torch.models.tracking import Tracking

    args, expected = _DECISIONS[case]
    port, ref = _StubTracker(*args), _StubTracker(*args)
    got, want = Tracking._need_new_keyframe(port), JaxTracking._need_new_keyframe(ref)
    assert got == want and port.local_mapper.n_interrupts == ref.local_mapper.n_interrupts
    assert (got, port.local_mapper.n_interrupts) == expected


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64, torch.int32, torch.uint8, torch.bool])
def test_fetch_gives_the_bits_of_cpu_numpy(dtype):
    """`graphs.fetch`, a mapping stage's one read-back, gives per tensor
    the arrays `.cpu().numpy()` gives (shape, dtype, bits): a 0-d tensor, an
    empty one, a transposed view and a strided slice among them, each
    copied into a dense host tensor of its own as on the card (there pinned,
    without a synchronisation a tensor; `chip_smoke.py`'s `[graphs]` checks
    that path), so that writing the source afterwards leaves the arrays as
    they were; off CUDA the stream handover is a no-op."""
    g = torch.Generator().manual_seed(3)
    base = (torch.randn((6, 5), generator=g) * 1e3).to(dtype)
    tensors = (base, base[2, 3], base[:0], base.t(), base[1::2, ::2])
    wants = [t.cpu().numpy().copy() for t in tensors]
    got = graphs.fetch(*tensors)
    base.zero_()
    assert len(got) == len(tensors)
    for a, want in zip(got, wants):
        assert isinstance(a, np.ndarray) and a.dtype == want.dtype and a.shape == want.shape
        assert a.flags.c_contiguous
        np.testing.assert_array_equal(a, want)
    assert graphs.owner_stream("cpu", "mapper") is None
    assert graphs.share_with("mapper", tensors) is None
    graphs.wait_for(None)
    with graphs.on_owner_stream("cpu", "mapper"):
        assert graphs.fetch(base)[0].sum() == 0


def _lazy_frame(seed: int, n: int = 256) -> Frame:
    g = torch.Generator().manual_seed(seed)
    feats = FrameFeatures(xy=torch.rand((n, 2), generator=g) * 400.0,
                          response=torch.rand((n,), generator=g),
                          angle=torch.rand((n,), generator=g) * 6.0,
                          octave=torch.randint(0, 8, (n,), generator=g, dtype=torch.int32),
                          desc=torch.randint(0, 256, (n, 32), generator=g, dtype=torch.uint8),
                          valid=torch.rand((n,), generator=g) > 0.1)
    cam = _config(600).camera
    return Frame(feats, cam, 0.0, frame_id=seed, lazy=True)


@pytest.mark.parametrize("via_keyframe", [False, True])
def test_lazy_payload_materialises_once_under_two_threads(via_keyframe):
    """Two threads reach one lazy frame's host payload at once (directly or
    through the keyframe that promoted it): both get the one copy, equal to
    the device tensors."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for seed in range(40):
            f = _lazy_frame(seed)
            holder = KeyFrame(seed, f) if via_keyframe else f
            f.start_host_copy_async()  # a no-op on the CPU
            barrier = threading.Barrier(2)
            got = [None, None]

            def read(i):
                barrier.wait()
                got[i] = (holder.kp_xy, holder.desc, holder.kp_und, holder.kp_valid)

            threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT_S)
            assert not any(t.is_alive() for t in threads)
            for a, b in zip(*got):
                assert a is b  # one copy, seen by both threads
            np.testing.assert_array_equal(got[0][0], f.j_xy.numpy())
            np.testing.assert_array_equal(got[0][1], f.j_desc.numpy())
            np.testing.assert_array_equal(got[0][3], f.j_valid.numpy())
            assert not f._host_pending
    finally:
        sys.setswitchinterval(old)


class _F:
    def __init__(self, fid):
        self.id = fid
        self.timestamp = 0.0
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        n = 8
        self.kp_xy = np.zeros((n, 2), np.float32)
        self.kp_und = np.zeros((n, 2), np.float32)
        self.kp_octave = np.zeros(n, np.int32)
        self.kp_angle = np.zeros(n, np.float32)
        self.kp_response = np.zeros(n, np.float32)
        self.desc = np.zeros((n, 32), np.uint8)
        self.kp_valid = np.ones(n, bool)
        self.mp_ids = np.full(n, -1, np.int64)


def test_not_erase_defers_and_set_erase_applies():
    """tests/test_noterase.py's unit test on the port's Map."""
    m = Map()
    kf0 = m.new_keyframe(_F(0))
    kf = m.new_keyframe(_F(1))
    m.set_not_erase(kf)
    m.erase_keyframe(kf)
    assert not kf.bad and kf.to_be_erased, "cull must be deferred while protected"
    assert kf.id in m.keyframes
    m.set_erase(kf)
    assert kf.bad and kf.id not in m.keyframes, "deferred cull honored on release"
    # a loop-edge anchor stays protected forever (KeyFrame.cc:448-458)
    kf2 = m.new_keyframe(_F(2))
    m.set_not_erase(kf2)
    kf2.loop_edges.add(kf0.id)
    m.set_erase(kf2)
    assert kf2.not_erase and not kf2.bad
    m.erase_keyframe(kf2)
    assert not kf2.bad and kf2.to_be_erased


def test_threaded_loop_closure_with_aggressive_culling(monkeypatch):
    """tests/test_noterase.py's stress on the port: threaded with the
    global-BA thread, a culler that erases almost any keyframe, a loop on
    the geometric circle, the tracker paced against the mapper."""

    def aggressive(self, kf):
        m = self.map
        for k_id in kf.best_covisible(len(kf.ordered_neighbors)):
            okf = m.keyframes.get(k_id)
            if okf is None or okf.bad or okf.id == 0:
                continue
            n_mps = sum(1 for mid in okf.mp_ids if mid >= 0 and m.get_mp(int(mid)))
            if n_mps and n_mps < 400:
                m.erase_keyframe(okf)

    monkeypatch.setattr(localmapping.LocalMapping, "_keyframe_culling", aggressive)
    n_frames = 72
    cfg = _config(600)
    Rcw, tcw = make_geo_trajectory(n_frames, "circle", 0.1)
    world = GeoWorld(np.random.default_rng(0), 2500, shape="ring")
    voc = bow.train_vocabulary(world.desc[:1500], k=8, levels=3, seed=0, device="cpu")
    slam = MonoSLAM(cfg, vocabulary=voc, device="cpu", threaded=True)
    assert slam.loop_closer.threaded_gba
    slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                          px_noise=0.3, bit_noise=2, seed=3, device="cpu")
    n_ok = 0
    for k in range(n_frames):
        n_ok += slam.track_monocular(frame_image(k, H, W), k / 30.0) is not None
        assert slam.wait_mapper_idle(timeout=TIMEOUT_S)
    assert slam._worker.is_alive()
    slam.shutdown()
    gba = slam.loop_closer.gba_thread
    assert gba is None or not gba.is_alive()
    # the reference test's bar: the run survives the cull / reset cycle
    assert n_ok >= n_frames * 0.5, n_ok
    m = slam.map
    for kf in m.all_keyframes():
        assert not kf.bad
        if kf.loop_edges:
            assert kf.not_erase  # loop-edge anchors stay pinned
        for i in np.nonzero(kf.mp_ids >= 0)[0]:
            mp = m.map_points.get(int(kf.mp_ids[i]))
            if mp is not None and not mp.bad and kf.id in mp.observations:
                assert mp.observations[kf.id] == i
