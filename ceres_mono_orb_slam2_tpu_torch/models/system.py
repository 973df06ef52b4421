"""System facade (reference src/MonoORBSlam.cc).

Port of `ceres_mono_orb_slam2_tpu/models/system.py`. Serially (the default)
each frame is tracking, then a drain of the local-mapping queue, then a
drain of the loop-closing queue. With `threaded=True` local mapping and
loop closing run on a host worker thread named `mapper` that each new
keyframe wakes, and each global BA on a thread of its own, as in the
reference's three-thread architecture (MonoORBSlam.cc:78-89). The tracker's
device work runs on the card's default CUDA stream and the mapper's (local
mapping, loop closing, the global BA), serial or threaded, on the mapper
stream (`utils/graphs.owner_stream`), so that a host read of the mapper's
results never waits behind a frame the tracker queued; the keyframe
payloads and the BoW tables the mapper reads are handed over with events.
With `pipelined=True` the tracker dispatches frame k's fused
step before it consumes frame k-1 (`Tracking._grab_pipelined`). With a
vocabulary the facade builds the BoW keyframe database (relocalization) and
the loop closer. The facade also switches localization mode, and saves and
loads trajectories and maps in the JAX package's formats (`save_map`'s
`.npz` loads into either package). `use_viewer=True` writes a map snapshot
every 10 frames (`viewer.py`); `live_viewer_port` serves the live HTTP
viewer (`live_viewer.py`). The tracker replays its per-frame device work,
and local mapping and loop closing their device solves, as captured programs
(`graphs=True`, `utils/graphs.py`); `graphs=False` runs them op by op, as
`jax.disable_jit` does the JAX package's.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.localmapping import LocalMapping
from ceres_mono_orb_slam2_tpu_torch.models.map import KeyFrame, Map
from ceres_mono_orb_slam2_tpu_torch.models.tracking import Tracking
from ceres_mono_orb_slam2_tpu_torch.ops import lie
from ceres_mono_orb_slam2_tpu_torch.ops.orb import ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger(__name__)


# how long shutdown waits for the mapper and the global-BA threads to stop
JOIN_TIMEOUT_S = 600.0


class MonoSLAM:
    """Python equivalent of the reference MonoORBSlam facade."""

    def __init__(self, config, device=DEFAULT_DEVICE, vocabulary=None, threaded: bool = False,
                 pipelined: bool = False, generator: Optional[torch.Generator] = None,
                 use_viewer: bool = False, live_viewer_port: Optional[int] = None,
                 graphs: bool = True):
        self.config = config
        self.device = resolve_device(device)
        self.map = Map()
        self.extractor = ORBExtractor(config.orb, device=self.device)
        self.loop_closer = None
        self.keyframe_db = None
        if vocabulary is not None:
            from ceres_mono_orb_slam2_tpu_torch.models.keyframe_database import KeyFrameDatabase
            from ceres_mono_orb_slam2_tpu_torch.models.loopclosing import LoopClosing

            self.keyframe_db = KeyFrameDatabase(vocabulary, self.map, device=self.device)
            self.map.keyframe_db = self.keyframe_db
            self.loop_closer = LoopClosing(config, self.map, self.keyframe_db,
                                           threaded_gba=threaded, device=self.device,
                                           graphs=graphs)
        self.local_mapper = LocalMapping(config, self.map, loop_closer=self.loop_closer,
                                         device=self.device, graphs=graphs)
        self.tracker = Tracking(config, self.map, self.extractor, local_mapper=self.local_mapper,
                                relocalizer=self.keyframe_db, device=self.device,
                                generator=generator, pipelined=pipelined, graphs=graphs)
        if self.loop_closer is not None:
            self.loop_closer.local_mapper = self.local_mapper
        self._last_big_change = 0
        self.threaded = threaded
        # frames that first waited for local mapping (`_wait_for_wanted_keyframe`)
        # and the ms of each wait
        self.n_keyframe_waits = 0
        self.keyframe_wait_ms: List[float] = []
        # the mapper thread's wake-ups: passes asked of it and not yet run,
        # and the stop request, under one condition that also signals idle;
        # `_lm_running` while the thread drains the local-mapping queue
        self._mapper_cv = threading.Condition()
        self._passes_asked = 0
        self._lm_running = False
        self._shutdown = False
        self._worker_error: Optional[Exception] = None
        self._worker: Optional[threading.Thread] = None
        if threaded:
            self._worker = threading.Thread(target=self._mapping_worker, name="mapper", daemon=True)
            self._worker.start()
        # map snapshots every 10 frames into viewer_out/ (reference
        # MapDrawer), and the HTTP viewer with the Pangolin menu (reference
        # Viewer.cc:70-190; port 0 picks a free port)
        self.viewer = None
        if use_viewer:
            from ceres_mono_orb_slam2_tpu_torch.viewer import Viewer

            self.viewer = Viewer(config, self.map, self.tracker)
        self.live_viewer = None
        if live_viewer_port is not None:
            from ceres_mono_orb_slam2_tpu_torch.live_viewer import LiveViewer

            self.live_viewer = LiveViewer(self, port=live_viewer_port).start()
            log.info("live viewer at http://127.0.0.1:%d/", self.live_viewer.port)

    # --------------------------------------------------------------- threads

    def _mapping_worker(self):
        """The mapper thread: one drain of the local-mapping queue, then of
        the loop-closing queue, each time a keyframe wakes it. LocalMapping
        takes map.update_lock per stage and LoopClosing around its map reads
        and its correction, so the tracker runs between their stages. One
        pass serves every wake-up asked before it began; both drains run on
        the mapper stream, which they enter themselves, as they do serially.
        An exception ends the thread and is kept for the caller's thread."""
        cv = self._mapper_cv
        while True:
            with cv:
                cv.wait_for(lambda: self._passes_asked or self._shutdown)
                if self._shutdown:
                    return
                served = self._passes_asked
            try:
                with cv:
                    self._lm_running = True
                try:
                    self.local_mapper.process_queue()
                finally:
                    with cv:
                        self._lm_running = False
                        cv.notify_all()
                if self.loop_closer is not None:
                    self.loop_closer.process_queue()
            except Exception as e:  # the thread's boundary: hand it to the caller
                log.exception("mapper thread failed")
                with cv:
                    self._worker_error = e
                    cv.notify_all()
                return
            with cv:
                self._passes_asked -= served
                cv.notify_all()

    def _wake_mapper(self):
        with self._mapper_cv:
            self._passes_asked += 1
            self._mapper_cv.notify_all()

    def _raise_worker_error(self):
        if self._worker_error is not None:
            raise RuntimeError("the mapper thread failed") from self._worker_error
        if self.loop_closer is not None and self.loop_closer.gba_error is not None:
            raise RuntimeError("the global-BA thread failed") from self.loop_closer.gba_error

    def wait_mapper_idle(self, timeout: float = 30.0) -> bool:
        """Block until the mapper thread has drained both queues and no pass
        is running; True at once when not threaded, False on timeout. A
        live camera paces frames at its rate, which leaves the mapper its
        time; a caller feeding frames at full rate calls this to get the
        same. Re-raises a failure of the mapper thread."""
        if not self.threaded:
            return True
        with self._mapper_cv:
            idle = self._mapper_cv.wait_for(
                lambda: self._worker_error is not None or not self._passes_asked, timeout)
        self._raise_worker_error()
        return idle

    def wait_local_mapping_idle(self, timeout: float = 30.0) -> bool:
        """Block until local mapping is idle: its queue empty and no drain of
        it running on the mapper thread, which may still be closing a loop;
        True at once when not threaded, False on timeout. Re-raises a
        failure of the mapper thread."""
        if not self.threaded:
            return True
        with self._mapper_cv:
            idle = self._mapper_cv.wait_for(
                lambda: self._worker_error is not None
                or not (self._lm_running or self.local_mapper.queue), timeout)
        self._raise_worker_error()
        return idle

    @property
    def max_keyframe_wait_ms(self) -> float:
        return max(self.keyframe_wait_ms, default=0.0)

    def prewarm(self, h: int, w: int) -> dict:
        """Capture, before the first frame, every tracker program whose key
        the configuration and the (h, w) image size fix, and the loop
        closer's Sim(3) refinement (`models/prewarm.py`), so that no frame
        of the live loop stalls for a capture. Returns {phase: seconds since
        the start, ..., "total_s": seconds}. Raises after the first frame."""
        from ceres_mono_orb_slam2_tpu_torch.models.prewarm import prewarm

        return prewarm(self, h, w)

    def track_monocular(self, image: np.ndarray, timestamp: float):
        """Reference TrackMonocular (MonoORBSlam.cc:103-141): returns Tcw
        (4, 4) numpy or None (pipelined: the pose of the frame before, one
        frame late)."""
        self._raise_worker_error()
        self._wait_for_wanted_keyframe()
        Tcw = self.tracker.grab_image(image, timestamp)
        self._map_after_frame()
        if self.viewer is not None:
            self.viewer.update()
        return Tcw

    def _wait_for_wanted_keyframe(self):
        """Threaded: when the last frame wanted a keyframe that busy local
        mapping could not take, wait until local mapping is idle before
        tracking this frame, so that this frame can make it. The reference
        drops such a keyframe (a monocular tracker inserts only while local
        mapping is idle); with the tracker replaying its frames as graphs it
        outran the mapper, which then fell behind by keyframe after keyframe
        until the map no longer covered the view. The wait ends at local
        mapping's idle, not at the end of the mapper thread's pass: a loop
        closure that follows runs on, and a keyframe made meanwhile queues
        behind it, as with the reference's own loop-closing thread. A wait
        longer than `JOIN_TIMEOUT_S` raises."""
        if self.threaded and self.tracker.keyframe_wanted:
            self.tracker.keyframe_wanted = False
            self.n_keyframe_waits += 1
            t0 = time.perf_counter()
            idle = self.wait_local_mapping_idle(timeout=JOIN_TIMEOUT_S)
            self.keyframe_wait_ms.append((time.perf_counter() - t0) * 1e3)
            if not idle:
                raise RuntimeError(f"a wanted keyframe waited {JOIN_TIMEOUT_S} s for "
                                   "local mapping to go idle")

    def _map_after_frame(self):
        """Local mapping and loop closing after a tracked frame: handed to
        the mapper thread when a keyframe waits, or run here."""
        if self.threaded:
            self._raise_worker_error()
            if self.local_mapper.queue:
                self._wake_mapper()
        else:
            self.local_mapper.process_queue()
            if self.loop_closer is not None:
                self.loop_closer.process_queue()

    def flush_pipeline(self):
        """Consume the in-flight pipelined frame. A keyframe that its consume
        inserts is handed to the mapper thread, as after any frame (without
        it `wait_mapper_idle` would wait for a thread nothing woke);
        serially it waits in the queue for the next frame or `shutdown`."""
        self.tracker.flush_pipeline()
        if self.threaded:
            self._map_after_frame()

    def activate_localization_mode(self):
        """Track against the map without mapping (reference
        ActivateLocalizationMode); the in-flight pipelined frame is consumed
        first."""
        self.flush_pipeline()
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.flush_pipeline()
        self.tracker.localization_only = False

    def reset(self):
        """Reference System::Reset. The live viewer's menu calls it from its
        own thread: `correction_epoch` moves, so that a frame in its unlocked
        device phase is tracked again, against the emptied map."""
        with self.map.update_lock:
            self.tracker.reset()
            self.map.correction_epoch += 1

    def shutdown(self):
        """Consume the in-flight pipelined frame, stop and join the mapper
        thread, drain the mapper under the map lock (a keyframe that the
        flush inserted never woke the thread), then the loop closer outside
        it (a loop detectable on the final keyframe must correct the map
        before the savers persist it), then join the global-BA thread.
        Re-raises a failure of the mapper thread; a second call does
        nothing new. The live viewer stops first, after its render in
        progress."""
        if self.live_viewer is not None:
            self.live_viewer.shutdown()
        self.tracker.flush_pipeline()
        with self._mapper_cv:
            self._shutdown = True
            self._mapper_cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=JOIN_TIMEOUT_S)
            if self._worker.is_alive():
                raise RuntimeError(f"the mapper thread did not stop within {JOIN_TIMEOUT_S} s")
        self._raise_worker_error()
        with self.map.update_lock:
            self.local_mapper.process_queue()
        if self.loop_closer is not None:
            self.loop_closer.process_queue()
            gba = self.loop_closer.gba_thread
            if gba is not None:
                gba.join(timeout=JOIN_TIMEOUT_S)
                if gba.is_alive():
                    raise RuntimeError(f"the global-BA thread did not stop within {JOIN_TIMEOUT_S} s")
            self._raise_worker_error()

    def map_changed(self) -> bool:
        """Reference MonoORBSlam::MapChanged (MonoORBSlam.cc:143-151): true
        once after each big map change (loop correction, global BA apply),
        tracked against the map's big-change counter."""
        cur = self.map.big_change_idx
        if self._last_big_change < cur:
            self._last_big_change = cur
            return True
        return False

    def get_tracking_state(self) -> str:
        return self.tracker.state.name

    def n_tracked_points(self) -> int:
        return self.tracker.matches_inliers

    def get_tracked_map_points(self):
        """Reference GetTrackedMapPoints (MonoORBSlam.cc:280-283): per
        keypoint slot of the current frame its map point, replaced points
        followed to their replacement, None for unmatched slots and dead
        points."""
        f = self.tracker.current
        if f is None:
            return []
        out = []
        with self.map.update_lock:
            for m in f.mp_ids:
                mp = None
                if m >= 0:
                    rid = self.map.resolve(int(m))
                    if rid >= 0:
                        mp = self.map.map_points.get(rid)
                        if mp is not None and mp.bad:
                            mp = None
                out.append(mp)
        return out

    def get_tracked_keypoints_un(self) -> np.ndarray:
        """Reference GetTrackedKeyPointsUn (MonoORBSlam.cc:285-288): the
        current frame's undistorted keypoints, (N, 2) float32, slot for slot
        beside `get_tracked_map_points()`; padded slots hold NaN."""
        f = self.tracker.current
        if f is None:
            return np.zeros((0, 2), np.float32)
        kp = np.array(f.kp_und, np.float32)
        kp[~np.asarray(f.kp_valid)] = np.nan
        return kp

    def get_frame_trajectory(self):
        """Per-frame trajectory as (timestamps, camera centres Twc): every
        tracked frame re-based on its reference keyframe's current pose, as
        the reference saver does (MonoORBSlam.cc:286-300)."""
        self.flush_pipeline()
        ts_l, pos_l = [], []
        with self.map.update_lock:
            for kf_id, R_rel, t_rel, ts, lost in self.tracker.trajectory:
                if lost:
                    continue
                pose = self.map.resolve_kf_pose(kf_id, R_rel, t_rel)
                if pose is None:
                    continue
                Rcw, tcw = pose
                ts_l.append(ts)
                pos_l.append(-Rcw.T @ tcw)
        return np.asarray(ts_l), np.asarray(pos_l)

    def save_keyframe_trajectory_tum(self, path: str):
        """Reference SaveKeyFrameTrajectoryTUM (MonoORBSlam.cc:249-278):
        'timestamp tx ty tz qx qy qz qw' per keyframe, camera to world."""
        self.flush_pipeline()
        with self.map.update_lock:
            kfs = sorted(self.map.all_keyframes(), key=lambda k: k.id)
        with open(path, "w") as f:
            for kf in kfs:
                Rwc = kf.Rcw.T
                twc = -Rwc @ kf.tcw
                q = lie.rot_to_quat(torch.as_tensor(np.ascontiguousarray(Rwc))).numpy()
                f.write("%f %.7f %.7f %.7f %.7f %.7f %.7f %.7f\n"
                        % (kf.timestamp, twc[0], twc[1], twc[2], q[0], q[1], q[2], q[3]))
        log.info("trajectory saved to %s", path)

    def save_frame_trajectory_tum(self, path: str):
        """Every logged frame, lost ones included, re-based on its reference
        keyframe's current pose (the culled-keyframe chain followed), in the
        TUM format of `save_keyframe_trajectory_tum` (the reference records
        the same relative transforms, Tracking.cc:367-382)."""
        self.flush_pipeline()
        rows = []
        with self.map.update_lock:
            for kf_id, R_rel, t_rel, ts, _ in self.tracker.trajectory:
                pose = self.map.resolve_kf_pose(kf_id, R_rel, t_rel)
                if pose is not None:
                    Rwc = pose[0].T
                    rows.append((ts, -Rwc @ pose[1], Rwc))
        with open(path, "w") as f:
            for ts, twc, Rwc in rows:
                q = lie.rot_to_quat(torch.as_tensor(np.ascontiguousarray(Rwc))).numpy()
                f.write("%f %.7f %.7f %.7f %.7f %.7f %.7f %.7f\n"
                        % (ts, twc[0], twc[1], twc[2], q[0], q[1], q[2], q[3]))

    def save_map(self, path: str):
        """Map snapshot as `.npz`, with the JAX package's keys, dtypes and
        shapes, so that either package loads the other's file: map points
        (id, position, descriptor, scale distances, normal, reference
        keyframe) and keyframes (ids, timestamp, pose, full keypoint payload,
        bindings, spanning-tree parent). The reference writes a smaller
        OpenCV-YAML dump (`save_map_yaml`) and cannot load a map."""
        self.flush_pipeline()
        with self.map.update_lock:
            mps = self.map.all_map_points()
            kfs = sorted(self.map.all_keyframes(), key=lambda k: k.id)

            def stack(rows, empty_shape, dtype):
                return np.stack(rows).astype(dtype) if rows else np.zeros(empty_shape, dtype)

            arrays = dict(
                mp_ids=np.array([mp.id for mp in mps], np.int64),
                mp_pos=stack([mp.pos for mp in mps], (0, 3), np.float32),
                mp_desc=stack([mp.descriptor for mp in mps], (0, 32), np.uint8),
                mp_min_dist=np.array([mp.min_dist for mp in mps], np.float32),
                mp_max_dist=np.array([mp.max_dist for mp in mps], np.float32),
                mp_normal=stack([mp.normal for mp in mps], (0, 3), np.float32),
                mp_ref_kf=np.array([mp.ref_kf_id for mp in mps], np.int64),
                kf_ids=np.array([kf.id for kf in kfs], np.int64),
                kf_frame_ids=np.array([kf.frame_id for kf in kfs], np.int64),
                kf_timestamps=np.array([kf.timestamp for kf in kfs], np.float64),
                kf_Rcw=stack([kf.Rcw for kf in kfs], (0, 3, 3), np.float32),
                kf_tcw=stack([kf.tcw for kf in kfs], (0, 3), np.float32),
                kf_mp_ids=stack([kf.mp_ids for kf in kfs], (0, 0), np.int64),
                kf_kp_xy=stack([kf.kp_xy for kf in kfs], (0, 0, 2), np.float32),
                kf_kp_und=stack([kf.kp_und for kf in kfs], (0, 0, 2), np.float32),
                kf_kp_octave=stack([kf.kp_octave for kf in kfs], (0, 0), np.int32),
                kf_kp_angle=stack([kf.kp_angle for kf in kfs], (0, 0), np.float32),
                kf_kp_response=stack([kf.kp_response for kf in kfs], (0, 0), np.float32),
                kf_desc=stack([kf.desc for kf in kfs], (0, 0, 32), np.uint8),
                kf_kp_valid=stack([kf.kp_valid for kf in kfs], (0, 0), bool),
                kf_parent=np.array([kf.parent if kf.parent is not None else -1 for kf in kfs],
                                   np.int64),
            )
        np.savez_compressed(path, **arrays)
        log.info("map saved to %s (%d points, %d keyframes)", path, len(mps), len(kfs))

    def save_map_yaml(self, path: str):
        """Reference-format map dump (SaveMap, MonoORBSlam.cc:194-247):
        OpenCV-YAML with MapPoints {id, pos (3x1 d), descriptor (1x32 u)} and
        KeyFrames {id, timestamp, R (world from camera), t (camera centre),
        map_point_indices}; matrices as `!!opencv-matrix`, so that
        cv::FileStorage reads the file. The reference's key "map_point
        indices" has a space, which FileStorage rejects, hence the
        underscore; the colons carry a space, which standard YAML parsers
        need."""

        def mat(rows, cols, dt, values):
            data = ", ".join(("%d" % v) if dt == "u" else repr(float(v)) for v in values)
            return "!!opencv-matrix { rows: %d, cols: %d, dt: %s, data: [ %s ] }" % (rows, cols, dt, data)

        self.flush_pipeline()
        with self.map.update_lock:
            mps = sorted(self.map.all_map_points(), key=lambda m: m.id)
            kfs = sorted(self.map.all_keyframes(), key=lambda k: k.id)
            with open(path, "w") as f:
                f.write("%YAML:1.0\n---\n")
                f.write("MapPoints:\n")
                for mp in mps:
                    f.write('   - { id: "%d", pos: %s,\n       descriptor: %s }\n'
                            % (mp.id, mat(3, 1, "d", mp.pos), mat(1, 32, "u", mp.descriptor)))
                f.write("KeyFrames:\n")
                for kf in kfs:
                    Rwc = kf.Rcw.T
                    ids = sorted(int(m) for m in kf.mp_ids if m >= 0)
                    f.write('   - { id: "%d", timestamp: %r, R: %s,\n       t: %s,\n'
                            '       map_point_indices: %s }\n'
                            % (kf.id, float(kf.timestamp), mat(3, 3, "d", Rwc.reshape(-1)),
                               mat(3, 1, "d", -Rwc @ kf.tcw),
                               mat(1, max(len(ids), 1), "f", ids if ids else [-1])))
        log.info("YAML map saved to %s (%d points, %d keyframes)", path, len(mps), len(kfs))

    def load_map(self, path: str):
        """Load a `save_map` file (of either package) in place of the map:
        map points, keyframes with their payloads and bindings, the
        covisibility graph, the spanning tree and, with a vocabulary, the BoW
        database (each keyframe's BoW vector computed on the device). Map
        point ids are renumbered in file order, keyframe ids kept (the JAX
        package's loader drops a keyframe wherever culling left a gap in the
        saved ids, then fails with a KeyError). The
        device pool re-mirrors the new map (`Map.clear` moves `map_epoch`),
        `correction_epoch` moves so that a frame in flight is tracked again,
        and the tracker is left LOST, so that the next frame relocalizes
        against the loaded map (the JAX package leaves it waiting to
        initialize, which builds a second map inside the loaded one).
        Returns {old map-point id: new id}."""
        self.flush_pipeline()
        self.wait_mapper_idle(timeout=JOIN_TIMEOUT_S)
        data = np.load(path)
        m = self.map
        with m.update_lock:
            m.clear()
            self.local_mapper.reset()
            if self.loop_closer is not None:
                self.loop_closer.reset()
            if self.keyframe_db is not None:
                self.keyframe_db.clear()
            id_map = {}
            for i, mid in enumerate(data["mp_ids"]):
                mp = m.new_map_point(data["mp_pos"][i], data["mp_desc"][i],
                                     ref_kf_id=int(data["mp_ref_kf"][i]))
                mp.min_dist = float(data["mp_min_dist"][i])
                mp.max_dist = float(data["mp_max_dist"][i])
                mp.normal = data["mp_normal"][i]
                id_map[int(mid)] = mp.id
            kf_ids = data["kf_ids"]
            for i, kid in enumerate(kf_ids):
                # under its saved id: culled keyframes leave gaps in the ids
                kf = m.keyframes[int(kid)] = KeyFrame(int(kid), _SavedFrame(data, i, id_map))
                for q in np.nonzero(kf.mp_ids >= 0)[0]:
                    mp = m.map_points.get(int(kf.mp_ids[q]))
                    if mp is not None:
                        m.add_observation(mp, kf, int(q))
            m.next_kf_id = int(kf_ids.max()) + 1 if len(kf_ids) else 0
            if len(kf_ids):
                # the global BA's spanning-tree propagation walks from here
                m.keyframe_origins.append(int(kf_ids.min()))
            for i, kid in enumerate(kf_ids):
                kf = m.keyframes[int(kid)]
                par = int(data["kf_parent"][i])
                if par >= 0 and par in m.keyframes:
                    kf.parent = par
                    m.keyframes[par].children.add(kf.id)
                m.update_connections(kf)
                if self.keyframe_db is not None:
                    self.keyframe_db.add(kf)
            # remap stale reference keyframes and refresh per-point stats
            for mp in m.all_map_points():
                if mp.ref_kf_id not in m.keyframes and mp.observations:
                    mp.ref_kf_id = next(iter(mp.observations))
                m.update_normal_and_depth(mp, self.config.orb.scale_factors)
            m.correction_epoch += 1
            self.tracker.relocalize_next()
        log.info("map loaded from %s (%d points, %d keyframes)", path, m.n_map_points(),
                 m.n_keyframes())
        return id_map


class _SavedFrame:
    """Keyframe i of a `save_map` file as the frame the KeyFrame constructor
    reads (host arrays only: its device payload uploads on first use), its
    bindings renumbered through `id_map`."""

    def __init__(self, data, i: int, id_map: dict):
        self.id = int(data["kf_frame_ids"][i])
        self.timestamp = float(data["kf_timestamps"][i])
        self.Rcw = data["kf_Rcw"][i]
        self.tcw = data["kf_tcw"][i]
        self.kp_xy = data["kf_kp_xy"][i]
        self.kp_und = data["kf_kp_und"][i]
        self.kp_octave = data["kf_kp_octave"][i]
        self.kp_angle = data["kf_kp_angle"][i]
        self.kp_response = data["kf_kp_response"][i]
        self.desc = data["kf_desc"][i]
        self.kp_valid = data["kf_kp_valid"][i]
        self.mp_ids = np.array([id_map.get(int(old), -1) for old in data["kf_mp_ids"][i]], np.int64)
