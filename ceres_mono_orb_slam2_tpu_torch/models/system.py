"""System facade (reference src/MonoORBSlam.cc).

Port of `ceres_mono_orb_slam2_tpu/models/system.py`. Serially (the default)
each frame is tracking, then a drain of the local-mapping queue, then a
drain of the loop-closing queue. With `threaded=True` local mapping and
loop closing run on a host worker thread named `mapper` that each new
keyframe wakes, and each global BA on a thread of its own, as in the
reference's three-thread architecture (MonoORBSlam.cc:78-89); the threads
share the card's default CUDA stream, so the order of enqueue orders their
device work. With `pipelined=True` the tracker dispatches frame k's fused
step before it consumes frame k-1 (`Tracking._grab_pipelined`). With a
vocabulary the facade builds the BoW keyframe database (relocalization) and
the loop closer.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.localmapping import LocalMapping
from ceres_mono_orb_slam2_tpu_torch.models.map import Map
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
                 pipelined: bool = False, generator: Optional[torch.Generator] = None):
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
                                           threaded_gba=threaded, device=self.device)
        self.local_mapper = LocalMapping(config, self.map, loop_closer=self.loop_closer,
                                         device=self.device)
        self.tracker = Tracking(config, self.map, self.extractor, local_mapper=self.local_mapper,
                                relocalizer=self.keyframe_db, device=self.device,
                                generator=generator, pipelined=pipelined)
        if self.loop_closer is not None:
            self.loop_closer.local_mapper = self.local_mapper
        self._last_big_change = 0
        self.threaded = threaded
        # the mapper thread's wake-ups: passes asked of it and not yet run,
        # and the stop request, under one condition that also signals idle
        self._mapper_cv = threading.Condition()
        self._passes_asked = 0
        self._shutdown = False
        self._worker_error: Optional[Exception] = None
        self._worker: Optional[threading.Thread] = None
        if threaded:
            self._worker = threading.Thread(target=self._mapping_worker, name="mapper", daemon=True)
            self._worker.start()

    # --------------------------------------------------------------- threads

    def _mapping_worker(self):
        """The mapper thread: one drain of the local-mapping queue, then of
        the loop-closing queue, each time a keyframe wakes it. LocalMapping
        takes map.update_lock per stage and LoopClosing around its map reads
        and its correction, so the tracker runs between their stages. One
        pass serves every wake-up asked before it began. An exception ends
        the thread and is kept for the caller's thread."""
        cv = self._mapper_cv
        while True:
            with cv:
                cv.wait_for(lambda: self._passes_asked or self._shutdown)
                if self._shutdown:
                    return
                served = self._passes_asked
            try:
                self.local_mapper.process_queue()
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

    def track_monocular(self, image: np.ndarray, timestamp: float):
        """Reference TrackMonocular (MonoORBSlam.cc:103-141): returns Tcw
        (4, 4) numpy or None (pipelined: the pose of the frame before, one
        frame late)."""
        self._raise_worker_error()
        Tcw = self.tracker.grab_image(image, timestamp)
        self._map_after_frame()
        return Tcw

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

    def reset(self):
        with self.map.update_lock:
            self.tracker.reset()

    def shutdown(self):
        """Consume the in-flight pipelined frame, stop and join the mapper
        thread, drain the mapper under the map lock (a keyframe that the
        flush inserted never woke the thread), then the loop closer outside
        it (a loop detectable on the final keyframe must correct the map
        before the savers persist it), then join the global-BA thread.
        Re-raises a failure of the mapper thread; a second call does
        nothing new."""
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
