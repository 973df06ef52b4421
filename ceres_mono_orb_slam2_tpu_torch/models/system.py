"""System facade (reference src/MonoORBSlam.cc), serial.

Port of `ceres_mono_orb_slam2_tpu/models/system.py`: tracking, then a drain
of the local-mapping queue, then a drain of the loop-closing queue after
every frame. With a vocabulary the facade builds the BoW keyframe database
(relocalization) and the loop closer. The threaded mapper and pipelined
tracking are later ports and raise NotImplementedError here.
"""

from __future__ import annotations

import logging
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


class MonoSLAM:
    """Python equivalent of the reference MonoORBSlam facade."""

    def __init__(self, config, device=DEFAULT_DEVICE, vocabulary=None, threaded: bool = False,
                 pipelined: bool = False, generator: Optional[torch.Generator] = None):
        if threaded:
            raise NotImplementedError("the threaded mapper is not ported yet")
        if pipelined:
            raise NotImplementedError("pipelined tracking is not ported yet")
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
            self.loop_closer = LoopClosing(config, self.map, self.keyframe_db, device=self.device)
        self.local_mapper = LocalMapping(config, self.map, loop_closer=self.loop_closer,
                                         device=self.device)
        self.tracker = Tracking(config, self.map, self.extractor, local_mapper=self.local_mapper,
                                relocalizer=self.keyframe_db, device=self.device,
                                generator=generator)
        if self.loop_closer is not None:
            self.loop_closer.local_mapper = self.local_mapper
        self._last_big_change = 0

    def track_monocular(self, image: np.ndarray, timestamp: float):
        """Reference TrackMonocular (MonoORBSlam.cc:103-141): returns Tcw
        (4, 4) numpy or None."""
        Tcw = self.tracker.grab_image(image, timestamp)
        self.local_mapper.process_queue()
        if self.loop_closer is not None:
            self.loop_closer.process_queue()
        return Tcw

    def reset(self):
        with self.map.update_lock:
            self.tracker.reset()

    def shutdown(self):
        """Drain the mapper, then the loop closer: a loop detectable on the
        final keyframe must correct the map before the savers persist it."""
        with self.map.update_lock:
            self.local_mapper.process_queue()
        if self.loop_closer is not None:
            self.loop_closer.process_queue()

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
        ts_l, pos_l = [], []
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
        kfs = sorted(self.map.all_keyframes(), key=lambda k: k.id)
        with open(path, "w") as f:
            for kf in kfs:
                Rwc = kf.Rcw.T
                twc = -Rwc @ kf.tcw
                q = lie.rot_to_quat(torch.as_tensor(np.ascontiguousarray(Rwc))).numpy()
                f.write("%f %.7f %.7f %.7f %.7f %.7f %.7f %.7f\n"
                        % (kf.timestamp, twc[0], twc[1], twc[2], q[0], q[1], q[2], q[3]))
        log.info("trajectory saved to %s", path)
