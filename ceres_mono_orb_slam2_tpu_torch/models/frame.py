"""Per-frame container (reference src/Frame.cc).

Port of `ceres_mono_orb_slam2_tpu/models/frame.py`. Holds one image's
keypoint/descriptor tensors on the device (`j_*`) and their host numpy
copies, which a lazy frame fetches on first access: an ordinary fused-path
frame that never becomes a keyframe copies only its control outputs to the
host. A keyframe's promotion starts the copy early
(`start_host_copy_async`), and a per-frame lock makes the first access from
two threads (tracker and mapper) fetch once.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import camera, matcher
from ceres_mono_orb_slam2_tpu_torch.utils import graphs

_frame_counter = itertools.count()


def compute_image_bounds(cam, h: int, w: int) -> np.ndarray:
    """Undistorted image bounds from the 4 corners (ComputeImageBounds)."""
    if not cam.has_distortion:
        return np.array([0.0, w, 0.0, h], np.float32)
    corners = torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]], dtype=torch.float32)
    und = camera.undistort_points(corners, torch.as_tensor(cam.K),
                                  torch.as_tensor(cam.dist_coeffs)).numpy()
    return np.array(
        [min(und[0, 0], und[2, 0]), max(und[1, 0], und[3, 0]),
         min(und[0, 1], und[1, 1]), max(und[2, 1], und[3, 1])],
        np.float32,
    )


def undistorted_keypoints(xy: torch.Tensor, cam) -> torch.Tensor:
    """A frame's undistorted keypoints (N, 2): `xy` itself for a lens
    without distortion."""
    if not cam.has_distortion:
        return xy
    return camera.undistort_points(xy, torch.as_tensor(cam.K, device=xy.device),
                                   torch.as_tensor(cam.dist_coeffs, device=xy.device))


class Frame:
    # host-side keypoint arrays, materialised together on first access
    _HOST_FIELDS = ("kp_xy", "kp_octave", "kp_angle", "kp_response",
                    "desc", "kp_valid", "kp_und")

    def __init__(self, feats, cam, timestamp: float, frame_id=None, j_und=None,
                 lazy=False):
        """feats: FrameFeatures of ONE frame (batch dim stripped). With
        `lazy=True` the host copies are made on first access to any host
        field; otherwise at construction."""
        self.id = next(_frame_counter) if frame_id is None else frame_id
        self.timestamp = timestamp
        self._cam = cam
        self.j_xy = feats.xy
        self.j_octave = feats.octave
        self.j_angle = feats.angle
        self.j_valid = feats.valid
        self.j_desc = feats.desc
        self._j_response = feats.response
        self._j_und = j_und
        self._j_bits = None
        self._host_pending = True
        # guards the lazy host copy and the lazy j_und / j_bits fills, which
        # the tracker and the mapper thread may reach at once
        self._lock = threading.RLock()
        self._host_copy = None  # (pinned host tensors, event) of a started copy
        if not lazy:
            self._materialize_host()

        n = int(feats.xy.shape[0])
        self.mp_ids = np.full(n, -1, np.int64)
        self.outlier = np.zeros(n, bool)
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)
        self.pose_set = False

    def _payload_tensors(self):
        return (self.j_xy, self.j_octave, self.j_angle, self._j_response, self.j_desc,
                self.j_valid, self.j_und)

    def start_host_copy_async(self):
        """Start the device-to-host copy of the keypoint payload without
        waiting for it: on CUDA, non-blocking copies into pinned host tensors
        and an event recorded behind them, which the first host access waits
        on. The tracker calls this when the frame becomes a keyframe, so the
        mapper thread's first read finds the payload on the host. A no-op on
        the CPU, once started, or once materialised."""
        with self._lock:
            if not self._host_pending or self._host_copy is not None or self.device.type != "cuda":
                return
            host = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                         for a in self._payload_tensors())
            for dst, src in zip(host, self._payload_tensors()):
                dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event(blocking=True)  # see graphs.fetch
            done.record()
            self._host_copy = (host, done)

    def _materialize_host(self):
        if not self._host_pending:
            return
        with self._lock:
            if not self._host_pending:
                return
            if self._host_copy is not None:
                host, done = self._host_copy
                done.synchronize()
                arrays = tuple(a.numpy() for a in host)
            else:
                arrays = graphs.fetch(*self._payload_tensors())
            (self._kp_xy, self._kp_octave, self._kp_angle, self._kp_response,
             self._desc, self._kp_valid, self._kp_und) = arrays
            self._host_copy = None
            self._host_pending = False

    @property
    def device(self) -> torch.device:
        return self.j_xy.device

    @property
    def j_und(self):
        if self._j_und is None:
            with self._lock:
                if self._j_und is None:
                    self._j_und = undistorted_keypoints(self.j_xy, self._cam)
        return self._j_und

    @property
    def j_bits(self):
        if self._j_bits is None:
            with self._lock:
                if self._j_bits is None:
                    self._j_bits = matcher.unpack_bits_pm1(self.j_desc)
        return self._j_bits

    @property
    def n_kp(self):
        return len(self.mp_ids)

    def set_pose(self, Rcw, tcw):
        R = np.asarray(Rcw, np.float64).reshape(3, 3)
        # project to SO(3): determinant drift in composed f32 rotations acts
        # as a hidden scale factor and compounds through the velocity model
        for _ in range(2):
            R = R @ (1.5 * np.eye(3) - 0.5 * (R.T @ R))
        self.Rcw = R.astype(np.float32)
        self.tcw = np.asarray(tcw, np.float32).reshape(3)
        self.pose_set = True

    def camera_center(self) -> np.ndarray:
        return (-self.Rcw.T @ self.tcw).astype(np.float32)


def _host_field_property(name: str) -> property:
    priv = "_" + name

    def get(self):
        self._materialize_host()
        return getattr(self, priv)

    def set_(self, value):
        self._materialize_host()
        setattr(self, priv, value)

    return property(get, set_)


for _name in Frame._HOST_FIELDS:
    setattr(Frame, _name, _host_field_property(_name))
