"""Configuration system.

Parses the exact OpenCV-FileStorage YAML schema used by the reference
(`configs/*.yaml`: keys ``Camera.*``, ``ORBextractor.*``, ``Viewer.*``; read in
reference src/Tracking.cc:66-141 and src/Viewer.cc:51-67), so the reference's
config files run unchanged. Adds the TPU-specific static-shape budgets
(padded feature counts, match caps, BA problem sizes) that the jit kernels
compile against.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _parse_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV FileStorage YAML file into a flat {key: value} dict.

    OpenCV YAML starts with a ``%YAML:1.0`` directive that plain YAML parsers
    reject, and uses dotted keys (``Camera.fx``). We parse line-wise: this
    schema is strictly flat scalar key/value pairs.
    """
    out: dict = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%"):
                continue
            m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
            if not m:
                continue
            key, raw = m.group(1), m.group(2).strip().strip('"')
            try:
                val: object = int(raw)
            except ValueError:
                try:
                    val = float(raw)
                except ValueError:
                    val = raw
            out[key] = val
    return out


@dataclass
class CameraConfig:
    """Pinhole intrinsics + OpenCV radial-tangential distortion.

    Mirrors the ``Camera.*`` YAML keys (reference src/Tracking.cc:66-113).
    """

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    fps: float = 30.0
    rgb: int = 1
    width: Optional[int] = None
    height: Optional[int] = None

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def dist_coeffs(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], dtype=np.float32)

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclass
class ORBConfig:
    """ORB extractor parameters (``ORBextractor.*`` keys; reference
    src/Tracking.cc:115-141, src/ORBextractor.cc:410-446)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    @property
    def level_sigma2(self) -> np.ndarray:
        return self.scale_factors**2

    @property
    def inv_level_sigma2(self) -> np.ndarray:
        return 1.0 / self.level_sigma2

    @property
    def features_per_level(self) -> np.ndarray:
        """Geometric per-level feature budget (reference ORBextractor.cc:435-446)."""
        inv = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - inv) / (1 - inv**self.n_levels)
        per_level = []
        total = 0
        for _ in range(self.n_levels - 1):
            k = int(round(n_desired))
            per_level.append(k)
            total += k
            n_desired *= inv
        per_level.append(max(self.n_features - total, 0))
        return np.array(per_level, dtype=np.int32)


@dataclass
class ViewerConfig:
    """``Viewer.*`` keys (reference src/Viewer.cc:51-67, src/MapDrawer.cc:30)."""

    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.08
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0


@dataclass
class StaticShapes:
    """TPU static-shape budgets. All jit kernels compile against these;
    everything dynamic in the reference (keypoint counts, match counts,
    local-map sizes) is padded to these caps with validity masks."""

    max_features: int = 0  # 0 -> derived from ORBConfig.n_features
    max_init_features: int = 0  # 2x budget used during initialization (Tracking.cc:131)
    # Local-map candidate guard. The reference iterates ALL local points
    # (no cap); candidates are ordered by covisibility strength, so when a
    # cap binds it drops exactly the weakly-connected FRONTIER points and
    # starves map extension (observed as inlier decay -> loss at ~f470 of a
    # 500-frame run with an 8192 cap). The (keypoints x points) Hamming
    # matmul at 16384 points is ~0.2 ms on the MXU — keep this generous.
    max_local_points: int = 16384
    # Device map pool rows (0 = auto: max(4096, 4 * max_local_points)). The
    # pool's row count is an ARGUMENT SHAPE of the compiled frontend, so a
    # mid-run pool growth forces one frontend recompile; size it to the
    # expected live-map peak up front (KITTI-00 scale: ~32768).
    device_pool_cap: int = 0
    max_local_keyframes: int = 96  # local BA window incl. fixed KFs (ref caps local map at 80)
    max_ba_points: int = 8192  # point blocks in one local BA solve
    max_ba_obs: int = 32768  # observations in one local BA solve
    max_pg_keyframes: int = 2048  # pose-graph (essential graph) vertices
    max_pg_edges: int = 16384  # pose-graph edges
    ransac_hypotheses: int = 256  # batched RANSAC hypothesis count (ref: 200/300)
    grid_cols: int = 64  # feature grid (reference Frame.h:45-46)
    grid_rows: int = 48

    def resolve(self, orb: ORBConfig) -> "StaticShapes":
        out = dataclasses.replace(self)
        if out.max_features == 0:
            out.max_features = _round_up_pow2(orb.n_features)
        if out.max_init_features == 0:
            out.max_init_features = _round_up_pow2(2 * orb.n_features)
        return out


def _round_up_pow2(n: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)


@dataclass
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: ORBConfig = field(default_factory=ORBConfig)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    shapes: StaticShapes = field(default_factory=StaticShapes)
    use_viewer: bool = False
    # fused per-frame device pipeline for normal-state tracking (ONE device
    # call + ONE device_get per frame against the device-resident map pool;
    # models/fused_track). False = the multi-dispatch legacy path everywhere.
    fused_tracking: bool = True

    def __post_init__(self):
        self.shapes = self.shapes.resolve(self.orb)


def load_config(path: str, **overrides) -> SlamConfig:
    """Load a reference-format YAML config (e.g. configs/TUM2.yaml)."""
    kv = _parse_opencv_yaml(path)

    cam = CameraConfig(
        fx=float(kv.get("Camera.fx", 500.0)),
        fy=float(kv.get("Camera.fy", 500.0)),
        cx=float(kv.get("Camera.cx", 320.0)),
        cy=float(kv.get("Camera.cy", 240.0)),
        k1=float(kv.get("Camera.k1", 0.0)),
        k2=float(kv.get("Camera.k2", 0.0)),
        p1=float(kv.get("Camera.p1", 0.0)),
        p2=float(kv.get("Camera.p2", 0.0)),
        k3=float(kv.get("Camera.k3", 0.0)),
        fps=float(kv.get("Camera.fps", 30.0)),
        rgb=int(kv.get("Camera.RGB", 1)),
        width=kv.get("Camera.width"),
        height=kv.get("Camera.height"),
    )
    orb = ORBConfig(
        n_features=int(kv.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(kv.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(kv.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(kv.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(kv.get("ORBextractor.minThFAST", 7)),
    )
    viewer = ViewerConfig(
        keyframe_size=float(kv.get("Viewer.KeyFrameSize", 0.05)),
        keyframe_line_width=float(kv.get("Viewer.KeyFrameLineWidth", 1.0)),
        graph_line_width=float(kv.get("Viewer.GraphLineWidth", 0.9)),
        point_size=float(kv.get("Viewer.PointSize", 2.0)),
        camera_size=float(kv.get("Viewer.CameraSize", 0.08)),
        camera_line_width=float(kv.get("Viewer.CameraLineWidth", 3.0)),
        viewpoint_x=float(kv.get("Viewer.ViewpointX", 0.0)),
        viewpoint_y=float(kv.get("Viewer.ViewpointY", -0.7)),
        viewpoint_z=float(kv.get("Viewer.ViewpointZ", -1.8)),
        viewpoint_f=float(kv.get("Viewer.ViewpointF", 500.0)),
    )
    cfg = SlamConfig(camera=cam, orb=orb, viewer=viewer)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
