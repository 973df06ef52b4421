"""Carry state from the JAX package into the port (the SLAM counterpart of
converting weights), so port modules can run on exactly the state a JAX run
produced. Inputs are numpy arrays and duck-typed objects; nothing here
imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.map import KeyFrame, Map, MapPoint
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import FrameFeatures
from ceres_mono_orb_slam2_tpu_torch.utils import config as cfg_mod


def config_from_reference(cfg) -> cfg_mod.SlamConfig:
    """A reference `SlamConfig` (dataclass of dataclasses) as the port's."""
    def conv(obj, cls):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
                      if hasattr(obj, f.name)})

    out = cfg_mod.SlamConfig(
        camera=conv(cfg.camera, cfg_mod.CameraConfig),
        orb=conv(cfg.orb, cfg_mod.ORBConfig),
        viewer=conv(cfg.viewer, cfg_mod.ViewerConfig),
        use_viewer=cfg.use_viewer,
        fused_tracking=cfg.fused_tracking,
    )
    out.shapes = conv(cfg.shapes, cfg_mod.StaticShapes)  # already resolved
    return out


def features_from_numpy(xy, response, angle, octave, desc, valid, device="cpu") -> FrameFeatures:
    """FrameFeatures from numpy arrays (any leading batch shape)."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return FrameFeatures(xy=t(xy, np.float32), response=t(response, np.float32),
                         angle=t(angle, np.float32), octave=t(octave, np.int32),
                         desc=t(desc, np.uint8), valid=t(valid, bool))


class _FrameShim:
    """Duck-typed frame for the KeyFrame constructor (host payload only)."""

    def __init__(self, kf):
        self.id = kf.frame_id
        self.timestamp = kf.timestamp
        self.Rcw = np.asarray(kf.Rcw, np.float32)
        self.tcw = np.asarray(kf.tcw, np.float32)
        for name in KeyFrame._PAYLOAD:
            setattr(self, name, np.array(getattr(kf, name)))
        self.mp_ids = np.array(kf.mp_ids, np.int64)


def stream_state_from_reference(state, device="cpu"):
    """A reference multi-stream `StreamState` (a NamedTuple of arrays with a
    leading stream axis) as the port's, on `device`: masks stay bool, every
    other field becomes float32 (the reference keeps its +-1 descriptor bits
    in bfloat16, which holds them exactly)."""
    from ceres_mono_orb_slam2_tpu_torch.parallel.multistream import StreamState

    def conv(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a, a.dtype if a.dtype == bool else np.float32)).to(device)

    return StreamState(**{name: conv(getattr(state, name)) for name in StreamState._fields})


def vocabulary_from_reference(voc):
    """A reference `Vocabulary` (a dataclass of numpy fields) as the port's."""
    from ceres_mono_orb_slam2_tpu_torch.ops.bow import Vocabulary

    return Vocabulary(**{f.name: (np.array(getattr(voc, f.name)) if isinstance(
        getattr(voc, f.name), np.ndarray) else getattr(voc, f.name))
        for f in dataclasses.fields(Vocabulary)})


def database_from_reference(ref_db, voc, map_, device="cpu"):
    """The port's KeyFrameDatabase over `map_` with a reference database's
    inverted index (word id -> keyframe ids)."""
    from ceres_mono_orb_slam2_tpu_torch.models.keyframe_database import KeyFrameDatabase

    db = KeyFrameDatabase(voc, map_, device=device)
    db.inverted = {int(w): set(ids) for w, ids in ref_db.inverted.items()}
    map_.keyframe_db = db
    return db


def map_from_reference(ref) -> Map:
    """The port's Map holding a reference Map's state: keyframes (poses,
    keypoint payloads, bindings, covisibility, spanning tree, loop edges, BoW
    vectors), map points
    (positions, descriptors, normals, scale distances, observations,
    statistics, replacement links), id counters and the SoA tables."""
    m = Map()
    m.next_kf_id = ref.next_kf_id
    m.next_mp_id = ref.next_mp_id
    m.keyframe_origins = list(ref.keyframe_origins)
    m.image_bounds = None if ref.image_bounds is None else np.array(ref.image_bounds)
    m.map_epoch = ref.map_epoch
    for name in ("mp_pos", "mp_alive", "mp_nobs", "mp_desc", "mp_normal", "mp_mind",
                 "mp_maxd", "mp_ref"):
        setattr(m, name, np.array(getattr(ref, name)))
    m.culled_kf_rel = {k: tuple(np.array(a) if isinstance(a, np.ndarray) else a for a in v)
                       for k, v in ref.culled_kf_rel.items()}
    for kid, rkf in ref.keyframes.items():
        kf = KeyFrame(kid, _FrameShim(rkf))
        kf.covisible = dict(rkf.covisible)
        kf.ordered_neighbors = list(rkf.ordered_neighbors)
        kf.parent = rkf.parent
        kf.children = set(rkf.children)
        kf.bad = rkf.bad
        kf.loop_edges = set(rkf.loop_edges)
        kf.not_erase = rkf.not_erase
        kf.bow_vec = None if rkf.bow_vec is None else dict(rkf.bow_vec)
        m.keyframes[kid] = kf
    for mid, rmp in ref.map_points.items():
        mp = MapPoint(mid, np.array(rmp.pos), np.array(rmp.descriptor), rmp.ref_kf_id)
        mp._map = m
        mp._epoch = m.map_epoch
        mp.observations = dict(rmp.observations)
        mp.first_kf_id = rmp.first_kf_id
        mp.n_visible = rmp.n_visible
        mp.n_found = rmp.n_found
        mp.bad = rmp.bad
        mp.replaced_by = rmp.replaced_by
        mp.last_frame_seen = rmp.last_frame_seen
        m.map_points[mid] = mp
    m.mp_dirty = set(mid for mid, mp in m.map_points.items() if not mp.bad)
    return m
