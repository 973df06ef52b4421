"""Host-side map data model: Map, KeyFrame, MapPoint.

Port of `ceres_mono_orb_slam2_tpu/models/map.py`, which is host numpy: the
same code, with the keyframe's device payload (`KeyFrame.dev`) held as torch
tensors on the tracker's device.

The reference keeps these as mutex-guarded pointer graphs (src/Map.cc,
src/KeyFrame.cc, src/MapPoint.cc). The graph machinery (covisibility,
spanning tree, bad-flag lifecycle) is pointer-heavy host logic and not hot,
so it stays in Python; all per-keyframe tensor payloads (keypoints,
descriptors) are numpy SoA arrays that upload to device in padded batches at
the call sites that need them (matchers, BA).

Behavioral parity notes:
- covisibility edges kept at weight >= 15, else the single best
  (KeyFrame::UpdateConnections, KeyFrame.cc:314-398)
- spanning tree: first connection becomes the parent (KeyFrame.cc:392-396)
- KeyFrame::SetBadFlag re-parents children to the best candidate among each
  child's covisibles that are already connected to the tree (KeyFrame.cc:460-553)
- MapPoint distinctive descriptor = min median Hamming over observations
  (MapPoint::ComputeDistinctiveDescriptors, MapPoint.cc:256-315)
- normal/depth update and scale prediction (MapPoint.cc:335-420)
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.utils import graphs

COVIS_TH = 15  # minimum shared-point weight for a covisibility edge


def hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Popcount Hamming distance over trailing 32-byte axis (numpy)."""
    return np.unpackbits(np.bitwise_xor(a, b), axis=-1).sum(-1)


# byte -> popcount lookup table (refresh_points uses it instead of
# unpackbits to avoid the 8x intermediate blow-up on (P, K, K, 32) blocks)
_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)


class MapPoint:
    __slots__ = (
        "id", "_pos", "_map", "_epoch", "_descriptor", "_normal", "_min_dist",
        "_max_dist", "observations", "_ref_kf_id", "first_kf_id",
        "n_visible", "n_found", "bad", "replaced_by", "last_frame_seen",
    )

    def __init__(self, mp_id: int, pos: np.ndarray, descriptor: np.ndarray, ref_kf_id: int):
        self.id = mp_id
        self._map: Optional["Map"] = None
        self._epoch = -1
        self._pos = pos.astype(np.float32)
        self._descriptor = descriptor.astype(np.uint8)
        self._normal = np.zeros(3, np.float32)
        self._min_dist = 0.0
        self._max_dist = 0.0
        self.observations: Dict[int, int] = {}  # kf_id -> keypoint index
        self._ref_kf_id = ref_kf_id
        self.first_kf_id = ref_kf_id
        self.n_visible = 1
        self.n_found = 1
        self.bad = False
        self.replaced_by: Optional[int] = None
        self.last_frame_seen = -1

    # Per-point fields live PRIMARILY in the Map's SoA tables (one row per
    # map-point id) so the hot paths — refresh_points' batched writes, the
    # fuse/projection gathers, _median_depth — touch one fancy-index instead
    # of thousands of Python attributes. The properties below keep the
    # object API identical; the underscore fields are the pre-registration /
    # stale-after-clear() fallback (every live point is registered via
    # Map.new_map_point, which copies them into the tables).

    def _row(self):
        # epoch check: after Map.clear() the tables regrow for NEW points
        # with the same ids; a stale object must not alias their rows
        m = self._map
        if m is not None and m.map_epoch == self._epoch \
                and self.id < len(m.mp_alive):
            return m
        return None

    @property
    def pos(self) -> np.ndarray:
        return self._pos

    @pos.setter
    def pos(self, v):
        # object-primary with table mirror (optimizer readbacks write .pos
        # per point; keeping the object authoritative avoids view aliasing)
        self._pos = np.asarray(v, np.float32)
        m = self._row()
        if m is not None:
            m.mp_pos[self.id] = self._pos

    @property
    def descriptor(self) -> np.ndarray:
        m = self._row()
        return m.mp_desc[self.id] if m is not None else self._descriptor

    @descriptor.setter
    def descriptor(self, v):
        m = self._row()
        if m is not None:
            m.mp_desc[self.id] = v
        else:
            self._descriptor = np.asarray(v, np.uint8)

    @property
    def normal(self) -> np.ndarray:
        m = self._row()
        return m.mp_normal[self.id] if m is not None else self._normal

    @normal.setter
    def normal(self, v):
        m = self._row()
        if m is not None:
            m.mp_normal[self.id] = v
        else:
            self._normal = np.asarray(v, np.float32)

    @property
    def min_dist(self) -> float:
        m = self._row()
        return float(m.mp_mind[self.id]) if m is not None else self._min_dist

    @min_dist.setter
    def min_dist(self, v):
        m = self._row()
        if m is not None:
            m.mp_mind[self.id] = v
        else:
            self._min_dist = float(v)

    @property
    def max_dist(self) -> float:
        m = self._row()
        return float(m.mp_maxd[self.id]) if m is not None else self._max_dist

    @max_dist.setter
    def max_dist(self, v):
        m = self._row()
        if m is not None:
            m.mp_maxd[self.id] = v
        else:
            self._max_dist = float(v)

    @property
    def ref_kf_id(self) -> int:
        return self._ref_kf_id

    @ref_kf_id.setter
    def ref_kf_id(self, v):
        self._ref_kf_id = v
        m = self._row()
        if m is not None:
            m.mp_ref[self.id] = v

    @property
    def n_obs(self) -> int:
        return len(self.observations)

    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)


class KeyFrame:
    _PAYLOAD = ("kp_xy", "kp_und", "kp_octave", "kp_angle", "kp_response",
                "desc", "kp_valid")

    __slots__ = (
        "id", "frame_id", "timestamp", "Rcw", "tcw",
        "_kp_xy", "_kp_und", "_kp_octave", "_kp_angle", "_kp_response",
        "_desc", "_kp_valid", "_src_frame", "dev", "_dev_ready",
        "mp_ids", "covisible", "ordered_neighbors", "parent", "children",
        "loop_edges", "bad", "not_erase", "to_be_erased", "bow_vec",
        "Tcw_gba", "gba_for_kf",
    )

    def __init__(self, kf_id: int, frame):
        self.id = kf_id
        self.frame_id = frame.id
        self.timestamp = frame.timestamp
        self.Rcw = frame.Rcw.copy()
        self.tcw = frame.tcw.copy()
        if getattr(frame, "_host_pending", False):
            # a lazy frame's host payload: the copy starts now, without
            # waiting, and the first access (the mapper's ProcessNewKeyFrame,
            # on its own thread in threaded mode) takes it
            self._src_frame = frame
            frame.start_host_copy_async()
        else:
            self._src_frame = None
            for name in self._PAYLOAD:
                setattr(self, "_" + name, getattr(frame, name))
        # device-resident keypoint payload (und, octave, angle, desc, valid)
        # shared with the source frame: the mapper's batched stages consume
        # neighbour keyframe payloads on the device. None for keyframes built
        # from host arrays only; dev_payload() uploads those once. The
        # tracker wrote them on its stream: they are handed over to the
        # mapper stream, which waits for `_dev_ready` before it reads them.
        j = getattr(frame, "j_und", None)
        self.dev = None if j is None else (frame.j_und, frame.j_octave, frame.j_angle,
                                           frame.j_desc, frame.j_valid)
        self._dev_ready = None if self.dev is None else graphs.share_with("mapper", self.dev)
        self.mp_ids = frame.mp_ids.copy()  # (N,) int64, -1 = unassociated
        self.covisible: Dict[int, int] = {}  # kf_id -> weight
        self.ordered_neighbors: List[int] = []
        self.parent: Optional[int] = None
        self.children: set = set()
        self.loop_edges: set = set()
        self.bad = False
        self.not_erase = False
        self.to_be_erased = False
        self.bow_vec = None
        self.Tcw_gba = None
        self.gba_for_kf = -1

    def _promote_payload(self):
        f = self._src_frame
        if f is None:
            return
        # the frame copies its device tensors to the host on first access;
        # keep the host refs then drop the frame so its device tensors can be
        # freed. Under the frame's lock: the tracker and the mapper thread
        # may both reach here first.
        with f._lock:
            if self._src_frame is None:
                return
            for name in self._PAYLOAD:
                setattr(self, "_" + name, getattr(f, name))
            self._src_frame = None

    def dev_payload(self, device):
        """(und, octave, angle, desc, valid) tensors on `device`, ready for
        the current stream. Keyframes created live share the source frame's
        tensors (zero transfer; the current stream waits for the stream that
        wrote them); others upload their host payload once on first use."""
        if self.dev is None:
            self.dev = tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device) for a in (
                self.kp_und, self.kp_octave, self.kp_angle, self.desc, self.kp_valid))
            self._dev_ready = None
        graphs.wait_for(self._dev_ready)
        return self.dev

    @property
    def n_kp(self) -> int:
        return len(self.mp_ids)

    def camera_center(self) -> np.ndarray:
        return (-self.Rcw.T @ self.tcw).astype(np.float32)

    def best_covisible(self, n: int) -> List[int]:
        return self.ordered_neighbors[:n]

    def tracked_map_points(self, min_obs: int, map_: "Map") -> int:
        """Count bound live points with >= min_obs observations (reference
        KeyFrame::TrackedMapPoints, KeyFrame.cc:265-290). One SoA gather —
        this runs per frame in the keyframe decision."""
        ids = self.mp_ids[self.mp_ids >= 0]
        if len(ids) == 0:
            return 0
        return int((map_.mp_alive[ids] & (map_.mp_nobs[ids] >= min_obs)).sum())


def _kf_payload_property(name: str) -> property:
    priv = "_" + name

    def get(self):
        if self._src_frame is not None:
            self._promote_payload()
        return getattr(self, priv)

    def set_(self, value):  # map-load path constructs via Frame, but keep
        if self._src_frame is not None:  # symmetric with Frame's setters
            self._promote_payload()
        setattr(self, priv, value)

    return property(get, set_)


for _name in KeyFrame._PAYLOAD:
    setattr(KeyFrame, _name, _kf_payload_property(_name))


class Map:
    """Global map registry (reference src/Map.cc). `update_lock` serializes
    tracking against loop correction / GBA, mirroring mutex_map_update_."""

    def __init__(self):
        self.keyframes: Dict[int, KeyFrame] = {}
        self.map_points: Dict[int, MapPoint] = {}
        self.next_kf_id = 0
        self.next_mp_id = 0
        self.keyframe_origins: List[int] = []
        self.big_change_idx = 0
        self.update_lock = threading.RLock()
        self.keyframe_db = None  # optional BoW database, notified on erase
        self.image_bounds = None  # (4,) [min_x, max_x, min_y, max_y], set by Tracking
        # Device-pool synchronization (models/device_map.DeviceMapPool):
        # every mutation of a map point's device-relevant state (pos,
        # descriptor, normal, scale distances, liveness) lands its id here so
        # the pool uploads only deltas between frames. `map_epoch` bumps on
        # clear() so pools know to drop everything.
        self.mp_dirty: set = set()
        self.map_epoch = 0
        # SoA mirrors of per-point hot state, indexed by map-point id (ids
        # are sequential). Kept coherent by the MapPoint.pos setter and the
        # observation-mutating methods below; lets the host hot paths
        # (_median_depth, tracked_map_points, keyframe-culling redundancy)
        # replace per-point dict walks with one numpy gather.
        self.mp_pos = np.zeros((0, 3), np.float32)
        self.mp_alive = np.zeros(0, bool)
        self.mp_nobs = np.zeros(0, np.int32)
        self.mp_desc = np.zeros((0, 32), np.uint8)
        self.mp_normal = np.zeros((0, 3), np.float32)
        self.mp_mind = np.zeros(0, np.float32)
        self.mp_maxd = np.zeros(0, np.float32)
        self.mp_ref = np.zeros(0, np.int64)
        # bumps on whole-map POSE rewrites (loop correction, GBA apply). The
        # tracker discards (and re-tracks) a frame when this moved since its
        # prepare (a pipelined in-flight frame, or a fused frame's unlocked
        # device phase): its device outputs mix pre-correction geometry
        # with post-correction keyframe poses, which would corrupt the
        # trajectory log and the motion model. Local BA is deliberately NOT a
        # correction (pose deltas are bounded; the dirty-point chain break
        # already handles it).
        self.correction_epoch = 0
        # culled keyframes' pose relative to their parent at cull time
        # (reference KeyFrame.cc:543 mTcp): lets trajectory savers/evals
        # resolve frames whose reference keyframe was later culled by
        # walking the parent chain (reference MonoORBSlam saver semantics).
        self.culled_kf_rel: Dict[int, tuple] = {}

    def note_mp_dirty(self, mid: int):
        self.mp_dirty.add(mid)

    def note_all_mp_dirty(self):
        """Bulk invalidation after whole-map rewrites (GBA apply, loop
        correction): every live point's device mirror is stale."""
        self.correction_epoch += 1
        for mid, mp in self.map_points.items():
            if not mp.bad:
                self.mp_dirty.add(mid)

    def resolve_kf_pose(self, kf_id: int, R_rel, t_rel):
        """Compose a keyframe-relative pose (frame = T_rel · T_kf) into a
        world pose, following the culled-keyframe parent chain when kf_id is
        no longer live (the reference saver walks pKF->mTcp up to a live
        parent, MonoORBSlam.cc:286-300). Returns (Rcw, tcw) or None."""
        depth = 0
        while kf_id not in self.keyframes:
            rec = self.culled_kf_rel.get(kf_id)
            if rec is None or depth > 256:
                return None
            Rcp, tcp, kf_id = rec
            t_rel = R_rel @ tcp + t_rel
            R_rel = R_rel @ Rcp
            depth += 1
        kf = self.keyframes[kf_id]
        return R_rel @ kf.Rcw, R_rel @ kf.tcw + t_rel

    # ----- creation / deletion -------------------------------------------------

    def new_keyframe(self, frame) -> KeyFrame:
        kf = KeyFrame(self.next_kf_id, frame)
        self.next_kf_id += 1
        self.keyframes[kf.id] = kf
        return kf

    def _ensure_mp_cap(self, mid: int):
        if mid >= len(self.mp_alive):
            cap = max(1024, 2 * len(self.mp_alive))
            while cap <= mid:
                cap *= 2
            n = len(self.mp_alive)

            def grow(old, shape, dtype):
                a = np.zeros(shape, dtype)
                a[:n] = old
                return a

            self.mp_pos = grow(self.mp_pos, (cap, 3), np.float32)
            self.mp_alive = grow(self.mp_alive, cap, bool)
            self.mp_nobs = grow(self.mp_nobs, cap, np.int32)
            self.mp_desc = grow(self.mp_desc, (cap, 32), np.uint8)
            self.mp_normal = grow(self.mp_normal, (cap, 3), np.float32)
            self.mp_mind = grow(self.mp_mind, cap, np.float32)
            self.mp_maxd = grow(self.mp_maxd, cap, np.float32)
            self.mp_ref = grow(self.mp_ref, cap, np.int64)

    def new_map_point(self, pos, descriptor, ref_kf_id) -> MapPoint:
        mp = MapPoint(self.next_mp_id, pos, descriptor, ref_kf_id)
        self.next_mp_id += 1
        self.map_points[mp.id] = mp
        self.mp_dirty.add(mp.id)
        self._ensure_mp_cap(mp.id)
        mp._map = self
        mp._epoch = self.map_epoch
        self.mp_pos[mp.id] = mp._pos
        self.mp_alive[mp.id] = True
        self.mp_desc[mp.id] = mp._descriptor
        self.mp_normal[mp.id] = mp._normal
        self.mp_mind[mp.id] = mp._min_dist
        self.mp_maxd[mp.id] = mp._max_dist
        self.mp_ref[mp.id] = mp._ref_kf_id
        return mp

    def get_mp(self, mid: int) -> Optional[MapPoint]:
        mp = self.map_points.get(mid)
        if mp is None or mp.bad:
            return None
        return mp

    def resolve(self, mid: int) -> int:
        """Follow Replace() forwarding pointers."""
        seen = 0
        while mid >= 0 and seen < 16:
            mp = self.map_points.get(mid)
            if mp is None:
                return -1
            if mp.replaced_by is None:
                return mid if not mp.bad else -1
            mid = mp.replaced_by
            seen += 1
        return -1

    # ----- observations / covisibility -----------------------------------------

    def add_observation(self, mp: MapPoint, kf: KeyFrame, idx: int):
        # keep kf.mp_ids and mp.observations exactly inverse: re-binding the
        # same (mp, kf) pair to a new keypoint slot must clear the old slot
        # (the vectorized builders in LocalMapping reconstruct observations
        # from the kf side and rely on this invariant)
        old = mp.observations.get(kf.id)
        if old is not None and old != idx and kf.mp_ids[old] == mp.id:
            kf.mp_ids[old] = -1
        mp.observations[kf.id] = idx
        kf.mp_ids[idx] = mp.id
        self.mp_nobs[mp.id] = len(mp.observations)

    def erase_observation(self, mp: MapPoint, kf_id: int):
        idx = mp.observations.pop(kf_id, None)
        if idx is not None:
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.mp_ids[idx] == mp.id:
                kf.mp_ids[idx] = -1
            self.mp_nobs[mp.id] = len(mp.observations)
        if mp.n_obs <= 2:
            self.set_bad_map_point(mp)
        elif mp.ref_kf_id == kf_id and mp.observations:
            mp.ref_kf_id = next(iter(mp.observations))

    def set_bad_map_point(self, mp: MapPoint):
        mp.bad = True
        self.mp_dirty.add(mp.id)
        self.mp_alive[mp.id] = False
        self.mp_nobs[mp.id] = 0
        for kf_id, idx in list(mp.observations.items()):
            kf = self.keyframes.get(kf_id)
            if kf is not None and kf.mp_ids[idx] == mp.id:
                kf.mp_ids[idx] = -1
        mp.observations.clear()

    def replace_map_point(self, mp: MapPoint, target: MapPoint, refresh: bool = True):
        """Reference MapPoint::Replace (MapPoint.cc:199-233). `refresh=False`
        defers the target's distinctive-descriptor recompute so batch callers
        (the fuse merge loops) can refresh all touched targets in one
        vectorized refresh_points pass instead of ~0.2 ms per replace."""
        if mp.id == target.id:
            return
        for kf_id, idx in list(mp.observations.items()):
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            if kf_id not in target.observations:
                target.observations[kf_id] = idx
                kf.mp_ids[idx] = target.id
            else:
                if kf.mp_ids[idx] == mp.id:
                    kf.mp_ids[idx] = -1
        target.n_found += mp.n_found
        target.n_visible += mp.n_visible
        mp.observations.clear()
        mp.bad = True
        mp.replaced_by = target.id
        self.mp_dirty.add(mp.id)
        self.mp_alive[mp.id] = False
        self.mp_nobs[mp.id] = 0
        self.mp_nobs[target.id] = len(target.observations)
        if refresh:
            self.compute_distinctive_descriptor(target)

    def _obs_arrays(self):
        """Global observation table: flat (map-point id, keyframe id, octave)
        rows over every live keyframe's bound slots, sorted by map-point id.
        kf.mp_ids is the exact inverse of mp.observations (add_observation
        invariant), so the rows are exactly the live observations — built
        with per-keyframe numpy gathers instead of per-point dict walks."""
        mids, kfids, octs = [], [], []
        for okf in self.keyframes.values():
            if okf.bad:
                continue
            rows = np.nonzero(okf.mp_ids >= 0)[0]
            if len(rows) == 0:
                continue
            mids.append(okf.mp_ids[rows])
            kfids.append(np.full(len(rows), okf.id, np.int64))
            octs.append(okf.kp_octave[rows].astype(np.int32))
        if not mids:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.int32)
        mid = np.concatenate(mids)
        order = np.argsort(mid, kind="stable")
        return (mid[order], np.concatenate(kfids)[order],
                np.concatenate(octs)[order])

    def update_connections(self, kf: KeyFrame):
        """Reference KeyFrame::UpdateConnections (KeyFrame.cc:314-398).
        Shared-point weights count with one sorted-membership pass per live
        keyframe (the per-point dict walk cost ~2-5 ms x 2-3 calls per
        keyframe insertion on the single host core)."""
        ids = kf.mp_ids[kf.mp_ids >= 0]
        if len(ids):
            # defensive: a reset may have shrunk the SoA tables while a
            # stale keyframe (captured before the reset) still holds ids
            # beyond the new table; drop those rather than crash the worker
            ids = ids[ids < len(self.mp_alive)]
        if len(ids):
            ids = ids[self.mp_alive[ids]]
        counter: Dict[int, int] = {}
        if len(ids):
            # candidate observers from the points' own observation dicts
            # (cheap set union, no per-row numpy); the vectorized membership
            # pass then runs over those ~10-30 keyframes instead of the whole
            # registry — scale-independent at KITTI-00 map sizes
            cand: set = set()
            mp_table = self.map_points
            for mid in ids.tolist():
                cand.update(mp_table[mid].observations)
            cand.discard(kf.id)
            ids_sorted = np.sort(ids)
            for okf_id in sorted(cand):  # deterministic counter order
                okf = self.keyframes.get(okf_id)
                if okf is None or okf.bad:
                    continue
                oids = okf.mp_ids[okf.mp_ids >= 0]
                if len(oids) == 0:
                    continue
                p = np.searchsorted(ids_sorted, oids)
                w = int((ids_sorted[np.minimum(p, len(ids_sorted) - 1)] == oids).sum())
                if w > 0:
                    counter[okf.id] = w
        if not counter:
            return
        # Neighbor ranking is weight desc with ties broken newest-first
        # (higher id). The reference's tie order is std::map pointer order —
        # arbitrary; here it must be total and implementation-independent
        # (host dict insertion order leaked into the graph before), and
        # newest-first is the robust choice: among equal-weight neighbors a
        # RECENT keyframe is more likely to share the current view, so the
        # best_covisible(N) cuts keep the frontier in the tracking local
        # block (oldest-first ties starved matching mid-sweep on the ring
        # world: tracking lost at frame ~50/104).
        best_id = min(counter, key=lambda k: (-counter[k], -k))
        connected = {k: w for k, w in counter.items() if w >= COVIS_TH}
        if not connected:
            connected = {best_id: counter[best_id]}
        kf.covisible = connected
        kf.ordered_neighbors = sorted(connected, key=lambda k: (-connected[k], -k))
        for okf_id, w in connected.items():
            okf = self.keyframes.get(okf_id)
            if okf is not None and not okf.bad:
                okf.covisible[kf.id] = w
                okf.ordered_neighbors = sorted(okf.covisible, key=lambda k, c=okf.covisible: (-c[k], -k))
        # spanning tree: first connection sets the parent
        if kf.parent is None and kf.id != 0:
            kf.parent = best_id
            parent = self.keyframes.get(best_id)
            if parent is not None:
                parent.children.add(kf.id)

    def set_not_erase(self, kf: KeyFrame):
        """Reference KeyFrame::SetNotErase (KeyFrame.cc:443-446): protect a
        keyframe from culling while loop closing holds a reference to it
        (current keyframe + loop candidates for the whole
        detect -> sim3 -> correct window, LoopClosing.cc:113,255). Takes
        `update_lock`, as `set_erase` does: the loop closer calls both from
        the mapper thread while the tracker reads the map."""
        with self.update_lock:
            kf.not_erase = True

    def set_erase(self, kf: KeyFrame):
        """Reference KeyFrame::SetErase (KeyFrame.cc:448-458): release the
        protection; if a cull was requested meanwhile (to_be_erased), honor
        it now."""
        with self.update_lock:
            if not kf.loop_edges:
                kf.not_erase = False
            if kf.to_be_erased:
                kf.to_be_erased = False
                self.erase_keyframe(kf)

    def erase_keyframe(self, kf: KeyFrame):
        """Reference KeyFrame::SetBadFlag (KeyFrame.cc:460-553): remove
        observations, detach covisibility, re-parent spanning-tree children."""
        if kf.id == 0:
            return
        if kf.not_erase:
            kf.to_be_erased = True
            return
        for mid in kf.mp_ids:
            if mid >= 0:
                mp = self.map_points.get(int(mid))
                if mp is not None:
                    idx = mp.observations.pop(kf.id, None)
                    if idx is not None:
                        self.mp_nobs[mp.id] = len(mp.observations)
                        if mp.n_obs <= 2:
                            self.set_bad_map_point(mp)
        for okf_id in list(kf.covisible):
            okf = self.keyframes.get(okf_id)
            if okf is not None:
                okf.covisible.pop(kf.id, None)
                okf.ordered_neighbors = sorted(okf.covisible, key=lambda k, c=okf.covisible: (-c[k], -k))
        # re-parent children: greedy, candidates = connected-to-tree set
        candidates = {kf.parent} if kf.parent is not None else set()
        children = set(kf.children)
        while children:
            best = None  # (weight, child, new_parent)
            for ch_id in children:
                ch = self.keyframes.get(ch_id)
                if ch is None or ch.bad:
                    continue
                for cand_id in candidates:
                    w = ch.covisible.get(cand_id)
                    if w is not None and (best is None or w > best[0]):
                        best = (w, ch_id, cand_id)
            if best is None:
                break
            _, ch_id, new_parent = best
            ch = self.keyframes[ch_id]
            ch.parent = new_parent
            par = self.keyframes.get(new_parent)
            if par is not None:
                par.children.add(ch_id)
            candidates.add(ch_id)
            children.remove(ch_id)
        # orphans hang off the erased keyframe's parent
        for ch_id in children:
            ch = self.keyframes.get(ch_id)
            if ch is not None:
                ch.parent = kf.parent
                par = self.keyframes.get(kf.parent) if kf.parent is not None else None
                if par is not None:
                    par.children.add(ch_id)
        if kf.parent is not None:
            par = self.keyframes.get(kf.parent)
            if par is not None:
                par.children.discard(kf.id)
        kf.bad = True
        kf.dev = None  # free the ~100 KB device payload
        # record the pose relative to the (re-parented-from) parent so
        # trajectory entries referencing this keyframe stay resolvable
        # (reference mTcp = Tcw · parent.Twc, KeyFrame.cc:543)
        if kf.parent is not None and kf.parent in self.keyframes:
            par = self.keyframes[kf.parent]
            Rcp = (kf.Rcw @ par.Rcw.T).astype(np.float32)
            tcp = (kf.tcw - Rcp @ par.tcw).astype(np.float32)
            self.culled_kf_rel[kf.id] = (Rcp, tcp, kf.parent)
        if self.keyframe_db is not None:
            self.keyframe_db.erase(kf.id, kf.bow_vec)
        del self.keyframes[kf.id]

    # ----- map point statistics -------------------------------------------------

    def compute_distinctive_descriptor(self, mp: MapPoint):
        descs = []
        for kf_id, idx in mp.observations.items():
            kf = self.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                descs.append(kf.desc[idx])
        if not descs:
            return
        D = np.stack(descs)
        dist = hamming_np(D[:, None, :], D[None, :, :])
        medians = np.median(dist, axis=1)
        mp.descriptor = D[int(np.argmin(medians))].copy()
        self.mp_dirty.add(mp.id)

    def update_normal_and_depth(self, mp: MapPoint, scale_factors: np.ndarray):
        """Reference MapPoint::UpdateNormalAndDepth (MapPoint.cc:335-388)."""
        if not mp.observations:
            return
        normal = np.zeros(3, np.float64)
        n = 0
        for kf_id in mp.observations:
            kf = self.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            v = mp.pos - kf.camera_center()
            nv = np.linalg.norm(v)
            if nv > 1e-9:
                normal += v / nv
                n += 1
        if n == 0:
            return
        ref = self.keyframes.get(mp.ref_kf_id)
        if ref is None or ref.bad:
            mp.ref_kf_id = next(iter(mp.observations))
            ref = self.keyframes.get(mp.ref_kf_id)
            if ref is None:
                return
        dist = float(np.linalg.norm(mp.pos - ref.camera_center()))
        idx = mp.observations.get(ref.id)
        level = int(ref.kp_octave[idx]) if idx is not None else 0
        n_levels = len(scale_factors)
        mp.max_dist = dist * float(scale_factors[level])
        mp.min_dist = mp.max_dist / float(scale_factors[n_levels - 1])
        mp.normal = (normal / n).astype(np.float32)
        self.mp_dirty.add(mp.id)

    def refresh_points(self, ids, scale_factors: np.ndarray, descriptors: bool = True):
        """Batched compute_distinctive_descriptor + update_normal_and_depth
        over a set of map-point ids. Same semantics as the per-point
        functions (MapPoint.cc:256-315, 335-388) but vectorized with numpy:
        the per-point versions cost ~100-300 us each in small-array overhead,
        which dominated LocalMapping on the single host core (profiled:
        ~40 % of _create_new_map_points / _search_in_neighbors wall).

        Points are bucketed by observation count so the (P, K, K) pairwise
        Hamming block stays near sum(K_p^2) work."""
        n_levels = len(scale_factors)
        sf_last = float(scale_factors[n_levels - 1])
        centers: Dict[int, np.ndarray] = {}

        def center_of(kf: KeyFrame) -> np.ndarray:
            c = centers.get(kf.id)
            if c is None:
                c = kf.camera_center()
                centers[kf.id] = c
            return c

        # ---- flat observation rows: p (point row), s (slot within point),
        # desc row, camera center row. Two builders with identical output
        # shape: the per-point dict walk for small batches, and a per-KEYFRAME
        # numpy membership pass for large ones (a post-BA refresh touches
        # thousands of points; the per-observation Python loop was ~20 ms/call
        # x 4 calls per keyframe on the single host core).
        uids = np.unique(np.asarray(list(ids), np.int64).ravel()) if not isinstance(ids, np.ndarray) else np.unique(ids)
        if len(uids) == 0:
            return
        uids = uids[(uids >= 0) & (uids < len(self.mp_alive))]
        uids = uids[self.mp_alive[uids]]
        if len(uids) == 0:
            return
        U = len(uids)
        mps = [self.map_points[int(u)] for u in uids]
        cnt_all = np.zeros(U, np.int64)
        p_parts, s_parts, desc_parts, ctr_parts = [], [], [], []
        kf_parts, oct_parts = [], []
        if U < 96:
            for p, mp in enumerate(mps):
                for kf_id, idx in mp.observations.items():
                    kf = self.keyframes.get(kf_id)
                    if kf is None or kf.bad:
                        continue
                    p_parts.append(p)
                    s_parts.append(cnt_all[p])
                    cnt_all[p] += 1
                    if descriptors:
                        desc_parts.append(kf.desc[idx])
                    ctr_parts.append(center_of(kf))
                    kf_parts.append(kf_id)
                    oct_parts.append(int(kf.kp_octave[idx]))
            if not p_parts:
                return
            p_flat = np.asarray(p_parts, np.int64)
            s_flat = np.asarray(s_parts, np.int64)
            desc_flat = np.stack(desc_parts) if descriptors else None
            ctr_flat = np.stack(ctr_parts)
            kfid_flat = np.asarray(kf_parts, np.int64)
            oct_flat = np.asarray(oct_parts, np.int64)
        else:
            # observation order = keyframe-registry order (the reference's
            # std::map<KeyFrame*,...> is pointer-ordered, i.e. just as
            # arbitrary); only median tie-breaks can differ. Candidate
            # observers are collected from the points' observation dicts so
            # the membership pass scales with the WINDOW's covisibility, not
            # the whole keyframe registry (KITTI-00-scale maps).
            if 4 * U < int(self.mp_alive.sum()):
                # window refresh: observers collected from the points' dicts
                # so the pass scales with the window's covisibility
                cand: set = set()
                mp_table = self.map_points
                for u in uids.tolist():
                    cand.update(mp_table[u].observations)
                kf_iter = [self.keyframes.get(k) for k in sorted(cand)]
            else:
                # bulk refresh (map load, post-GBA): walking every point's
                # dict costs more than one pass over the registry
                kf_iter = list(self.keyframes.values())
            for kf in kf_iter:
                if kf is None or kf.bad:
                    continue
                rows = np.nonzero(kf.mp_ids >= 0)[0]
                if len(rows) == 0:
                    continue
                bids = kf.mp_ids[rows]
                pp = np.minimum(np.searchsorted(uids, bids), U - 1)
                hit = uids[pp] == bids
                if not hit.any():
                    continue
                pr, ir = pp[hit], rows[hit]
                p_parts.append(pr)
                s_parts.append(cnt_all[pr].copy())
                cnt_all[pr] += 1
                if descriptors:
                    desc_parts.append(kf.desc[ir])
                ctr_parts.append(np.broadcast_to(center_of(kf), (len(pr), 3)))
                kf_parts.append(np.full(len(pr), kf.id, np.int64))
                oct_parts.append(kf.kp_octave[ir].astype(np.int64))
            if not p_parts:
                return
            p_flat = np.concatenate(p_parts)
            s_flat = np.concatenate(s_parts)
            desc_flat = np.vstack(desc_parts) if descriptors else None
            ctr_flat = np.vstack(ctr_parts)
            kfid_flat = np.concatenate(kf_parts)
            oct_flat = np.concatenate(oct_parts)

        live = np.nonzero(cnt_all > 0)[0]
        if len(live) == 0:
            return
        kbucket = np.zeros(U, np.int64)
        kbucket[live] = 1 << np.maximum(
            1, np.frexp((cnt_all[live] - 1).astype(np.float64))[1])
        brow = np.zeros(U, np.int64)
        pK_flat = kbucket[p_flat]

        live_kf_sorted = np.sort(np.array(
            [k for k, okf in self.keyframes.items() if not okf.bad], np.int64))
        for K in np.unique(kbucket[live]):
            sel = np.nonzero(kbucket == K)[0]
            brow[sel] = np.arange(len(sel))
            bmps = [mps[int(q)] for q in sel]
            P = len(bmps)
            cnt = cnt_all[sel]
            pos = self.mp_pos[uids[sel]].astype(np.float64)
            desc = np.zeros((P, K, 32), np.uint8)
            ctr = np.zeros((P, K, 3), np.float64)
            fsel = pK_flat == K
            if descriptors:
                desc[brow[p_flat[fsel]], s_flat[fsel]] = desc_flat[fsel]
            ctr[brow[p_flat[fsel]], s_flat[fsel]] = ctr_flat[fsel]

            col_valid = np.arange(K)[None, :] < cnt[:, None]
            if descriptors:
                # pairwise Hamming + per-row median over the valid prefix;
                # hardware popcount over uint64 lanes is ~3x the byte-LUT
                # gather on this (P, K, K, 32) block
                if hasattr(np, "bitwise_count"):
                    d8 = desc.view(np.uint64).reshape(P, K, 4)
                    x8 = d8[:, :, None, :] ^ d8[:, None, :, :]
                    dist = np.bitwise_count(x8).sum(-1, dtype=np.int32)
                else:
                    x = desc[:, :, None, :] ^ desc[:, None, :, :]
                    dist = _POPCNT[x].sum(-1, dtype=np.int32)  # (P, K, K)
                dist = np.where(col_valid[:, None, :], dist, 1 << 20)
                dist.sort(axis=2)
                lo = np.take_along_axis(dist, ((cnt - 1) // 2)[:, None, None], axis=2)[..., 0]
                hi = np.take_along_axis(dist, (cnt // 2)[:, None, None], axis=2)[..., 0]
                med = 0.5 * (lo + hi)  # == np.median over the cnt-long prefix
                med = np.where(col_valid, med, np.inf)
                best = np.argmin(med, axis=1)

            # viewing normal: mean of unit rays over valid observations
            v = pos[:, None, :] - ctr
            nv = np.linalg.norm(v, axis=2)
            ok = col_valid & (nv > 1e-9)
            unit = np.where(ok[..., None], v / np.maximum(nv, 1e-12)[..., None], 0.0)
            nsum = unit.sum(axis=1)
            nobs = ok.sum(axis=1)

            # ref-KF scale distances, fully vectorized: ref ids gather from
            # the mp_ref table; the observation level comes from this
            # bucket's own flat rows (the row whose keyframe IS the point's
            # ref); points whose ref went bad fall back to a (rare) repair
            # loop that reassigns the first live observer.
            bids = uids[sel]
            refs = self.mp_ref[bids]
            live_sorted = live_kf_sorted
            if len(live_sorted):
                pq = np.minimum(np.searchsorted(live_sorted, refs),
                                len(live_sorted) - 1)
                ref_ok = live_sorted[pq] == refs
            else:
                ref_ok = np.zeros(P, bool)
            for p in np.nonzero(~ref_ok & (nobs > 0))[0]:
                mp = bmps[int(p)]
                if not mp.observations:
                    continue
                mp.ref_kf_id = next(iter(mp.observations))  # table mirror
                ref = self.keyframes.get(mp.ref_kf_id)
                if ref is not None and not ref.bad:
                    refs[p] = mp.ref_kf_id
                    ref_ok[p] = True
            # bucket rows: match each row's keyframe against its point's ref
            rp = brow[p_flat[fsel]]
            rmatch = kfid_flat[fsel] == refs[rp]
            sf = np.asarray(scale_factors, np.float64)
            lv = np.zeros(P, np.int64)  # level 0 when the ref isn't an observer
            lv[rp[rmatch]] = oct_flat[fsel][rmatch]
            ctr_ref = np.zeros((P, 3), np.float64)
            seen_ref = np.zeros(P, bool)
            ctr_ref[rp[rmatch]] = ctr_flat[fsel][rmatch]
            seen_ref[rp[rmatch]] = True
            # ref alive but not an observer: its center isn't in the rows
            for p in np.nonzero(ref_ok & ~seen_ref & (nobs > 0))[0]:
                ref = self.keyframes.get(int(refs[p]))
                if ref is not None:
                    ctr_ref[p] = center_of(ref)
                    seen_ref[p] = True
            has_ref = ref_ok & seen_ref & (nobs > 0)
            d = np.linalg.norm(pos - ctr_ref, axis=1)
            max_d = d * sf[lv]
            normals = (nsum / np.maximum(nobs, 1)[:, None]).astype(np.float32)
            # one fancy-index per field instead of a per-point attribute loop
            if descriptors:
                self.mp_desc[bids] = desc[np.arange(P), best]
            wsel = bids[has_ref]
            self.mp_maxd[wsel] = max_d[has_ref]
            self.mp_mind[wsel] = max_d[has_ref] / sf_last
            self.mp_normal[wsel] = normals[has_ref]
            self.mp_dirty.update(bids.tolist())

    # ----- misc ------------------------------------------------------------------

    def all_keyframes(self) -> List[KeyFrame]:
        return [kf for kf in self.keyframes.values() if not kf.bad]

    def all_map_points(self) -> List[MapPoint]:
        return [mp for mp in self.map_points.values() if not mp.bad]

    def n_keyframes(self) -> int:
        return len(self.keyframes)

    def n_map_points(self) -> int:
        return sum(1 for mp in self.map_points.values() if not mp.bad)

    def clear(self):
        self.keyframes.clear()
        self.map_points.clear()
        self.next_kf_id = 0
        self.next_mp_id = 0
        self.keyframe_origins.clear()
        self.mp_dirty.clear()
        self.culled_kf_rel.clear()
        self.mp_pos = np.zeros((0, 3), np.float32)
        self.mp_alive = np.zeros(0, bool)
        self.mp_nobs = np.zeros(0, np.int32)
        self.mp_desc = np.zeros((0, 32), np.uint8)
        self.mp_normal = np.zeros((0, 3), np.float32)
        self.mp_mind = np.zeros(0, np.float32)
        self.mp_maxd = np.zeros(0, np.float32)
        self.mp_ref = np.zeros(0, np.int64)
        self.map_epoch += 1
        # stale MapPoint objects fall back to their underscore fields after
        # the tables shrink (MapPoint._row length guard)
