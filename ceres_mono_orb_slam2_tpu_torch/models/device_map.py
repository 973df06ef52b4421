"""Device-resident map-point pool.

Port of `ceres_mono_orb_slam2_tpu/models/device_map.py`. The map-point SoA
tensors (position, viewing normal, scale-invariance distances, descriptor,
liveness) stay on the device and only deltas are uploaded:

- `Map.mp_dirty` accumulates the ids every host-side map operation mutates;
- `sync()` drains it into one in-place row scatter (`_pool_scatter`);
- `_pool_gather(slots)` compacts the per-frame local-map rows into the
  fixed-size block the fused tracking step consumes; `gather_fills(slots)`
  is the same gather written straight into a captured program's static
  buffers (`utils/graphs.py`), so that no capture reads the pool's tensors,
  which `sync` replaces after growth, a reset or a map change.

Rows [0, cap) hold map points; row `cap` is a scratch row that is never
valid, so index padding routes there. Capacity doubles on exhaustion.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from ceres_mono_orb_slam2_tpu_torch.utils.padding import bucket


def _pool_scatter(dev, idx, pos, normal, mind, maxd, desc, valid):
    """Write rows `idx` of the pool tensors in place."""
    for dst, src in zip(dev, (pos, normal, mind, maxd, desc, valid)):
        dst.index_copy_(0, idx, src)
    return dev


def _pool_gather(jpos, jnormal, jmind, jmaxd, jdesc, jvalid, slots):
    return (jpos[slots], jnormal[slots], jmind[slots], jmaxd[slots],
            jdesc[slots], jvalid[slots])


class DeviceMapPool:
    def __init__(self, map_, cap: int = 4096, device=DEFAULT_DEVICE):
        self.map = map_
        self.cap = cap
        self.device = resolve_device(device)
        self.epoch = -1  # != any map_epoch: the first sync() mirrors everything
        self._alloc_host(cap)
        # id -> slot lookup, grown with next_mp_id (ids are monotonic)
        self.slot_of = np.full(max(1024, map_.next_mp_id + 1), -1, np.int32)
        self.free = list(range(cap - 1, -1, -1))
        self.dev = None  # device tensors, rows = cap + 1 (scratch last)
        self.n_grows = 0
        self._row_of_slot = np.full(cap + 1, -1, np.int32)

    # ------------------------------------------------------------------ host

    def _alloc_host(self, cap: int):
        self.pos = np.zeros((cap, 3), np.float32)
        self.normal = np.zeros((cap, 3), np.float32)
        self.mind = np.zeros(cap, np.float32)
        self.maxd = np.zeros(cap, np.float32)
        self.desc = np.zeros((cap, 32), np.uint8)
        self.valid = np.zeros(cap, bool)
        self.id_of = np.full(cap, -1, np.int64)

    def _grow(self):
        old = self.cap
        new = old * 2
        for name in ("pos", "normal", "desc"):
            a = getattr(self, name)
            b = np.zeros((new,) + a.shape[1:], a.dtype)
            b[:old] = a
            setattr(self, name, b)
        for name, fill in (("mind", 0), ("maxd", 0), ("valid", False), ("id_of", -1)):
            a = getattr(self, name)
            b = np.full((new,), fill, a.dtype)
            b[:old] = a
            setattr(self, name, b)
        self.free.extend(range(new - 1, old - 1, -1))
        self.cap = new
        self.dev = None  # full re-upload at the new capacity
        self._row_of_slot = np.full(new + 1, -1, np.int32)
        self.n_grows += 1

    def _ensure_slot(self, mid: int) -> int:
        if mid >= len(self.slot_of):
            b = np.full(max(len(self.slot_of) * 2, mid + 1), -1, np.int32)
            b[: len(self.slot_of)] = self.slot_of
            self.slot_of = b
        s = self.slot_of[mid]
        if s >= 0:
            return int(s)
        if not self.free:
            self._grow()
        s = self.free.pop()
        self.slot_of[mid] = s
        self.id_of[s] = mid
        return s

    def _release_slot(self, mid: int):
        if mid >= len(self.slot_of):
            return -1
        s = int(self.slot_of[mid])
        if s >= 0:
            self.slot_of[mid] = -1
            self.id_of[s] = -1
            self.valid[s] = False
            self.free.append(s)
        return s

    # ------------------------------------------------------------------ sync

    def _full_reset(self):
        m = self.map
        self.epoch = m.map_epoch
        self._alloc_host(self.cap)
        self.slot_of = np.full(max(1024, m.next_mp_id + 1), -1, np.int32)
        self.free = list(range(self.cap - 1, -1, -1))
        self.dev = None
        for mid, mp in m.map_points.items():
            if not mp.bad:
                m.mp_dirty.add(mid)

    def _to_dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def sync(self):
        """Drain Map.mp_dirty into the device mirrors (call under
        map.update_lock): one row scatter when there are deltas, a full upload
        after growth or reset, nothing otherwise."""
        m = self.map
        if m.map_epoch != self.epoch:
            self._full_reset()
        dirty = m.mp_dirty
        if dirty:
            m.mp_dirty = set()
        changed = []
        live_ids, live_slots = [], []
        for mid in dirty:
            mp = m.map_points.get(mid)
            if mp is None or mp.bad:
                s = self._release_slot(mid)
                if s >= 0:
                    changed.append(s)
                continue
            live_ids.append(mid)
            live_slots.append(self._ensure_slot(mid))
        if live_ids:
            ga = np.asarray(live_ids, np.int64)
            sl = np.asarray(live_slots, np.int64)
            self.pos[sl] = m.mp_pos[ga]
            self.normal[sl] = m.mp_normal[ga]
            self.mind[sl] = m.mp_mind[ga]
            self.maxd[sl] = m.mp_maxd[ga]
            self.desc[sl] = m.mp_desc[ga]
            self.valid[sl] = True
            changed.extend(live_slots)

        if self.dev is None:
            # full upload with the scratch row appended
            self.dev = tuple(self._to_dev(a) for a in (
                np.vstack([self.pos, np.zeros((1, 3), np.float32)]),
                np.vstack([self.normal, np.zeros((1, 3), np.float32)]),
                np.append(self.mind, 0.0).astype(np.float32),
                np.append(self.maxd, 0.0).astype(np.float32),
                np.vstack([self.desc, np.zeros((1, 32), np.uint8)]),
                np.append(self.valid, False)))
            return
        if not changed:
            return
        idx = np.asarray(changed, np.int64)
        D = bucket(len(idx), 64)
        idx = np.concatenate([idx, np.full(D - len(idx), self.cap, np.int64)])  # scratch row
        rows = idx.clip(0, self.cap - 1)
        valid = self.valid[rows]
        valid[len(changed):] = False
        _pool_scatter(self.dev, self._to_dev(idx), *(self._to_dev(a) for a in (
            self.pos[rows], self.normal[rows], self.mind[rows], self.maxd[rows],
            self.desc[rows], valid)))

    # ---------------------------------------------------------------- access

    def gather(self, slots_padded: np.ndarray):
        """Pool rows of the given slots (pad with self.cap for never-valid
        scratch rows): (pos, normal, mind, maxd, desc, valid) on the device."""
        return _pool_gather(*self.dev, self._to_dev(slots_padded.astype(np.int64)))

    def gather_fills(self, slots_padded: np.ndarray):
        """The rows of `gather` as six `graphs.Fill` arguments of a captured
        program: each gathers its rows (`index_select(..., out=)`) into the
        program's static buffer before the replay."""
        idx = self._to_dev(slots_padded.astype(np.int64))
        return tuple(graphs.gathered(src, idx) for src in self.dev)

    def slots_for_ids(self, ids: np.ndarray) -> np.ndarray:
        """Vectorised id -> slot lookup (-1 for unknown/dead)."""
        ids = np.asarray(ids, np.int64)
        out = np.full(len(ids), -1, np.int32)
        ok = (ids >= 0) & (ids < len(self.slot_of))
        out[ok] = self.slot_of[ids[ok]]
        return out

    def row_map(self, slots: np.ndarray) -> np.ndarray:
        """Scratch slot -> row map of the current frame's local block (valid
        until the next call)."""
        r = self._row_of_slot
        r[:] = -1
        r[slots] = np.arange(len(slots), dtype=np.int32)
        return r
