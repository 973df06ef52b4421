"""LocalMapping: map building around new keyframes (reference
src/LocalMapping.cc).

Port of `ceres_mono_orb_slam2_tpu/models/localmapping.py`: process new
keyframe -> cull recent map points -> triangulate new
points against covisible keyframes -> fuse duplicates -> local bundle
adjustment -> cull redundant keyframes -> hand the keyframe to the loop
closer. Epipolar search, triangulation, fuse
and local BA run on the device; graph bookkeeping stays on the host.

It runs after each frame (serial `MonoSLAM`) or on the facade's mapper
thread (`MonoSLAM(threaded=True)`), either way on the mapper stream
(`utils/graphs.owner_stream`), so that its host reads (one `graphs.fetch`
a stage) wait for its own device work and not for the tracker's frame on
the default stream; a keyframe's device payload, written on the default
stream, is handed over with an event (`KeyFrame.dev_payload`). Either way
each stage takes
`map.update_lock` for itself, and triangulation, fuse and local BA release
it around their device solve: prep under the lock, solve without it, apply
under the lock behind staleness guards (a reset bumps `map_epoch`, a cull
marks a keyframe bad, a fuse kills a point). Serially the guards never fire,
so both modes run the same arithmetic.

With `graphs=True` (the default) each LM iteration of the local BA replays
a captured program (`utils/graphs.py`, owner "mapper"), the JAX package's
jitted scan: one program per window shape and pass, replayed for every
further iteration of the solve and by the second BA call. `graphs=False`
runs the same function op by op. The triangulation and the fuse run batched
and eager, one call over all neighbours or targets (the JAX package's vmap):
the fuse's map-point block changes with every keyframe, so a capture would
not replay, and a captured triangulation either captures a program per
neighbour count or pads the block to TRI_BATCH rows, which did more work
than the eager call saves in launches.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.map import KeyFrame, Map
from ceres_mono_orb_slam2_tpu_torch.models.optimization import DENSE_BA_MAX_BLOCKS
from ceres_mono_orb_slam2_tpu_torch.ops import mapping_batch, optim
from ceres_mono_orb_slam2_tpu_torch.utils import graphs as graphs_mod
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class LocalMapping:
    # covisible window of CreateNewMapPoints (reference LocalMapping.cc:202)
    TRI_BATCH = 20
    # local-BA programs kept per pass: a window's shape rarely recurs after
    # the solve that made it
    BA_PROGRAMS = 4

    def __init__(self, config, map_: Map, loop_closer=None, device=DEFAULT_DEVICE,
                 graphs: bool = True):
        self.config = config
        self.map = map_
        self.loop_closer = loop_closer
        self.device = resolve_device(device)
        self.scale_factors = config.orb.scale_factors
        self.level_sigma2 = config.orb.level_sigma2
        self.inv_sigma2 = config.orb.inv_level_sigma2
        self.n_levels = config.orb.n_levels
        self.log_scale = float(np.log(config.orb.scale_factor))
        K = config.camera.K.astype(np.float32)
        with graphs_mod.on_owner_stream(self.device, "mapper"):
            self.jK = self._dev(K)
            self.j_invK = self._dev(np.linalg.inv(K.astype(np.float64)).astype(np.float32))
            self.j_ls2 = self._dev(self.level_sigma2.astype(np.float32))
            self.j_sfs = self._dev(self.scale_factors.astype(np.float32))
            self.j_is2 = self._dev(self.inv_sigma2.astype(np.float32))
        self.ratio_factor = 1.5 * float(config.orb.scale_factor)
        self.queue: List[int] = []
        self.recent_points: List[int] = []
        self.abort_ba = False
        self._accepting = True
        self.n_local_ba = 0
        self.n_ba_aborted = 0  # local BAs whose second half a new keyframe skipped
        self.pass_ms: List[dict] = []  # per pass: wall ms of each stage
        # the local BA's LM iterations: captured programs, or the same
        # functions eagerly
        self.graphs = bool(graphs)
        self._lm_robust = self._program(optim.lm_iteration_robust, "lba_lm_robust", self.BA_PROGRAMS)
        self._lm_trimmed = self._program(optim.lm_iteration_trimmed, "lba_lm_trimmed", self.BA_PROGRAMS)
        self._lm_cg = self._program(optim.cg_lm_iteration, "lba_lm_cg", self.BA_PROGRAMS)

    def _dev(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _program(self, fn, name: str, keep: int):
        if not self.graphs:
            return fn
        return graphs_mod.CapturedFunction(fn, self.device, name=name, owner="mapper",
                                           max_programs=keep)

    def captured(self) -> list:
        """The `CapturedFunction`s of local mapping (none without graphs)."""
        fns = (self._lm_robust, self._lm_trimmed, self._lm_cg)
        return [f for f in fns if isinstance(f, graphs_mod.CapturedFunction)]

    def programs(self) -> list:
        """`CapturedFunction.report()` of local mapping's programs."""
        return [r for f in self.captured() for r in f.report()]

    # ------------------------------------------------------------- interface

    def insert_keyframe(self, kf_id: int):
        self.queue.append(kf_id)
        self.abort_ba = True

    def accepting(self) -> bool:
        return self._accepting

    def interrupt_ba(self):
        self.abort_ba = True

    def reset(self):
        self.queue.clear()
        self.recent_points.clear()

    def process_queue(self):
        """Drain the keyframe queue on the mapper stream. Keyframe acceptance
        is off while a pass runs (AcceptKeyFrames(false), reference
        LocalMapping.cc:37-60)."""
        self._accepting = False
        try:
            with graphs_mod.on_owner_stream(self.device, "mapper"):
                while True:
                    with self.map.update_lock:  # a reset may clear the queue meanwhile
                        if not self.queue:
                            break
                        kf = self.map.keyframes.get(self.queue.pop(0))
                    if kf is None or kf.bad:
                        continue
                    self._process(kf)
        finally:
            self._accepting = True

    # ------------------------------------------------------------- pipeline

    def _process(self, kf: KeyFrame):
        """One mapping pass (reference LocalMapping::Run, :37-104). Between
        stages the tracker may track frames and insert a keyframe; the
        `self.queue` checks then skip the tail stages, like the reference's
        CheckNewKeyFrames exits (:84-88). `pass_ms` records each stage's
        wall ms."""
        tm = {"kf": kf.id}
        t0 = time.perf_counter()

        def mark(name):
            nonlocal t0
            t = time.perf_counter()
            tm[name] = (t - t0) * 1e3
            t0 = t

        with self.map.update_lock:
            if kf.bad or self.map.keyframes.get(kf.id) is not kf:  # a reset since the pop
                return
            epoch = self.map.map_epoch
            self._process_new_keyframe(kf)
            mark("process_new")
            self._map_point_culling(kf)
            mark("cull_mp")
        if self._pass_stale(kf, epoch):
            return
        self._create_new_map_points(kf, epoch)
        mark("triangulate")
        if self._pass_stale(kf, epoch):
            return
        if not self.queue:
            self._search_in_neighbors(kf, epoch)
        mark("fuse")
        self.abort_ba = False
        if self._pass_stale(kf, epoch):
            return
        if not self.queue and self.map.n_keyframes() > 2:
            self._local_bundle_adjustment(kf, epoch)
            mark("lba")
            if self._pass_stale(kf, epoch):
                return
            with self.map.update_lock:
                if not self._pass_stale_locked(kf, epoch):
                    self._keyframe_culling(kf)
            mark("cull_kf")
        self.pass_ms.append(tm)
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(kf.id)

    def _pass_stale_locked(self, kf: KeyFrame, epoch: int) -> bool:
        """True if a reset (`map_epoch` moved) or a cull invalidated this
        mapping pass; the caller holds map.update_lock."""
        return self.map.map_epoch != epoch or kf.bad or kf.id not in self.map.keyframes

    def _pass_stale(self, kf: KeyFrame, epoch: int) -> bool:
        with self.map.update_lock:
            return self._pass_stale_locked(kf, epoch)

    def _process_new_keyframe(self, kf: KeyFrame):
        """Reference ProcessNewKeyFrame (LocalMapping.cc:129-165)."""
        m = self.map
        touched = []
        for i in np.nonzero(kf.mp_ids >= 0)[0]:
            mp = m.get_mp(int(kf.mp_ids[i]))
            if mp is None:
                kf.mp_ids[i] = -1
                continue
            if kf.id not in mp.observations:
                m.add_observation(mp, kf, int(i))
                touched.append(mp.id)
        m.refresh_points(touched, self.scale_factors)
        m.update_connections(kf)

    def _map_point_culling(self, kf: KeyFrame):
        """Reference MapPointCulling (LocalMapping.cc:167-194)."""
        m = self.map
        survivors = []
        for mid in self.recent_points:
            mp = m.map_points.get(mid)
            if mp is None or mp.bad:
                continue
            if mp.found_ratio() < 0.25:
                m.set_bad_map_point(mp)
            elif kf.id - mp.first_kf_id >= 2 and mp.n_obs <= 2:
                m.set_bad_map_point(mp)
            elif kf.id - mp.first_kf_id >= 3:
                pass  # graduated
            else:
                survivors.append(mid)
        self.recent_points = survivors

    def _median_depth(self, kf: KeyFrame) -> float:
        """Reference ComputeSceneMedianDepth (KeyFrame.cc:555-581)."""
        m = self.map
        ids = kf.mp_ids[kf.mp_ids >= 0]
        ids = ids[m.mp_alive[ids]]
        if len(ids) == 0:
            return -1.0
        return float(np.median(m.mp_pos[ids] @ kf.Rcw[2] + kf.tcw[2]))

    def _create_new_map_points(self, kf: KeyFrame, epoch: int):
        """Reference CreateNewMapPoints (LocalMapping.cc:196-396): epipolar
        search + triangulation against the top-20 covisible keyframes that
        pass the baseline / median-depth gate."""
        m = self.map
        with m.update_lock:  # prep: neighbour gates and input blocks
            if self._pass_stale_locked(kf, epoch):
                return
            O1 = kf.camera_center()
            nb_kfs = []
            for nb_id in kf.best_covisible(20):
                kf2 = m.keyframes.get(nb_id)
                if kf2 is None or kf2.bad:
                    continue
                baseline = float(np.linalg.norm(kf2.camera_center() - O1))
                med_depth = self._median_depth(kf2)
                if med_depth <= 0 or baseline / med_depth < 0.01:
                    continue
                nb_kfs.append(kf2)
            if not nb_kfs:
                return
            nb_kfs = nb_kfs[: self.TRI_BATCH]
            cur = kf.dev_payload(self.device)
            nb = [k.dev_payload(self.device) for k in nb_kfs]
            host = (kf.Rcw, kf.tcw, (kf.mp_ids < 0) & kf.kp_valid,
                    np.stack([k.Rcw for k in nb_kfs]), np.stack([k.tcw for k in nb_kfs]),
                    np.stack([(k.mp_ids < 0) & k.kp_valid for k in nb_kfs]))

        # device solve without the lock
        R1, t1, free1, R2, t2, free2 = (self._dev(a) for a in host)
        stack = lambda i: torch.stack([d[i] for d in nb])  # noqa: E731
        idx, good, X = mapping_batch.triangulate_with_neighbors(
            self.jK, self.j_invK, R1, t1, cur[0], cur[1], cur[2], cur[3], free1, R2, t2,
            stack(0), stack(1), stack(2), stack(3), free2,
            self.j_ls2, self.j_sfs, self.ratio_factor)
        idx, good, X = graphs_mod.fetch(idx, good, X)

        # apply: host creation in neighbour order; the first neighbour to
        # triangulate a keypoint slot wins (the reference's sequential loop).
        # The mp_ids guards re-check what changed while the lock was free.
        with m.update_lock:
            if m.map_epoch != epoch:
                return
            created = []
            for b, kf2 in enumerate(nb_kfs):
                if kf2.bad or kf.bad:
                    continue
                for k in np.nonzero(good[b])[0]:
                    ia, ib = int(k), int(idx[b, k])
                    if kf.mp_ids[ia] >= 0 or kf2.mp_ids[ib] >= 0:
                        continue
                    mp = m.new_map_point(X[b, k].astype(np.float32), kf.desc[ia], kf.id)
                    mp.first_kf_id = kf.id
                    m.add_observation(mp, kf, ia)
                    m.add_observation(mp, kf2, ib)
                    created.append(mp.id)
                    self.recent_points.append(mp.id)
            m.refresh_points(created, self.scale_factors)

    # forward-fuse target chunk (20 first-order + up to 12 second-order)
    FUSE_BATCH = 32

    def _search_in_neighbors(self, kf: KeyFrame, epoch: int):
        """Reference SearchInNeighbors (LocalMapping.cc:398-488): fuse the
        current keyframe's points into its 1st+2nd-order neighbours (all
        targets against one map snapshot) and theirs back into it."""
        m = self.map
        with m.update_lock:
            if self._pass_stale_locked(kf, epoch):
                return
            targets = []
            seen = {kf.id}
            for nb in kf.best_covisible(20):
                if nb not in seen:
                    seen.add(nb)
                    nkf = m.keyframes.get(nb)
                    if nkf is None or nkf.bad:
                        continue
                    targets.append(nkf)
                    for nb2 in nkf.best_covisible(5):
                        if nb2 not in seen:
                            seen.add(nb2)
                            nkf2 = m.keyframes.get(nb2)
                            if nkf2 is not None and not nkf2.bad:
                                targets.append(nkf2)
            cur_mps = [m.resolve(int(mid)) for mid in kf.mp_ids if mid >= 0]
            cur_mps = sorted({mid for mid in cur_mps if mid >= 0})
        if targets and cur_mps:
            for c0 in range(0, len(targets), self.FUSE_BATCH):
                self._fuse_forward_batch(targets[c0:c0 + self.FUSE_BATCH], cur_mps)
        # reverse fuse: all target map points into the current keyframe
        with m.update_lock:
            if self._pass_stale_locked(kf, epoch):
                return
            fuse_ids = []
            fs = set()
            for tkf in targets:
                for mid in tkf.mp_ids:
                    if mid >= 0 and mid not in fs:
                        fuse_ids.append(int(mid))
                        fs.add(mid)
        self._fuse_into(kf, fuse_ids)
        with m.update_lock:
            if self._pass_stale_locked(kf, epoch):
                return
            m.refresh_points([int(mid) for mid in kf.mp_ids[kf.mp_ids >= 0]], self.scale_factors)
            m.update_connections(kf)

    def _point_block(self, mp_ids):
        """(pos, normal, min dist, max dist, descriptor) rows of the given
        map points, gathered on the host (call under map.update_lock)."""
        ga = np.asarray(mp_ids, np.int64)
        m = self.map
        return m.mp_pos[ga], m.mp_normal[ga], m.mp_mind[ga], m.mp_maxd[ga], m.mp_desc[ga]

    def _merge(self, tkf: KeyFrame, mp_id: int, kp: int, touched: list):
        """ORBmatcher::Fuse tail (ORBmatcher.cc:806-840): bind, or replace the
        point with fewer observations by the other."""
        m = self.map
        mid = m.resolve(mp_id)
        mp = m.map_points.get(mid) if mid >= 0 else None
        if mp is None or mp.bad or tkf.id in mp.observations:
            return
        existing_id = m.resolve(int(tkf.mp_ids[kp]))
        if existing_id >= 0:
            existing = m.map_points[existing_id]
            if existing.id == mp.id:
                return
            if existing.n_obs > mp.n_obs:
                m.replace_map_point(mp, existing, refresh=False)
                touched.append(existing.id)
            else:
                m.replace_map_point(existing, mp, refresh=False)
                touched.append(mp.id)
        else:
            m.add_observation(mp, tkf, kp)

    def _fuse_forward_batch(self, targets: List[KeyFrame], mp_ids: List[int], th: float = 3.0):
        """Forward half of SearchInNeighbors: one shared map-point block
        projected into every target keyframe; the merge stays on the host."""
        m = self.map
        with m.update_lock:  # prep: gates, poses and the point block
            epoch = m.map_epoch
            mp_arr = np.asarray(mp_ids, np.int64)
            mvalid = np.stack([~np.isin(mp_arr, t.mp_ids[t.mp_ids >= 0]) for t in targets])
            tgt = [t.dev_payload(self.device) for t in targets]
            host = (np.stack([t.Rcw for t in targets]), np.stack([t.tcw for t in targets]),
                    *self._point_block(mp_ids), mvalid)
            bounds = m.image_bounds

        # device solve without the lock
        R, t, pos, normal, mind, maxd, desc, mvalid = (self._dev(a) for a in host)
        idx, valid = mapping_batch.fuse_into_targets(
            self.jK, R, t,
            torch.stack([d[0] for d in tgt]), torch.stack([d[1] for d in tgt]),
            torch.stack([d[3] for d in tgt]), torch.stack([d[4] for d in tgt]),
            pos, normal, mind, maxd, desc, mvalid, self.log_scale, self.n_levels,
            self.j_sfs, self.j_is2, bounds=None if bounds is None else self._dev(bounds), th=th)
        idx, valid = graphs_mod.fetch(idx, valid)

        # apply: `_merge` re-resolves and re-checks every id
        with m.update_lock:
            if m.map_epoch != epoch:
                return
            touched = []
            for b, tkf in enumerate(targets):
                if tkf.bad:
                    continue
                for q in np.nonzero(valid[b])[0]:
                    self._merge(tkf, mp_ids[q], int(idx[b, q]), touched)
            if touched:
                m.refresh_points(touched, self.scale_factors)

    def _fuse_into(self, kf: KeyFrame, mp_ids: List[int], th: float = 3.0):
        """Reverse fuse into the current keyframe (ORBmatcher::Fuse), without
        an image-bounds gate: the search window implies the projection lands
        near a real keypoint."""
        m = self.map
        with m.update_lock:  # prep
            epoch = m.map_epoch
            mp_ids = [m.resolve(mid) for mid in mp_ids]
            mp_ids = [mid for mid in mp_ids if mid >= 0 and kf.id not in m.map_points[mid].observations]
            if not mp_ids:
                return
            host = (kf.Rcw, kf.tcw, *self._point_block(mp_ids))
            kp_und, kp_oct, _, kp_desc, kp_valid = kf.dev_payload(self.device)

        # device solve without the lock: the one-target call of the forward fuse
        Rcw, tcw, pos, normal, mind, maxd, desc = (self._dev(a) for a in host)
        idx, valid = mapping_batch.fuse_into_targets(
            self.jK, Rcw[None], tcw[None], kp_und[None], kp_oct[None], kp_desc[None],
            kp_valid[None], pos, normal, mind, maxd, desc,
            torch.ones((1, len(mp_ids)), dtype=torch.bool, device=self.device),
            self.log_scale, self.n_levels, self.j_sfs, self.j_is2, th=th)
        ii, vi = graphs_mod.fetch(idx[0], valid[0])

        with m.update_lock:  # apply
            if m.map_epoch != epoch or kf.bad:
                return
            touched = []
            for q in np.nonzero(vi)[0]:
                self._merge(kf, mp_ids[q], int(ii[q]), touched)
            if touched:
                m.refresh_points(touched, self.scale_factors)

    # -------------------------------------------------------------- local BA

    def _local_bundle_adjustment(self, kf: KeyFrame, epoch: int):
        """Reference LocalBundleAdjustment (CeresOptimizer.cc:344-599): the
        current KF + covisibles are free, keyframes that see local points but
        are not covisible are fixed; a two-pass robust -> trimmed solve whose
        second half is skipped when a new keyframe interrupted it
        (`n_ba_aborted` counts those); outlier observations are erased
        afterwards. The solve runs without map.update_lock, as the
        reference's holds no map mutex during the Ceres solve."""
        m = self.map
        with m.update_lock:
            prep = None if self._pass_stale_locked(kf, epoch) else self._lba_build(kf)
        if prep is None:
            return
        kf_ids, kf_slot, mp_ids, oj_all, op_all, fixed, R, t, pts, ouv, ow = prep
        P, M = len(kf_ids), len(mp_ids)
        d = self._dev
        args = (d(op_all.astype(np.int64)), d(oj_all.astype(np.int64)), d(ouv), d(ow),
                torch.ones(len(op_all), dtype=torch.bool, device=self.device), d(fixed),
                torch.ones(M, dtype=torch.bool, device=self.device))
        if P * M > DENSE_BA_MAX_BLOCKS:
            # past the dense Schur's (M, P, 6, 3) budget the matrix-free CG
            # solver takes over (as in the JAX package), so a large window in
            # a densely covisible revisited area cannot exhaust memory; each
            # LM iteration a replay of the window's program, in both calls
            res = optim.bundle_adjustment_cg(self.jK, d(R), d(t), d(pts), *args, iters=8,
                                             step=self._lm_cg)
            if not self.abort_ba:
                res = optim.bundle_adjustment_cg(self.jK, res.R, res.t, res.points, *args,
                                                 iters=7, step=self._lm_cg)
            else:
                self.n_ba_aborted += 1
        else:
            # each LM iteration a replay of the program of this window's
            # shape; the second call replays the trimmed program of the first
            steps = dict(robust_step=self._lm_robust, trimmed_step=self._lm_trimmed)
            res = optim.bundle_adjustment(self.jK, d(R), d(t), d(pts), *args,
                                          iters_huber=5, iters_trimmed=5, **steps)
            if not self.abort_ba:
                res = optim.bundle_adjustment(self.jK, res.R, res.t, res.points, *args,
                                              iters_huber=0, iters_trimmed=5, **steps)
            else:
                self.n_ba_aborted += 1
        self.n_local_ba += 1
        Rn, tn, ptsn, inl = graphs_mod.fetch(res.R, res.t, res.points, res.inlier_obs)
        with m.update_lock:  # apply, re-validating everything it writes
            if m.map_epoch != epoch:
                return
            for k, i in kf_slot.items():
                okf = m.keyframes.get(k)
                if okf is not None and not okf.bad and not fixed[i]:
                    okf.Rcw = Rn[i]
                    okf.tcw = tn[i]
            live_ids = []
            for i, mid in enumerate(mp_ids):
                mp = m.map_points.get(mid)
                if mp is not None and not mp.bad:
                    mp.pos = ptsn[i]
                    live_ids.append(mid)
            m.refresh_points(live_ids, self.scale_factors, descriptors=False)
            # erase outlier observations (CeresOptimizer.cc:573-581)
            for q in np.nonzero(~inl)[0]:
                mp = m.map_points.get(mp_ids[oj_all[q]])
                if mp is not None and not mp.bad:
                    m.erase_observation(mp, kf_ids[op_all[q]])

    def _lba_build(self, kf: KeyFrame):
        """Local-BA window and observation arrays, or None when degenerate
        (call under map.update_lock)."""
        m = self.map
        # free window: current KF + covisibles, capped at max_local_keyframes
        n_free = max(1, self.config.shapes.max_local_keyframes - 1)
        local_ids = [kf.id] + kf.best_covisible(min(len(kf.ordered_neighbors), n_free))
        local_ids = [k for k in local_ids if k in m.keyframes and not m.keyframes[k].bad]
        local_set = set(local_ids)
        cat = np.concatenate([m.keyframes[k].mp_ids for k in local_ids])
        uniq = np.unique(cat[cat >= 0])
        mp_ids = [int(mid) for mid in uniq if m.get_mp(int(mid)) is not None]
        if not mp_ids:
            return None
        mp_arr = np.asarray(mp_ids, np.int64)  # ascending

        fixed_ids = []
        fixed_set = set()
        for mid in mp_ids:
            for ok_id in m.map_points[mid].observations:
                if ok_id not in local_set and ok_id not in fixed_set:
                    okf = m.keyframes.get(ok_id)
                    if okf is not None and not okf.bad:
                        fixed_ids.append(ok_id)
                        fixed_set.add(ok_id)
        # cap the fixed set: keep the observers with the most window points
        max_fixed = 4 * self.config.shapes.max_local_keyframes - len(local_ids)
        if len(fixed_ids) > max_fixed > 0:
            counts = [int(np.isin(m.keyframes[k].mp_ids, mp_arr).sum()) for k in fixed_ids]
            order = np.argsort(counts)[::-1][:max_fixed]
            fixed_ids = [fixed_ids[i] for i in sorted(order)]

        kf_ids = local_ids + fixed_ids
        kf_slot = {k: i for i, k in enumerate(kf_ids)}
        op_l, oj_l, uv_l, ow_l = [], [], [], []
        for i_k, k in enumerate(kf_ids):
            okf = m.keyframes[k]
            kidx = np.nonzero(okf.mp_ids >= 0)[0]
            ids = okf.mp_ids[kidx]
            pos = np.minimum(np.searchsorted(mp_arr, ids), len(mp_arr) - 1)
            hit = mp_arr[pos] == ids  # fixed KFs keep only window points
            kidx = kidx[hit]
            op_l.append(np.full(len(kidx), i_k, np.int32))
            oj_l.append(pos[hit].astype(np.int32))
            uv_l.append(okf.kp_und[kidx])
            ow_l.append(self.inv_sigma2[okf.kp_octave[kidx]].astype(np.float32))
        op_all = np.concatenate(op_l)
        oj_all = np.concatenate(oj_l)
        if len(op_all) < 10:
            return None
        R = np.stack([m.keyframes[k].Rcw for k in kf_ids]).astype(np.float32)
        t = np.stack([m.keyframes[k].tcw for k in kf_ids]).astype(np.float32)
        fixed = np.array([k in fixed_set or k == 0 for k in kf_ids])
        pts = m.mp_pos[mp_arr].astype(np.float32)
        return (kf_ids, kf_slot, mp_ids, oj_all, op_all, fixed, R, t, pts,
                np.concatenate(uv_l).astype(np.float32), np.concatenate(ow_l))

    # -------------------------------------------------------------- KF culling

    def _keyframe_culling(self, kf: KeyFrame):
        """Reference KeyFrameCulling (LocalMapping.cc:576-637): a local KF is
        redundant if >= 90% of its map points are seen by >= 3 other
        keyframes at the same or finer scale."""
        m = self.map
        table = None
        for k_id in kf.best_covisible(len(kf.ordered_neighbors)):
            okf = m.keyframes.get(k_id)
            if okf is None or okf.bad or okf.id == 0:
                continue
            if table is None:
                table = m._obs_arrays()
            n_mps, n_redundant = self._redundancy(okf, table)
            if n_mps > 0 and n_redundant > 0.9 * n_mps:
                m.erase_keyframe(okf)
                table = None  # erases change later candidates' counts

    def _redundancy(self, okf: KeyFrame, table) -> tuple:
        """(bound live points, points seen by >= 3 other KFs at octave <=
        level + 1) of one cull candidate, over the global observation table."""
        m = self.map
        mid_s, kfid_s, oct_s = table
        rows = np.nonzero(okf.mp_ids >= 0)[0]
        ids = okf.mp_ids[rows]
        alive = m.mp_alive[ids]
        rows, ids = rows[alive], ids[alive]
        n_mps = len(ids)
        eligible = np.nonzero(m.mp_nobs[ids] > 3)[0]
        if n_mps == 0 or len(eligible) == 0:
            return n_mps, 0
        eids = ids[eligible]
        levels = okf.kp_octave[rows[eligible]].astype(np.int32)
        lo = np.searchsorted(mid_s, eids, "left")
        cnt = np.searchsorted(mid_s, eids, "right") - lo
        total = int(cnt.sum())
        tix = np.repeat(lo, cnt) + (np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        prow = np.repeat(np.arange(len(eids)), cnt)
        good = (kfid_s[tix] != okf.id) & (oct_s[tix] <= np.repeat(levels, cnt) + 1)
        n_better = np.bincount(prow[good], minlength=len(eids))
        return n_mps, int((n_better >= 3).sum())
