"""LoopClosing: place recognition, Sim3 verification, loop correction.

Port of `ceres_mono_orb_slam2_tpu/models/loopclosing.py`, the equivalent of
the reference LoopClosing (src/LoopClosing.cc):
- DetectLoop (:106-228): BoW candidates gated by the minimum covisible score,
  then consistency groups over >=3 consecutive detections,
- ComputeSim3 (:230-399): descriptor matching -> Horn sim3 RANSAC ->
  optimize_sim3 -> projection search through the Sim3, accept at >=40 total matches,
- CorrectLoop (:401-597): propagate the corrective Sim3 to the current
  keyframe's covisible group and their map points, fuse loop duplicates,
  sim3 essential-graph optimization (device PCG), then full-map BA.

The reference runs this on its own thread and spawns a further GBA thread.
Here it is a pipeline stage driven by the System facade: after each frame
(serial), or on the facade's mapper thread (`MonoSLAM(threaded=True)`), where
`threaded_gba=True` also runs each global BA on a thread of its own named
`gba`, which a later loop aborts (`stop_gba`, `full_ba_index`) and joins
before it corrects. Matching, RANSAC and the optimizers run on the device at
the actual problem sizes, on the mapper stream (`utils/graphs.py`) on every
thread, each stage's results read back with one `graphs.fetch`; the Sim(3)
RANSAC draws come from `uniform_noise`, which tests replace to inject
draws. With `graphs=True` (the default) each
LM iteration of the Sim(3) refinement, each GN iteration of the essential
graph and each LM iteration of the global BA (dense or CG) replay a captured
program (`utils/graphs.py`), the JAX package's jitted solves; `graphs=False`
runs them op by op. Every refinement of a process pads its matches to one
row count, the current keyframe's keypoint capacity, so all of them share
one program. The Sim(3) RANSAC runs op by op at the live match count (the
JAX package does not jit it either).
"""

from __future__ import annotations

import logging
import threading
from functools import partial
from typing import Dict, List, Optional

import time

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.map import Map, KeyFrame
from ceres_mono_orb_slam2_tpu_torch.models.optimization import run_global_ba
from ceres_mono_orb_slam2_tpu_torch.ops import bow, matcher, optim, sim3opt, sim3solver
from ceres_mono_orb_slam2_tpu_torch.utils import graphs as graphs_mod
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from ceres_mono_orb_slam2_tpu_torch.utils.padding import pad_rows

log = logging.getLogger(__name__)

COVIS_CONSISTENCY_TH = 3  # reference mnCovisibilityConsistencyTh
SIM3_HYPOTHESES = 256
MIN_EDGE_WEIGHT = 100  # essential-graph covisibility edge gate (CeresOptimizer.cc:753)
EG_GN_ITERS, EG_CG_ITERS = 30, 100  # the essential graph's GN and PCG iterations


def lie_sim3_inv_np(R, t, s):
    """Inverse of a similarity (R, t, s): x -> s R x + t."""
    Ri = np.asarray(R).T
    si = 1.0 / float(s)
    ti = -si * (Ri @ np.asarray(t))
    return Ri, ti, si


class LoopClosing:
    def __init__(self, config, map_: Map, keyframe_db, local_mapper=None, fix_scale: bool = False,
                 threaded_gba: bool = False, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None, graphs: bool = True):
        self.config = config
        self.device = resolve_device(device)
        self.map = map_
        self.db = keyframe_db
        self.local_mapper = local_mapper
        self.fix_scale = fix_scale  # mono: scale is free (reference bFixScale=false)
        self.queue: List[int] = []
        self.last_loop_kf_id = 0
        self.consistent_groups: List[tuple] = []  # (set_of_kf_ids, consistency)
        self.n_loops_closed = 0
        self.n_gba_runs = 0  # completed (non-aborted) global BA solves
        self.n_detects = 0  # _detect_loop calls past the 10-KF guard
        self.n_candidate_events = 0  # detections with >=1 gate-passing cand
        # Sim(3) RANSAC noise; `uniform_noise(shape)` may be replaced
        self.generator = generator or torch.Generator(device=self.device).manual_seed(42)
        self.uniform_noise = self._draw_uniform
        with graphs_mod.on_owner_stream(self.device, "mapper"):
            self.jK = self._dev(np.asarray(config.camera.K, np.float32))
            self.j_sfs = self._dev(config.orb.scale_factors.astype(np.float32))
        self.inv_sigma2 = config.orb.inv_level_sigma2
        self.gba_force_cg = False  # True: the matrix-free global BA at any map size
        self.threaded_gba = threaded_gba
        self.gba_thread: Optional[threading.Thread] = None
        self.stop_gba = False
        self.full_ba_index = 0  # bumps when a running global BA is aborted
        self.gba_error: Optional[Exception] = None  # what ended a `gba` thread, for the facade
        # per closed loop: stage milliseconds and problem sizes
        self.loop_stats: List[dict] = []
        self._sim3_ms = self._eg_solve_ms = 0.0
        # captured programs (utils/graphs.py, owner "mapper"), or the same
        # functions eagerly: the Sim(3) refinement's LM iteration at its one
        # padded row count; the essential graph's GN iteration (its PCG
        # included) per (P, E), replayed for every iteration of the solve;
        # the global BA's LM iterations (dense or CG) per map shape, replayed
        # by every chunk
        self._sim3_step = self._eg_step = None
        self._gba_steps = {}
        if graphs:
            self._sim3_step = graphs_mod.CapturedFunction(
                sim3opt.sim3_lm_iteration, self.device, name="sim3_lm", owner="mapper", max_programs=1)
            self._eg_step = graphs_mod.CapturedFunction(
                partial(sim3opt.gn_iteration, cg_iters=EG_CG_ITERS), self.device,
                name="essential_graph_gn", owner="mapper", max_programs=2)
            self._gba_steps = {
                f"{kind}_step": graphs_mod.CapturedFunction(
                    fn, self.device, name=f"gba_lm_{kind}", owner="mapper", max_programs=1)
                for kind, fn in (("robust", optim.lm_iteration_robust),
                                 ("trimmed", optim.lm_iteration_trimmed),
                                 ("cg", optim.cg_lm_iteration))}

    def captured(self) -> list:
        """The `CapturedFunction`s of loop closing (none without graphs)."""
        return [f for f in (self._sim3_step, self._eg_step) if f is not None] + list(
            self._gba_steps.values())

    def programs(self) -> list:
        """`CapturedFunction.report()` of loop closing's programs."""
        return [r for f in self.captured() for r in f.report()]

    def _dev(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _draw_uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    # -------------------------------------------------------------- interface

    def insert_keyframe(self, kf_id: int):
        self.queue.append(kf_id)

    def process_queue(self):
        """Run detection, Sim(3) and correction for every queued keyframe,
        on the mapper stream."""
        with graphs_mod.on_owner_stream(self.device, "mapper"):
            self._drain()

    def _drain(self):
        m = self.map
        while True:
            with m.update_lock:  # a reset may clear the queue meanwhile
                if not self.queue:
                    break
                kf = m.keyframes.get(self.queue.pop(0))
            if kf is None or kf.bad:
                continue
            # SetNotErase protocol (reference LoopClosing.cc:113): the current
            # keyframe is protected from KeyFrameCulling for the whole
            # detect -> sim3 -> correct window; candidates are protected in
            # _compute_sim3 (cc:255) and released as they fail (cc:347-394).
            # Detection + sim3 run under the map update lock so they read a
            # consistent keyframe/map-point snapshot while the tracker (in
            # threaded mode) mutates under the same lock; _correct_loop is
            # called OUTSIDE it — it drains mapping and joins the GBA thread
            # first, and takes the lock itself around the map mutation.
            m.set_not_erase(kf)
            with m.update_lock:
                candidates = self._detect_loop(kf)
                if candidates:
                    t0 = time.perf_counter()
                    ok, match_kf_id, Scw, lp = self._compute_sim3(kf, candidates)
                    self._sim3_ms = (time.perf_counter() - t0) * 1e3
                else:
                    ok = False
            if not candidates:
                m.set_erase(kf)
                continue
            if ok:
                log.info("Loop detected! kf %d <-> kf %d", kf.id, match_kf_id)
                loop_points, loop_mp_ids = lp
                self._correct_loop(kf, match_kf_id, Scw, loop_points, loop_mp_ids)
                mkf = m.keyframes.get(match_kf_id)
                if mkf is not None:
                    m.set_erase(mkf)
            m.set_erase(kf)

    def reset(self):
        self.queue.clear()
        self.consistent_groups.clear()
        self.last_loop_kf_id = 0

    # ----------------------------------------------------------- detect loop

    def _detect_loop(self, kf: KeyFrame) -> List[int]:
        """Reference DetectLoop (LoopClosing.cc:106-228)."""
        m = self.map
        if kf.id < self.last_loop_kf_id + 10 or m.n_keyframes() < 10:
            self.db.add(kf)
            return []
        # min score among covisible keyframes (:124-139)
        v = self.db.kf_bow(kf)
        min_score = 1.0
        for nb in kf.covisible:
            okf = m.keyframes.get(nb)
            if okf is not None and not okf.bad:
                min_score = min(min_score, bow.l1_score(v, self.db.kf_bow(okf)))
        candidates = self.db.detect_loop_candidates(kf, min_score)
        self.n_detects += 1
        if candidates:
            self.n_candidate_events += 1
        if log.isEnabledFor(logging.DEBUG):
            log.debug(
                "detect_loop kf=%d min_score=%.3f candidates=%s groups=%s",
                kf.id, min_score, candidates,
                [(len(g), c) for g, c in self.consistent_groups])
        if not candidates:
            self.db.add(kf)
            self.consistent_groups.clear()
            return []
        # consistency groups (:154-214)
        enough = []
        new_groups = []
        consumed = [False] * len(self.consistent_groups)
        for cand in candidates:
            ckf = m.keyframes.get(cand)
            if ckf is None or ckf.bad:
                continue
            group = set(ckf.covisible) | {cand}
            consistency = 0
            consistent_with_some = False
            for gi, (prev_group, prev_cons) in enumerate(self.consistent_groups):
                if group & prev_group:
                    consistency = max(consistency, prev_cons + 1)
                    consistent_with_some = True
                    consumed[gi] = True
            new_groups.append((group, consistency))
            if consistency >= COVIS_CONSISTENCY_TH:
                enough.append(cand)
            if not consistent_with_some:
                pass  # starts a fresh group with consistency 0
        self.consistent_groups = new_groups
        self.db.add(kf)
        return enough

    # ----------------------------------------------------------- compute sim3

    def _matched_map_points(self, kf1: KeyFrame, kf2: KeyFrame):
        """Descriptor association between two keyframes' map points
        (reference SearchByBoW KF-KF, used by ComputeSim3)."""
        m = self.map
        has1 = (kf1.mp_ids >= 0) & kf1.kp_valid
        has2 = (kf2.mp_ids >= 0) & kf2.kp_valid
        d = self._dev
        idx, _, valid = matcher.search_by_descriptor(
            d(kf1.kp_angle), matcher.unpack_u8(kf1.desc, self.device), d(has1),
            d(kf2.kp_angle), matcher.unpack_u8(kf2.desc, self.device), d(has2),
            ratio=0.75,
        )
        ii, vi = graphs_mod.fetch(idx, valid)
        pairs = []
        for i in np.nonzero(vi)[0]:
            mp1 = m.get_mp(int(kf1.mp_ids[i]))
            mp2 = m.get_mp(int(kf2.mp_ids[ii[i]]))
            if mp1 is not None and mp2 is not None:
                pairs.append((i, int(ii[i]), mp1, mp2))
        return pairs

    # -- sim3-directed projection (shared by SearchBySim3 / SearchByProjection(Scw)
    #    / SearchAndFuse; reference ORBmatcher.cc:258-362, 844-954, 956-1159)

    def _project_into_kf(self, kf: KeyFrame, Rcw, tcw, scw, mp_ids: List[int],
                         th: float, dist_th: int, free_only: bool = False):
        """Project map points through the similarity (scw*(Rcw x)+tcw) into
        keyframe kf and match each to its best keypoint: radius
        th*scale(predicted level), level window [l-1, l], best Hamming under
        dist_th. Returns (kp_idx (M,), valid (M,)) aligned to mp_ids."""
        m = self.map
        M = Mb = len(mp_ids)
        pos = np.zeros((Mb, 3), np.float32)
        desc = np.zeros((Mb, 32), np.uint8)
        mind = np.zeros(Mb, np.float32)
        maxd = np.zeros(Mb, np.float32)
        normal = np.zeros((Mb, 3), np.float32)
        ok = np.zeros(Mb, bool)
        garr = np.asarray(mp_ids, np.int64)  # table gathers, masked by alive
        if len(m.mp_alive):  # guard: map cleared under a concurrent reset
            ok[:M] = (garr >= 0) & (garr < len(m.mp_alive))
            safe = np.where(ok[:M], garr, 0)
            ok[:M] &= m.mp_alive[safe]
            pos[:M] = m.mp_pos[safe]
            desc[:M] = m.mp_desc[safe]
            mind[:M], maxd[:M] = m.mp_mind[safe], m.mp_maxd[safe]
            normal[:M] = m.mp_normal[safe]
        Xc = scw * (pos @ np.asarray(Rcw).T) + np.asarray(tcw)
        z = Xc[:, 2]
        ok &= z > 0
        zs = np.maximum(z, 1e-9)
        cam = self.config.camera
        u = cam.fx * Xc[:, 0] / zs + cam.cx
        v = cam.fy * Xc[:, 1] / zs + cam.cy
        b = m.image_bounds  # undistorted image bounds recorded by Tracking
        if b is None:  # fallback: keyframe keypoint extent
            b = (float(kf.kp_und[kf.kp_valid, 0].min()), float(kf.kp_und[kf.kp_valid, 0].max()),
                 float(kf.kp_und[kf.kp_valid, 1].min()), float(kf.kp_und[kf.kp_valid, 1].max()))
        ok &= (u >= b[0]) & (u < b[1]) & (v >= b[2]) & (v < b[3])
        Ow = -np.asarray(Rcw).T @ (np.asarray(tcw) / max(scw, 1e-12))
        PO = pos - Ow
        dist = np.linalg.norm(PO, axis=-1)
        ok &= (dist >= mind) & (dist <= maxd) & (dist > 1e-9)
        ok &= np.sum(PO * normal, -1) >= 0.5 * dist  # 60 deg viewing gate
        level = np.ceil(np.log(np.maximum(maxd, 1e-9) / np.maximum(dist, 1e-9))
                        / np.log(self.config.orb.scale_factor)).astype(np.int32)
        level = np.clip(level, 0, self.config.orb.n_levels - 1)
        kp_free = kf.kp_valid & ((kf.mp_ids < 0) if free_only else True)
        d = self._dev
        idx, _, valid = matcher.search_fuse(
            d(kf.kp_und), d(kf.kp_octave),
            matcher.unpack_u8(kf.desc, self.device), d(kp_free),
            d(np.stack([u, v], -1).astype(np.float32)), d(level),
            matcher.unpack_u8(desc, self.device), d(ok),
            self.j_sfs, th=th, dist_th=dist_th,
        )
        return graphs_mod.fetch(idx, valid)

    def _search_by_sim3(self, kf1: KeyFrame, kf2: KeyFrame, matched1: set, matched2: set,
                        R12, t12, s12, th: float = 7.5):
        """Reference SearchBySim3 (ORBmatcher.cc:956-1159): mutual sim3-directed
        projection search between the two loop keyframes' map points.
        Returns new (i1, i2, mp1, mp2) pairs."""
        m = self.map
        # direction 1: kf1 map points into kf2 via S21 = S12^-1 composed with T1w
        Ri, ti, si = lie_sim3_inv_np(R12, t12, s12)
        R2w_s = Ri @ kf1.Rcw
        t2w_s = si * (Ri @ kf1.tcw) + ti
        ids1 = [int(mid) for q, mid in enumerate(kf1.mp_ids)
                if mid >= 0 and q not in matched1 and m.get_mp(int(mid)) is not None]
        k1_of = {mid: q for q, mid in enumerate(kf1.mp_ids) if mid >= 0}
        idx2, val2 = (np.zeros(0, np.int64), np.zeros(0, bool)) if not ids1 else self._project_into_kf(
            kf2, R2w_s, t2w_s, si, ids1, th, matcher.TH_HIGH)
        # direction 2: kf2 map points into kf1 via S12 composed with T2w
        R1w_s = R12 @ kf2.Rcw
        t1w_s = s12 * (R12 @ kf2.tcw) + t12
        ids2 = [int(mid) for q, mid in enumerate(kf2.mp_ids)
                if mid >= 0 and q not in matched2 and m.get_mp(int(mid)) is not None]
        k2_of = {mid: q for q, mid in enumerate(kf2.mp_ids) if mid >= 0}
        idx1, val1 = (np.zeros(0, np.int64), np.zeros(0, bool)) if not ids2 else self._project_into_kf(
            kf1, R1w_s, t1w_s, s12, ids2, th, matcher.TH_HIGH)
        # mutual agreement: mp1 -> kp2 and the map point AT kp2 -> kp1 = mp1's kp
        match12 = {}  # kp1 index -> kp2 index
        for q, mid in enumerate(ids1):
            if val2[q]:
                match12[k1_of[mid]] = int(idx2[q])
        match21 = {}
        for q, mid in enumerate(ids2):
            if val1[q]:
                match21[k2_of[mid]] = int(idx1[q])
        out = []
        for i1, i2 in match12.items():
            if match21.get(i2) == i1:
                mp1 = m.get_mp(int(kf1.mp_ids[i1]))
                mp2 = m.get_mp(int(kf2.mp_ids[i2]))
                if mp1 is not None and mp2 is not None:
                    out.append((i1, i2, mp1, mp2))
        return out

    def _compute_sim3(self, kf: KeyFrame, candidates: List[int]):
        """Reference ComputeSim3 (LoopClosing.cc:230-399). Every candidate is
        SetNotErase-protected on entry (cc:255) and released when it fails
        (cc:347-356) or when another candidate wins (cc:386-390); the winner
        stays protected until CorrectLoop finishes."""
        m = self.map

        def release(except_id=None):
            for c in candidates:
                if c == except_id:
                    continue
                okf = m.keyframes.get(c)
                if okf is not None:
                    m.set_erase(okf)

        for cand in candidates:
            ckf = m.keyframes.get(cand)
            if ckf is not None:
                m.set_not_erase(ckf)
        for cand in candidates:
            ckf = m.keyframes.get(cand)
            if ckf is None or ckf.bad:
                continue
            pairs = self._matched_map_points(kf, ckf)
            if len(pairs) < 20:
                continue

            def build_arrays(prs):
                """(X1, X2, uv1, uv2, w1, w2) of the matched pairs, numpy at
                their actual count."""
                i1 = [p[0] for p in prs]
                i2 = [p[1] for p in prs]
                X1 = np.stack([kf.Rcw @ p[2].pos + kf.tcw for p in prs]).astype(np.float32)
                X2 = np.stack([ckf.Rcw @ p[3].pos + ckf.tcw for p in prs]).astype(np.float32)
                return (X1, X2, kf.kp_und[i1].astype(np.float32), ckf.kp_und[i2].astype(np.float32),
                        self.inv_sigma2[kf.kp_octave[i1]].astype(np.float32),
                        self.inv_sigma2[ckf.kp_octave[i2]].astype(np.float32))

            arrays = build_arrays(pairs)
            noise = torch.as_tensor(self.uniform_noise((SIM3_HYPOTHESES, len(pairs))),
                                    device=self.device)
            res = sim3solver.ransac_sim3(noise, self.jK, self.jK,
                                         *(self._dev(a) for a in arrays + (np.ones(len(pairs), bool),)),
                                         fix_scale=self.fix_scale)
            success, R12_0, t12_0, s12_0 = graphs_mod.fetch(res.success, res.R, res.t, res.s)
            if not bool(success):
                continue
            # widen matches with the mutual sim3-directed search before the
            # refinement (reference LoopClosing.cc:319 SearchBySim3 th=7.5)
            extra = self._search_by_sim3(
                kf, ckf, {p[0] for p in pairs}, {p[1] for p in pairs}, R12_0, t12_0, float(s12_0))
            if extra:
                pairs = pairs + extra
                arrays = build_arrays(pairs)
            # each pair holds a keypoint of kf of its own (the descriptor
            # search gives a keypoint one match, the sim3-directed search
            # skips matched keypoints), so kf's keypoint capacity bounds the rows
            opt = self.refine_sim3(arrays, res.R, res.t, res.s, rows=len(kf.kp_und))
            n_inl, R12, t12, s12, inl = graphs_mod.fetch(opt.n_inliers, opt.R, opt.t, opt.s, opt.inliers)
            if int(n_inl) < 20:
                continue
            # S_cw: current camera from world via the loop keyframe:
            # S12 maps cand-camera -> current-camera; Scw = S12 * T2w
            s12 = float(s12)
            Rcw_s = R12 @ ckf.Rcw
            tcw_s = s12 * (R12 @ ckf.tcw) + t12
            # projection search through Scw over the loop keyframe's neighborhood
            # map points (reference SearchByProjection(Scw), :374-385)
            loop_points = {}
            seen = set()
            for nb in [cand] + ckf.best_covisible(10):
                nkf = m.keyframes.get(nb)
                if nkf is None or nkf.bad:
                    continue
                for mid in nkf.mp_ids:
                    rid = m.resolve(int(mid)) if mid >= 0 else -1
                    if rid >= 0 and rid not in seen:
                        seen.add(rid)
            loop_mp_ids = list(seen)
            if not loop_mp_ids:
                continue
            # projection through Scw with predicted scale levels (reference
            # SearchByProjection(Scw) overload, ORBmatcher.cc:258-362, th=10)
            ii, vi = self._project_into_kf(kf, Rcw_s, tcw_s, s12, loop_mp_ids,
                                           th=10.0, dist_th=matcher.TH_LOW)
            total = {}
            for q in np.nonzero(vi)[0]:
                total[int(ii[q])] = loop_mp_ids[q]
            # include the verified sim3 inlier pairs
            for j, (i1, i2, mp1, mp2) in enumerate(pairs):
                if inl[j]:
                    total[i1] = mp2.id
            if len(total) >= 40:
                release(except_id=cand)
                return True, cand, (Rcw_s.astype(np.float32), tcw_s.astype(np.float32), s12), \
                    (total, loop_mp_ids)
        release()
        return False, -1, None, None

    def refine_sim3(self, arrays, R0, t0, s0, rows: int) -> sim3opt.Sim3Result:
        """`optimize_sim3` of the matches `arrays` (numpy X1, X2, uv1, uv2,
        w1, w2 at the live count) padded to `rows` rows as the JAX loop
        closer pads them (valid False, z = 1, weight 1), through the captured
        LM iteration with graphs. Raises past `rows`; never truncates."""
        n = len(arrays[0])
        if n > rows:
            raise ValueError(f"{n} Sim(3) matches past the row capacity {rows}")
        X1, X2, uv1, uv2, w1, w2 = (pad_rows(a, rows, fill) for a, fill in zip(arrays, (0, 0, 0, 0, 1, 1)))
        X1[n:, 2] = X2[n:, 2] = 1.0  # padded rows in front of both cameras
        return sim3opt.optimize_sim3(
            self.jK, self.jK, *(self._dev(a) for a in (X1, X2, uv1, uv2, w1, w2, np.arange(rows) < n)),
            R0, t0, s0, step=self._sim3_step)

    # ----------------------------------------------------------- correct loop

    def _correct_loop(self, kf: KeyFrame, match_kf_id: int, Scw,
                      loop_points: Dict[int, int], loop_mp_ids: List[int]):
        """Reference CorrectLoop (LoopClosing.cc:401-597)."""
        m = self.map
        if self.local_mapper is not None:
            # drain, like RequestStop+spin — under the map lock: mapping
            # mutates map_points/keyframes while the tracker thread reads them
            # in its host phases (a fused frame whose unlocked device phase
            # this correction overlaps is tracked again on consume, through
            # Map.correction_epoch; all callers invoke _correct_loop with the
            # lock NOT held, so this cannot deadlock)
            with m.update_lock:
                self.local_mapper.process_queue()
        # abort a global BA still running from a previous loop and wait for
        # it (reference LoopClosing.cc:406-419); not under the lock, which
        # the GBA thread needs for its apply
        if self.gba_thread is not None and self.gba_thread.is_alive():
            self.stop_gba = True
            self.full_ba_index += 1
            self.gba_thread.join()
        self.stop_gba = False
        Rcor, tcor, scor = Scw
        stat = {"kf": kf.id, "match_kf": match_kf_id, "sim3_ms": self._sim3_ms}
        t0 = time.perf_counter()

        with m.update_lock:
            # whole-map pose rewrite begins: a frame in flight (pipelined,
            # or in a fused frame's device phase) was computed against
            # pre-correction geometry and is re-tracked on consume
            # (Map.correction_epoch)
            m.correction_epoch += 1
            # corrected sim3 for current KF + covisibles via relative SE3
            connected = [kf.id] + list(kf.covisible)
            corrected: Dict[int, tuple] = {}
            noncorrected: Dict[int, tuple] = {}
            for kfi_id in connected:
                kfi = m.keyframes.get(kfi_id)
                if kfi is None or kfi.bad:
                    continue
                noncorrected[kfi_id] = (kfi.Rcw.copy(), kfi.tcw.copy(), 1.0)
                if kfi_id == kf.id:
                    corrected[kfi_id] = (Rcor, tcor, scor)
                else:
                    # T_i_cur = T_iw * T_wc ; S_i = S_ic * S_cur with S_ic of
                    # scale 1 (reference LoopClosing.cc:454-459). Sim3
                    # composition (R1,t1,s1)*(R2,t2,s2) = (R1R2, s1 R1 t2 + t1,
                    # s1 s2); the LEFT element has scale 1, so the composed
                    # translation is Ric@tcor + tic and only the composed
                    # scale carries scor.
                    Ric = kfi.Rcw @ kf.Rcw.T
                    tic = kfi.tcw - Ric @ kf.tcw
                    Rn = Ric @ Rcor
                    tn = Ric @ tcor + tic
                    corrected[kfi_id] = (Rn.astype(np.float32), tn.astype(np.float32), scor)

            # correct map points observed by the connected group (:446-523);
            # record WHICH keyframe corrected each point — the essential
            # graph must remap these through the correcting KF's vertex, not
            # their (possibly outside-the-group) reference KF (reference
            # mnCorrectedByKF / mnCorrectedReference, LoopClosing.cc:469-476)
            done_points = {}
            for kfi_id, (Rn, tn, sn) in corrected.items():
                kfi = m.keyframes[kfi_id]
                Ro, to, _ = noncorrected[kfi_id]
                # p_w' = S_corrected^-1 * (T_old * p_w)
                Rn_inv = Rn.T
                for mid in kfi.mp_ids:
                    rid = m.resolve(int(mid)) if mid >= 0 else -1
                    if rid < 0 or rid in done_points:
                        continue
                    done_points[rid] = kfi_id
                    mp = m.map_points[rid]
                    pc = Ro @ mp.pos + to  # old camera coords
                    pw = (Rn_inv @ ((pc - tn) / sn)).astype(np.float32)
                    mp.pos = pw
                    m.update_normal_and_depth(mp, self.config.orb.scale_factors)
                # corrected pose: SE3 with t/s (reference :516-522)
                kfi.Rcw = Rn
                kfi.tcw = (tn / sn).astype(np.float32)
                m.update_connections(kfi)

            # fuse loop points into the current keyframe (:527-539)
            for kp_idx, loop_mid in loop_points.items():
                loop_mp = m.get_mp(loop_mid)
                if loop_mp is None:
                    continue
                cur_mid = m.resolve(int(kf.mp_ids[kp_idx]))
                if cur_mid >= 0 and cur_mid != loop_mp.id:
                    m.replace_map_point(m.map_points[cur_mid], loop_mp)
                else:
                    m.add_observation(loop_mp, kf, int(kp_idx))
                    m.compute_distinctive_descriptor(loop_mp)

            # SearchAndFuse: project the loop-side map points into EVERY
            # keyframe of the corrected group through its corrected Sim3 and
            # replace-or-add (reference LoopClosing.cc:599-623 + the Scw Fuse
            # overload ORBmatcher.cc:844-954, th=4)
            for kfi_id, (Rn, tn, sn) in corrected.items():
                kfi = m.keyframes.get(kfi_id)
                if kfi is None or kfi.bad:
                    continue
                live = [mid for mid in loop_mp_ids if m.get_mp(mid) is not None
                        and kfi_id not in m.map_points[m.resolve(mid)].observations]
                if not live:
                    continue
                ii, vi = self._project_into_kf(kfi, Rn, tn, sn, live,
                                               th=4.0, dist_th=matcher.TH_LOW)
                for q in np.nonzero(vi)[0]:
                    loop_mp = m.get_mp(live[q])
                    if loop_mp is None:
                        continue
                    kp = int(ii[q])
                    existing = m.resolve(int(kfi.mp_ids[kp]))
                    if existing >= 0 and existing != loop_mp.id:
                        m.replace_map_point(m.map_points[existing], loop_mp)
                    elif existing < 0:
                        m.add_observation(loop_mp, kfi, kp)

            # new covisibility links created by the fusion (reference
            # LoopClosing.cc:549-573): connections that exist now but neither
            # existed before the fusion nor are intra-group links
            group_set = set(corrected.keys())
            loop_connections: Dict[int, set] = {}
            for kfi_id in corrected:
                kfi = m.keyframes.get(kfi_id)
                if kfi is None or kfi.bad:
                    continue
                prev = set(kfi.covisible)
                m.update_connections(kfi)
                loop_connections[kfi_id] = set(kfi.covisible) - prev - group_set

            stat["correct_fuse_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            stat["edges"] = self._optimize_essential_graph(
                kf, match_kf_id, corrected, noncorrected, loop_connections,
                corrected_ref=done_points)
            stat["essential_graph_ms"] = (time.perf_counter() - t0) * 1e3
            stat["essential_graph_solve_ms"] = self._eg_solve_ms  # the device solve alone

            # loop edges — added AFTER the essential graph like the reference
            # (LoopClosing.cc:580-584): they feed FUTURE pose-graph solves,
            # measured from the by-then-corrected poses
            mkf = m.keyframes.get(match_kf_id)
            if mkf is not None:
                # AddLoopEdge pins both anchors against culling permanently
                # (reference KeyFrame.cc:427-434 sets not_erase_)
                kf.loop_edges.add(match_kf_id)
                mkf.loop_edges.add(kf.id)
                kf.not_erase = True
                mkf.not_erase = True
            # reference InformNewBigChange at the end of CorrectLoop
            # (LoopClosing.cc:580) — consumed by MonoSLAM.map_changed()
            m.big_change_idx += 1

        # full-map BA: 50 iterations, abortable between chunks, side-field
        # write and spanning-tree propagation (RunGlobalBundleAdjustment,
        # LoopClosing.cc:646-739); on its own thread with threaded_gba, as
        # the reference's `new thread(...)` (:590-591), else inline
        def gba(loop_id=kf.id, index=self.full_ba_index):
            log.info("Starting Global Bundle Adjustment")
            t0 = time.perf_counter()
            with graphs_mod.on_owner_stream(self.device, "mapper"):
                ok = run_global_ba(m, self.config, loop_id, n_iters=50,
                                   stop_cb=lambda: self.stop_gba or index != self.full_ba_index,
                                   force_cg=self.gba_force_cg, device=self.device, stats=stat,
                                   **self._gba_steps)
            stat["gba_ms"] = (time.perf_counter() - t0) * 1e3
            log.info("Global Bundle Adjustment %s", "finished" if ok else "aborted")
            if ok:
                self.n_gba_runs += 1
            self.loop_stats.append(stat)

        def gba_thread():
            try:
                gba()
            except Exception as e:  # the thread's boundary: hand it to the facade
                log.exception("global BA thread failed")
                self.gba_error = e

        if self.threaded_gba:
            self.gba_thread = threading.Thread(target=gba_thread, name="gba", daemon=True)
            self.gba_thread.start()
        else:
            gba()
        self.last_loop_kf_id = kf.id
        self.n_loops_closed += 1

    def _optimize_essential_graph(self, kf: KeyFrame, match_kf_id: int,
                                  corrected: Dict[int, tuple],
                                  noncorrected: Dict[int, tuple],
                                  loop_connections: Dict[int, set],
                                  corrected_ref: Dict[int, int] = None):
        """Assemble + run the sim3 pose graph (reference OptimizeEssentialGraph,
        CeresOptimizer.cc:737-957).

        The split that makes this effective (reference cc:775-776, 828-848):
        vertices of the corrected group INITIALIZE at their corrected Sim3,
        but spanning-tree/covisibility/loop-edge MEASUREMENTS are built from
        the non-corrected poses — so the loop constraint carries a nonzero
        residual that the solve distributes around the graph. Post-fusion
        loop_connections edges measure from the corrected values. The
        loop-match keyframe is fixed (cc:788-791). Returns the edge count.
        """
        m = self.map
        kfs = sorted(m.all_keyframes(), key=lambda x: x.id)
        slot = {k.id: i for i, k in enumerate(kfs)}
        P = len(kfs)

        # vertex initial values: corrected sim3 for the group, SE3 otherwise
        R = np.zeros((P, 3, 3), np.float32)
        t = np.zeros((P, 3), np.float32)
        s = np.ones(P, np.float32)
        for k in kfs:
            i = slot[k.id]
            if k.id in corrected:
                Rc, tc, sc = corrected[k.id]
                R[i], t[i], s[i] = Rc, tc, sc
            else:
                R[i], t[i] = k.Rcw, k.tcw

        # measurement source: NON-corrected pose for the group, current
        # (never-corrected) pose otherwise — all scale-1 SE3
        def meas_pose(kf_id):
            if kf_id in noncorrected:
                Ro, to, _ = noncorrected[kf_id]
                return np.asarray(Ro, np.float64), np.asarray(to, np.float64), 1.0
            k = m.keyframes[kf_id]
            return k.Rcw.astype(np.float64), k.tcw.astype(np.float64), 1.0

        edges = set()
        ei, ej = [], []
        Rm_l, tm_l, sm_l = [], [], []

        def add_edge(a, b, Sa, Sb):
            """Edge with measurement S_ba = S_b * S_a^-1 from given sim3s."""
            if a == b or (min(a, b), max(a, b)) in edges:
                return
            if a not in slot or b not in slot:
                return
            edges.add((min(a, b), max(a, b)))
            Ra, ta, sa = Sa
            Rb, tb, sb = Sb
            Rai, tai, sai = lie_sim3_inv_np(Ra, ta, sa)
            Rba = np.asarray(Rb, np.float64) @ Rai
            tba = sb * (np.asarray(Rb, np.float64) @ tai) + np.asarray(tb, np.float64)
            ei.append(slot[a])
            ej.append(slot[b])
            Rm_l.append(Rba.astype(np.float32))
            tm_l.append(tba.astype(np.float32))
            sm_l.append(float(sb) * sai)

        # 0. the loop constraint itself: current<->match measured from the
        #    corrected vertex values. The reference gets this edge through
        #    LoopConnections (fusion always links the pair); adding it
        #    explicitly makes the loop closure independent of fusion yield.
        if kf.id in slot and match_kf_id in slot:
            ic, im = slot[kf.id], slot[match_kf_id]
            add_edge(kf.id, match_kf_id, (R[ic], t[ic], s[ic]), (R[im], t[im], s[im]))

        # 1. loop_connections edges: measurements from the CORRECTED initial
        #    values (these links only exist post-correction), weight-gated
        #    except the current<->match pair (reference cc:791-821)
        for kfi_id, links in (loop_connections or {}).items():
            kfi = m.keyframes.get(kfi_id)
            if kfi is None:
                continue
            for nb in links:
                if not ((kfi_id == kf.id and nb == match_kf_id) or
                        (kfi_id == match_kf_id and nb == kf.id)):
                    if kfi.covisible.get(nb, 0) < MIN_EDGE_WEIGHT:
                        continue
                if nb not in slot or kfi_id not in slot:
                    continue
                Sa = (R[slot[kfi_id]], t[slot[kfi_id]], s[slot[kfi_id]])
                Sb = (R[slot[nb]], t[slot[nb]], s[slot[nb]])
                add_edge(kfi_id, nb, Sa, Sb)

        # 2. spanning tree + previous loop edges + strong covisibility, all
        #    measured from NON-corrected poses (reference cc:823-909)
        for k in kfs:
            if k.parent is not None and k.parent in slot:
                add_edge(k.parent, k.id, meas_pose(k.parent), meas_pose(k.id))
            for le in k.loop_edges:
                if le in slot:
                    add_edge(k.id, le, meas_pose(k.id), meas_pose(le))
            for nb, w in k.covisible.items():
                if w >= MIN_EDGE_WEIGHT and nb in slot:
                    add_edge(k.id, nb, meas_pose(k.id), meas_pose(nb))
        if not ei:
            self._eg_solve_ms = 0.0
            return 0
        fixed = np.zeros(P, bool)
        if match_kf_id in slot:
            fixed[slot[match_kf_id]] = True
        else:
            fixed[0] = True

        d = self._dev
        t0 = time.perf_counter()
        res = sim3opt.optimize_essential_graph(
            d(R), d(t), d(s), d(np.array(ei, np.int64)), d(np.array(ej, np.int64)),
            d(np.stack(Rm_l).astype(np.float32)), d(np.stack(tm_l).astype(np.float32)),
            d(np.array(sm_l, np.float32)), torch.ones(len(ei), dtype=torch.bool, device=self.device),
            d(fixed), gn_iters=EG_GN_ITERS, cg_iters=EG_CG_ITERS, step=self._eg_step,
        )
        Rn, tn, sn = graphs_mod.fetch(res.R, res.t, res.s)
        self._eg_solve_ms = (time.perf_counter() - t0) * 1e3
        # recover SE3 (t/s) + remap map points via their reference keyframes:
        # X' = S_new^-1 (S_init (X)) with S_init the vertex INITIAL sim3
        # (reference cc:916-956)
        for k in kfs:
            i = slot[k.id]
            k.Rcw = Rn[i]
            k.tcw = (tn[i] / max(sn[i], 1e-9)).astype(np.float32)
        for mp in m.all_map_points():
            # points already moved by _correct_loop transform through the
            # KEYFRAME THAT CORRECTED THEM (its corrected-sim3 vertex init);
            # routing them through an outside-the-group reference KF would
            # apply the loop correction twice (reference mnCorrectedReference,
            # CeresOptimizer.cc:936-956)
            ref_id = (corrected_ref or {}).get(mp.id, mp.ref_kf_id)
            ref = m.keyframes.get(ref_id)
            if ref is None or ref.bad or ref_id not in slot:
                continue
            i = slot[ref_id]
            pc = s[i] * (R[i].astype(np.float64) @ mp.pos.astype(np.float64)) + t[i]
            mp.pos = (Rn[i].T @ ((pc - tn[i]) / max(sn[i], 1e-9))).astype(np.float32)
            m.update_normal_and_depth(mp, self.config.orb.scale_factors)
        return len(ei)
