"""Tracking: the per-frame state machine (reference src/Tracking.cc).

Port of `ceres_mono_orb_slam2_tpu/models/tracking.py`: monocular
initialization, the motion model, reference-keyframe tracking, local-map
tracking, the fused hot path (`models/fused_track`) against the device map
pool (split into `_fused_prepare` / `_fused_dispatch` / `_fused_consume`, so
that `parallel/multisystem.py` can batch the device phase of several
streams), the keyframe decision, relocalization against a BoW keyframe
database and the trajectory log; without a relocalizer a lost frame stays
lost, as in the JAX package with no vocabulary. In localization mode
(`localization_only`) the tracker tracks against a frozen map, serially:
no keyframe is inserted, no frame fuses or chains, and a weakly tracked
frame (`do_vo`) is tracked both by the motion model and by relocalization
(`_tracking_with_known_map`).

Every read and write of the map by the tracker runs under
`map.update_lock`, which a mapper thread takes per stage. A fused frame
takes it for its two host phases (prepare, consume) and releases it around
its device phase, which reads device tensors only (the extraction, the
pool's gathered block, the last frame's features): as local mapping
releases it around its device solves, so the two threads' device work
overlaps. A loop correction or a global-BA apply that lands in that device
phase rewrites the poses the frame was solved against: the frame is then
tracked again under the lock (`_retrack_if_corrected`). A non-fused frame
extracts without the lock and tracks under it.
With `pipelined=True` frame k's fused step is dispatched before frame k-1's
control buffer is consumed (`_grab_pipelined`): the prediction and the
last-frame bindings chain on the device, and a pose returns one frame late.

The device work of a fused frame is ONE captured program, the counterpart
of the JAX package's `_ensure_frontend` (`utils/graphs.py`: a CUDA graph per
(H, W, N, L), replayed every frame; on the CPU the same staging without
capture): the extraction with both kernels, the fused step and
`pack_control`. The same program serves the serial and the chained frame:
a 0-d flag selects on the device between the host-uploaded prediction and
last-frame block and the chained prediction from the previous frame's
outputs. The local-map block is gathered from the pool into the program's
static buffers before the replay, so no capture reads the pool. The
unfused pose solves (reference keyframe, relocalization, localization mode)
replay a captured `pose_optimization` per shape. A non-fused frame's
extraction (initialization, reference-keyframe, relocalization and
localization frames; JAX: the jitted extractor) replays a program per
(H, W, N) with both kernels inside, and relocalization's RANSAC, padded to
`RELOC_MAX_CANDIDATES` candidates as in the JAX tracker, replays its four
stages around the three host-checked linear-algebra calls (`ops/pnp.py`).
Monocular initialization replays the bootstrap matcher per N, the two-view
RANSAC's four stages around its five host-checked linear-algebra calls
(`ops/twoview.py`) and each LM iteration of the initial map's global BA
(JAX: three jitted programs). `graphs=False` calls the same functions
directly, as `jax.disable_jit` does.
"""

from __future__ import annotations

import enum
import itertools
import logging
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.frame import Frame, compute_image_bounds
from ceres_mono_orb_slam2_tpu_torch.models.map import Map
from ceres_mono_orb_slam2_tpu_torch.ops import frustum, matcher, optim, pnp, twoview
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.utils import graphs as graphs_mod
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger(__name__)

# candidate cap of the batched relocalization PnP (the reference's
# accumulator keeps about the top groups, KeyFrameDatabase.cc:280-310)
RELOC_MAX_CANDIDATES = 8
RELOC_HYPOTHESES = 256


class State(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class Tracking:
    def __init__(self, config, map_: Map, extractor, local_mapper=None, relocalizer=None,
                 device=DEFAULT_DEVICE, generator: Optional[torch.Generator] = None,
                 pipelined: bool = False, graphs: bool = True):
        self.config = config
        self.map = map_
        self.extractor = extractor
        self.local_mapper = local_mapper
        self.relocalizer = relocalizer  # optional: a KeyFrameDatabase
        self.device = resolve_device(device)
        cam = config.camera
        self.cam = cam
        self.jK = self._dev(cam.K)
        self.scale_factors = config.orb.scale_factors
        self.inv_sigma2 = config.orb.inv_level_sigma2
        self.j_scale = self._dev(self.scale_factors.astype(np.float32))
        self.log_scale = float(np.log(config.orb.scale_factor))
        self.n_levels = config.orb.n_levels
        self.bounds: Optional[np.ndarray] = None  # set on the first frame
        self.j_bounds = None

        self.state = State.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.current: Optional[Frame] = None
        # the image of `current` for the FrameDrawer (`viewer.py`), one
        # reference, not a copy: set as a frame's tracking starts
        # (`_track_serial`) or its pipelined result is consumed, so a frame
        # left in flight does not replace it
        self.current_image: Optional[np.ndarray] = None
        self.velocity = None  # (R, t) relative motion or None
        self.ref_kf_id: Optional[int] = None
        self.init_ref: Optional[Frame] = None
        self.last_kf_id = -1
        self.last_reloc_frame_id = -1
        self.matches_inliers = 0
        self.max_frames = int(cam.fps)
        self.min_frames = 0
        self.localization_only = False
        self.do_vo = False  # the reference's do_vo_: weak map tracking in localization mode
        # RANSAC noise of the two-view initializer and of relocalization;
        # `uniform_noise(shape)` may be replaced to inject draws (tests feed
        # the JAX tracker's)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(0)
        self.uniform_noise = self._draw_uniform
        # per-tracker frame sequence (the keyframe cadence gates count frames)
        self._frame_seq = itertools.count()
        # per-frame trajectory log: (ref_kf_id, R_rel, t_rel, timestamp, lost)
        self.trajectory = []
        self.n_resets = 0
        self.frame_stats = []
        self._stat = {}

        self.fused_enabled = bool(getattr(config, "fused_tracking", True))
        self._pool = None
        self._fused_step = None
        self.n_fused_frames = 0
        # captured programs (utils/graphs.py): the frontend (with the
        # extractor it captured), a non-fused frame's extraction, the
        # unfused pose solve, relocalization's RANSAC stages and the
        # initializer's (`_initializer_programs`); graphs=False calls the
        # functions directly
        self.graphs = bool(graphs)
        self._frontend = None
        self._extraction = None
        self._pose_solver = None
        self._ransac = None
        self._initializer = None
        self._consts = {}

        # pipelined mode: the in-flight frame (its device outputs, started
        # control copy, host context and the chain guards at its dispatch)
        self.pipelined = bool(pipelined)
        self._pending: Optional[dict] = None
        self._chain_len = 0
        self.n_chained_frames = 0
        # in-flight frames whose device result was thrown away and which
        # were tracked again from their image (each extracts once more)
        self.n_discarded_chained = 0
        # every frame tracked again from its image, in any mode: the
        # pipelined discards, and fused frames under which a loop correction
        # or a global-BA apply landed during the unlocked device phase
        self.n_retracked_frames = 0
        # the last keyframe decision wanted a keyframe that the busy mapper
        # could not take (see `_need_new_keyframe`)
        self.keyframe_wanted = False

    # ------------------------------------------------------------------ utils

    def _dev(self, a, dtype=None):
        return self._host(a, dtype).to(self.device)

    @staticmethod
    def _host(a, dtype=None):
        """A host array (0-d included) as a contiguous CPU tensor."""
        a = np.asarray(a, dtype)
        return torch.as_tensor(a if a.flags.c_contiguous else a.copy())

    def _const(self, key, make):
        """A device tensor made once and kept (flags, radii, dummies)."""
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = make()
        return t

    def _draw_uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    def build_frame(self, image: np.ndarray, timestamp: float) -> Frame:
        self.set_image_size(*image.shape[-2:])
        feats = self._extract(image)
        feats = type(feats)(*(a[0] for a in feats))
        return Frame(feats, self.cam, timestamp, frame_id=next(self._frame_seq))

    def _extract(self, image: np.ndarray):
        """A non-fused frame's features: the extraction program of this
        extractor (JAX: the jitted extractor), or the extractor called
        directly without graphs or for a non-image extractor such as
        `utils/geosim.GeoExtractor`."""
        ex = self.extractor
        if not (self.graphs and isinstance(ex, ORBExtractor)):
            return ex.extract(image)
        if self._extraction is None or self._extraction[0] is not ex:
            # the capture takes the map lock as the frontend's does (an
            # RLock: a frame tracked again under it extracts too)
            self._extraction = (ex, graphs_mod.CapturedFunction(
                ex.extract, self.device, name="extract", lock=lambda m=self.map: m.update_lock))
        return self._extraction[1](self._host(image))

    def set_image_size(self, h: int, w: int):
        """The undistorted image bounds of an (h, w) image, which the first
        frame sets (`MonoSLAM.prewarm` sets them before it)."""
        if self.bounds is None:
            self.bounds = compute_image_bounds(self.cam, h, w)
            self.j_bounds = self._dev(self.bounds)
            self.map.image_bounds = self.bounds

    def grab_image(self, image: np.ndarray, timestamp: float):
        """Reference GrabImageMonocular + Track (Tracking.cc:154-383).
        Returns Tcw (4, 4) or None if not tracked."""
        # track 8-bit grayscale like the reference; quantise float input
        if image.dtype != np.uint8:
            image = np.clip(image + 0.5, 0.0, 255.0).astype(np.uint8)
        if self.pipelined:
            return self._grab_pipelined(image, timestamp)
        self._track_serial(image, timestamp)
        return self._last_T()

    def _last_T(self):
        """Tcw (4, 4) of the current (last consumed) frame, or None."""
        f = self.current
        if f is not None and f.pose_set:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = f.Rcw
            T[:3, 3] = f.tcw
            return T
        return None

    # ------------------------------------------------------------- fused path

    def _can_fuse(self) -> bool:
        return (self.fused_enabled and self.state == State.OK and self.velocity is not None
                and not self.localization_only and self.bounds is not None and self.last_frame is not None
                and self.last_frame.pose_set and self.map.n_keyframes() >= 2)

    def _ensure_pool(self):
        if self._pool is None:
            from ceres_mono_orb_slam2_tpu_torch.models.device_map import DeviceMapPool

            cap = self.config.shapes.device_pool_cap or max(
                4096, 4 * self.config.shapes.max_local_points)
            self._pool = DeviceMapPool(self.map, cap=cap, device=self.device)
        return self._pool

    def _ensure_fused_step(self):
        if self._fused_step is None:
            from ceres_mono_orb_slam2_tpu_torch.models.fused_track import FusedStep

            self._fused_step = FusedStep(self.config, device=self.device)
        return self._fused_step

    def _local_block(self, frame: Frame):
        """Local-map candidate block of the fused step, from the previous
        frame's associations: unique pool slots over the local keyframes
        plus a 1-hop covisibility closure, highest-covisibility first."""
        local_kfs = self._local_keyframes(frame)
        if not local_kfs:
            return [], np.zeros(0, np.int32)
        expanded = list(local_kfs)
        seen = set(local_kfs)
        for kf_id in local_kfs:
            kf = self.map.keyframes.get(kf_id)
            if kf is None:
                continue
            for nb in kf.best_covisible(10) + list(kf.children) + (
                    [kf.parent] if kf.parent is not None else []):
                if nb not in seen:
                    nkf = self.map.keyframes.get(nb)
                    if nkf is not None and not nkf.bad:
                        expanded.append(nb)
                        seen.add(nb)
        local_kfs = expanded[:96]
        chunks = []
        for kf_id in local_kfs:
            kf = self.map.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                chunks.append(kf.mp_ids[kf.mp_ids >= 0])
        if not chunks:
            return local_kfs, np.zeros(0, np.int32)
        # first-occurrence dedup preserving keyframe-priority order, so a cap
        # drops the least covisible points
        cat = np.concatenate(chunks)
        _, first = np.unique(cat, return_index=True)
        slots = self._pool.slots_for_ids(cat[np.sort(first)])
        slots = slots[slots >= 0]
        cap = self.config.shapes.max_local_points
        if len(slots) > cap:
            if not getattr(self, "_warned_local_cap", False):
                self._warned_local_cap = True
                log.warning("local map truncated: %d candidate points > cap %d "
                            "(raise StaticShapes.max_local_points; warned once)",
                            len(slots), cap)
            slots = slots[:cap]
        return local_kfs, slots

    def _grab_fused(self, image: np.ndarray, timestamp: float):
        """The per-frame hot path: host prediction and local-block selection,
        extraction + pool gather + fused step on the device, ONE packed
        control copy back, then host bookkeeping (TrackWithMotionModel +
        TrackLocalMap, Tracking.cc:617-715). Falls back to reference-keyframe
        tracking when the motion-model gates fail. The host phases hold
        map.update_lock; the device phase does not, so a correction that
        lands in it makes the frame be tracked again (`_retrack_if_corrected`)."""
        with self.map.update_lock:
            args, aux = self._fused_prepare(image, timestamp)
        self._fused_finish(args, aux)

    def _fused_prepare(self, image: np.ndarray, timestamp: float):
        """Host phase 1 of the fused path: motion prediction, pool delta
        sync, local-block selection. Returns (args, aux): `args` is what the
        device phase reads, `aux` the host context `_fused_consume` needs.
        Split out so that `MultiStreamSLAM` (parallel/multisystem.py) can
        prepare S streams, run one batched device phase and consume each
        stream; call under map.update_lock.

        args = (image, last octaves, last angles, last descriptors (device
        tensors of the last frame), last_pos (N, 3), last_ok (N,),
        last_local_row (N,), R_pred (3, 3), t_pred (3,), th_local (a 0-d
        float32 array), slots_padded (L,), pool, bounds): the seven host
        inputs stay numpy, so that a batch stacks them and uploads each
        once."""
        t0 = time.perf_counter()
        lf = self.last_frame
        self._check_replaced_in_last_frame()
        self._update_last_frame()
        Rv, tv = self.velocity
        R_pred = (Rv @ lf.Rcw).astype(np.float32)
        t_pred = (Rv @ lf.tcw + tv).astype(np.float32)
        last_pos, last_ok = self._gather_frame_points(lf)
        pool = self._ensure_pool()
        pool.sync()
        local_kfs, slots = self._local_block(lf)
        L = self.config.shapes.max_local_points
        slots_padded = np.full(L, pool.cap, np.int64)
        slots_padded[: len(slots)] = slots
        row_of = pool.row_map(slots)
        ls = pool.slots_for_ids(lf.mp_ids)
        last_local_row = np.where(ls >= 0, row_of[np.maximum(ls, 0)], -1).astype(np.int32)
        # wider search right after a relocalization (Tracking.cc:808); an
        # array, so that it reaches the device as a tensor
        th_local = np.asarray(5.0 if lf.id + 1 < self.last_reloc_frame_id + 2 else 1.0, np.float32)
        # slot -> id snapshot of the local block rows
        ids_snap = np.full(L, -1, np.int64)
        ids_snap[: len(slots)] = pool.id_of[slots]
        args = (image, lf.j_octave, lf.j_angle, lf.j_desc, last_pos, last_ok, last_local_row,
                R_pred, t_pred, th_local, slots_padded, pool, self.j_bounds)
        aux = (t0, lf, local_kfs, slots, L, timestamp, ids_snap, self.map.correction_epoch)
        return args, aux

    def _fused_finish(self, args, aux):
        """Single-stream device phase and host phase 2: `_fused_dispatch`,
        one packed control copy to the host, then `_fused_consume` under
        map.update_lock."""
        out, f1, ctl, _ = self._fused_dispatch(args)
        host, = graphs_mod.fetch(ctl)
        with self.map.update_lock:
            if not self._retrack_if_corrected(args[0], aux[5], aux[-1]):
                self._fused_consume(aux, out, f1, host)

    def _retrack_if_corrected(self, image: np.ndarray, timestamp: float, epoch: int) -> bool:
        """Track a frame again, as a serial frame, when a loop correction
        or a global-BA apply rewrote keyframe poses after its prepare
        (`Map.correction_epoch` moved from `epoch`): its device outputs mix the
        old geometry with the new poses, and its trajectory entry would be
        re-based on a corrected keyframe. Call under map.update_lock, which
        the re-track keeps, so no second correction lands in it. True when
        it re-tracked."""
        if self.map.correction_epoch == epoch:
            return False
        self.n_retracked_frames += 1
        self._track_serial(image, timestamp)
        return True

    def _fused_dispatch(self, args, feats=None):
        """The device phase of one fused frame, enqueued and not waited for:
        extraction, pool gather, the fused step and its packed control
        buffer. Returns (out, feats, ctl, local block): the gathered block
        is what a chained frame of the pipelined mode matches against (with
        graphs, the program's static buffers: `_start_pipeline` keeps a
        copy). `feats` (a batch of one) stands in for the extractor's
        features of the image (`models/prewarm.py`)."""
        from ceres_mono_orb_slam2_tpu_torch.models import fused_track

        (image, last_oct, last_angle, last_desc, last_pos, last_ok, last_local_row,
         R_pred, t_pred, th_local, slots_padded, pool, bounds) = args
        if self.graphs:
            host = tuple(self._host(a) for a in (R_pred, t_pred, last_pos, last_ok, last_local_row,
                                                 th_local))
            out, f1, ctl = self._run_frontend(image, True, host, self._dummies(len(last_pos))[1],
                                              (last_oct, last_angle, last_desc),
                                              pool.gather_fills(slots_padded), feats)
            return out, f1, ctl, self._frontend[1].last_inputs[5]
        if feats is None:
            feats = self.extractor.extract(image)
        f1 = type(feats)(*(a[0] for a in feats))
        lblock = pool.gather(slots_padded)
        out = self._ensure_fused_step()(
            f1.xy, f1.octave, f1.angle, f1.desc, f1.valid, last_oct, last_angle, last_desc,
            self._dev(last_pos), self._dev(last_ok), self._dev(last_local_row),
            self._dev(R_pred), self._dev(t_pred), *lblock, bounds, self._dev(th_local))
        return out, f1, fused_track.pack_control(out, f1.valid), lblock

    # --------------------------------------------------------------- programs

    def _frontend_fn(self, extractor):
        """The frontend program of `extractor` (JAX `_ensure_frontend`):
        extraction (both kernels; a non-image extractor such as
        `utils/geosim.GeoExtractor` extracts outside and passes its
        features), the fused step and `pack_control`. `use_host` (0-d bool)
        selects the serial frame's host-uploaded prediction, last-frame
        block and radius, or the chained frame's constant-velocity
        prediction from the previous two poses and the previous frame's
        outputs."""
        from ceres_mono_orb_slam2_tpu_torch.models import fused_track

        step = self._ensure_fused_step()

        def frontend(cur, use_host, host, chain, last, lblock, bounds):
            R_h, t_h, pos_h, ok_h, row_h, th_h = host
            pR, pt, ppR, ppt, pos_c, ok_c, row_c, th_c = chain
            R_c, t_c = fused_track.chained_prediction(pR, pt, ppR, ppt)
            sel = lambda a, b: torch.where(use_host, a, b)  # noqa: E731
            feats = extractor.extract(cur) if torch.is_tensor(cur) else cur
            f1 = type(feats)(*(a[0] for a in feats))
            out = step(f1.xy, f1.octave, f1.angle, f1.desc, f1.valid, *last,
                       sel(pos_h, pos_c), sel(ok_h, ok_c), sel(row_h, row_c), sel(R_h, R_c),
                       sel(t_h, t_c), *lblock, bounds, sel(th_h, th_c))
            return out, f1, fused_track.pack_control(out, f1.valid)

        return frontend

    def _run_frontend(self, image, use_host: bool, host, chain, last, lblock, feats=None):
        """One fused frame through the frontend program: (out, feats, ctl),
        clones that outlive the next replay. `feats` stands in for a
        non-image extractor's features of the image."""
        ex = self.extractor
        if self._frontend is None or self._frontend[0] is not ex:
            self._frontend = (ex, graphs_mod.CapturedFunction(
                self._frontend_fn(ex), self.device, name="frontend",
                lock=lambda m=self.map: m.update_lock))
        cur = feats
        if cur is None:
            cur = self._host(image) if isinstance(ex, ORBExtractor) else ex.extract(image)
        flag = self._const(("use_host", use_host),
                           lambda: torch.tensor(use_host, device=self.device))
        return self._frontend[1](cur, flag, host, chain, last, lblock, self.j_bounds)

    def _dummies(self, n: int):
        """The frontend's unused lane for n keypoints: (host inputs of a
        chained frame, chained inputs of a serial frame), device tensors
        made once."""
        def make():
            d = self.device
            eye, zero = torch.eye(3, device=d), torch.zeros(3, device=d)
            pos, ok = torch.zeros((n, 3), device=d), torch.zeros(n, dtype=torch.bool, device=d)
            row = torch.full((n,), -1, dtype=torch.int32, device=d)
            one = torch.tensor(1.0, device=d)
            return (eye, zero, pos, ok, row, one), (eye, zero, eye, zero, pos, ok, row, one)

        return self._const(("dummies", n), make)

    def _solve_pose(self, K, R, t, pos, und, w, ok) -> optim.PoseOptResult:
        """`optim.pose_optimization` of one frame: a captured program per
        shape (JAX: jitted), or called directly without graphs."""
        if not self.graphs:
            return optim.pose_optimization(K, self._dev(R), self._dev(t), self._dev(pos), und,
                                           self._dev(w), self._dev(ok))
        if self._pose_solver is None:
            self._pose_solver = graphs_mod.CapturedFunction(
                optim.pose_optimization, self.device, name="pose_optimization",
                lock=lambda m=self.map: m.update_lock)
        return optim.PoseOptResult(*self._pose_solver(
            K, *(self._host(a) for a in (R, t, pos)), und, self._host(w), self._host(ok)))

    def _ransac_stages(self) -> pnp.RansacStages:
        """Relocalization's RANSAC stages: a program of each (made once),
        or the stage functions without graphs."""
        if not self.graphs:
            return pnp.RansacStages()
        if self._ransac is None:
            self._ransac = pnp.RansacStages(*(
                graphs_mod.CapturedFunction(fn, self.device, name=f"ransac_{name}",
                                            lock=lambda m=self.map: m.update_lock)
                for name, fn in zip(pnp.RansacStages._fields, pnp.RansacStages())))
        return self._ransac

    def _initializer_programs(self):
        """Monocular initialization's programs, made once (JAX: the jitted
        bootstrap matcher, two-view RANSAC and global BA): (the matcher at
        its 100-px window, per N; `twoview.TwoViewStages` of the four stage
        programs; the initial map's global-BA LM iteration, one capture and
        19 replays a solve), or None without graphs."""
        if not self.graphs:
            return None
        if self._initializer is None:
            def program(fn, name, **kw):
                return graphs_mod.CapturedFunction(fn, self.device, name=name,
                                                   lock=lambda m=self.map: m.update_lock, **kw)

            self._initializer = (
                program(partial(matcher.search_for_initialization, window=100.0), "init_match"),
                twoview.TwoViewStages(*(program(fn, f"two_view_{name}") for name, fn in
                                        zip(twoview.TwoViewStages._fields, twoview.TwoViewStages()))),
                program(optim.lm_iteration_robust, "init_gba_lm_robust", max_programs=1))
        return self._initializer

    def captured(self) -> list:
        """This tracker's `CapturedFunction`s (none without graphs)."""
        owned = [p[1] for p in (self._frontend, self._extraction) if p]
        init = []
        if self._initializer:
            match, stages, gba = self._initializer
            init = [match, *stages, gba]
        return (owned + ([self._pose_solver] if self._pose_solver else []) + list(self._ransac or ())
                + init)

    def programs(self) -> list:
        """`CapturedFunction.report()` of this tracker's programs."""
        return [r for f in self.captured() for r in f.report()]

    def _fused_consume(self, aux, out, feats, host):
        """Host phase 2 of the fused path: association bookkeeping, stats,
        fallbacks, keyframe decision. `host` is the frame's packed control
        buffer (`fused_track.pack_control`) on the host. Call under
        map.update_lock."""
        from ceres_mono_orb_slam2_tpu_torch.models import fused_track

        t0, lf, local_kfs, slots, L, timestamp, ids_snap, _ = aux
        (R2, t2, m1_idx, m1v, inl1, n1, ninl1, m2_idx, m2v, visible,
         assoc, inl2, ninl2, h_valid) = fused_track.unpack_control(host, L)
        f = Frame(feats, self.cam, timestamp, lazy=True, j_und=out.und,
                  frame_id=next(self._frame_seq))
        self.current = f
        self._stat = {"frame_id": f.id, "timestamp": f.timestamp, "n_kp": int(h_valid.sum()),
                      "method": "fused", "local_kfs": len(local_kfs),
                      "local_points": int(len(slots)), "n1": n1,
                      "n_vis": int(visible[: len(slots)].sum()), "n_assoc": int(assoc.sum())}
        if n1 < 20 or ninl1 < 10:
            # motion-model failure: TrackReferenceKeyFrame fallback
            self._stat["method"] = "refkf"
            ok = self._track_reference_keyframe()
            if not ok:
                self._stat["method"] = "reloc"
                ok = self._relocalization()
            self._stat["inliers_frame"] = self.matches_inliers if ok else 0
            if ok:
                ok = self._track_local_map()
            self._stat["inliers_local"] = self.matches_inliers
            self._finish_track(ok, t0)
            return

        self.n_fused_frames += 1
        f.set_pose(R2, t2)
        f.mp_ids[:] = -1
        s_idx = np.nonzero(m1v)[0]
        j_idx = m1_idx[s_idx]
        keep = inl1[j_idx]
        f.mp_ids[j_idx[keep]] = lf.mp_ids[s_idx[keep]]
        stage1_ids = set(int(m) for m in f.mp_ids[f.mp_ids >= 0])
        rows2 = np.nonzero(m2v)[0]
        if len(rows2):
            ids2 = np.asarray(ids_snap[rows2], np.int64)
            # ids_snap is prepare-time state: with a mapper thread a fuse may
            # have replaced a point since; bind its replacement
            alive = self.map.mp_alive
            known = (ids2 >= 0) & (ids2 < len(alive))
            dead = ids2 >= 0
            dead[known] = ~alive[ids2[known]]
            for q in np.nonzero(dead)[0]:
                ids2[q] = self.map.resolve(int(ids2[q]))
            keep2 = ids2 >= 0
            f.mp_ids[m2_idx[rows2[keep2]]] = ids2[keep2]
        self._dedup_mp_ids(f.mp_ids)
        f.outlier = assoc & ~inl2

        # visibility / found statistics (SearchLocalPoints + Tracking.cc:694-706)
        mp_table = self.map.map_points
        for mid in stage1_ids:
            mp = mp_table.get(mid)
            if mp is not None and not mp.bad:
                mp.n_visible += 1
                mp.last_frame_seen = f.id
        for row in np.nonzero(visible[: len(slots)])[0]:
            mid = int(ids_snap[row])
            if mid < 0 or mid in stage1_ids:
                continue
            mp = mp_table.get(mid)
            if mp is not None and not mp.bad:
                mp.n_visible += 1
                mp.last_frame_seen = f.id
        for i in np.nonzero((f.mp_ids >= 0) & ~f.outlier)[0]:
            mp = mp_table.get(int(f.mp_ids[i]))
            if mp is not None and not mp.bad:
                mp.n_found += 1

        # reference keyframe = max shared count over the MOTION-MODEL stage's
        # bindings (UpdateLocalKeyFrames runs before SearchLocalPoints)
        counts = {}
        for mid in stage1_ids:
            mp = mp_table.get(int(mid))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.observations:
                counts[kf_id] = counts.get(kf_id, 0) + 1
        if counts:
            best = max(counts, key=counts.get)
            kf = self.map.keyframes.get(best)
            if kf is not None and not kf.bad:
                self.ref_kf_id = best

        self.matches_inliers = int(ninl2)
        self._stat["inliers_frame"] = ninl1
        self._stat["inliers_local"] = self.matches_inliers
        if f.id < self.last_reloc_frame_id + self.max_frames and self.matches_inliers < 50:
            ok = False
        else:
            ok = self.matches_inliers >= 30
        self._finish_track(ok, t0)

    # -------------------------------------------------------------- pipelined

    @staticmethod
    def _start_copies(ctl: torch.Tensor):
        """Start the device-to-host copy of a packed control buffer without
        waiting: on CUDA into a pinned tensor, with an event that the
        consume waits on; on the CPU the buffer already is on the host.
        Returns (host tensor, event or None)."""
        if ctl.device.type != "cuda":
            return ctl, None
        host = torch.empty(ctl.shape, dtype=ctl.dtype, pin_memory=True)
        host.copy_(ctl, non_blocking=True)
        done = torch.cuda.Event(blocking=True)  # see graphs.fetch
        done.record()
        return host, done

    def _guards(self) -> dict:
        """The map state a dispatched frame saw: a chain extends only while
        it is unchanged."""
        m = self.map
        return {"epoch": m.map_epoch, "nkf": m.n_keyframes(), "corr": m.correction_epoch}

    def _start_pipeline(self, image: np.ndarray, timestamp: float):
        """Pipeline (re)start from consumed host state: the dispatch a
        `_grab_fused` frame makes, left in flight with its control copy
        started."""
        t0 = time.perf_counter()
        with self.map.update_lock:
            args, aux = self._fused_prepare(image, timestamp)
            guards = self._guards()
            lf = aux[1]
            ppR, ppt = self._dev(lf.Rcw), self._dev(lf.tcw)
        out, feats, ctl, lblock = self._fused_dispatch(args)
        if self.graphs:  # the program's static block: the next replay overwrites it
            lblock = tuple(t.clone() for t in lblock)
        self._pending = dict(out=out, feats=feats, ctl=self._start_copies(ctl), image=image,
                             timestamp=timestamp, aux=aux, lblock=lblock, ppR=ppR, ppt=ppt,
                             disp_s=time.perf_counter() - t0, **guards)
        self._chain_len = 0

    def _dispatch_chained(self, image: np.ndarray, p: dict):
        """Frame k's fused step while frame k-1 (`p`) is in flight: the
        prediction is the constant-velocity composition of k-1's and k-2's
        poses on the device, the last-frame inputs are k-1's device outputs
        (`pos_kp`, `ok_next`, `next_local_row`), and the local block is the
        pipeline start's gather. Returns (out, feats, started copy)."""
        from ceres_mono_orb_slam2_tpu_torch.models import fused_track

        pout, pfeats = p["out"], p["feats"]
        last = (pfeats.octave, pfeats.angle, pfeats.desc)
        host_dummies = self._dummies(len(pout.ok_next))[0]
        one = host_dummies[-1]  # a chained frame searches the local map at radius 1
        if self.graphs:
            chain = (pout.R, pout.t, p["ppR"], p["ppt"], pout.pos_kp, pout.ok_next,
                     pout.next_local_row, one)
            out, f1, ctl = self._run_frontend(image, False, host_dummies, chain, last, p["lblock"])
            return out, f1, self._start_copies(ctl)
        R_pred, t_pred = fused_track.chained_prediction(pout.R, pout.t, p["ppR"], p["ppt"])
        feats = self.extractor.extract(image)
        f1 = type(feats)(*(a[0] for a in feats))
        out = self._ensure_fused_step()(
            f1.xy, f1.octave, f1.angle, f1.desc, f1.valid, *last,
            pout.pos_kp, pout.ok_next, pout.next_local_row, R_pred, t_pred, *p["lblock"],
            self.j_bounds, one)
        return out, f1, self._start_copies(fused_track.pack_control(out, f1.valid))

    def _consume_pending(self):
        """Wait for the in-flight frame's control copy and consume it (call
        under map.update_lock). Afterwards `current` and `last_frame` are
        that frame and nothing is in flight."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        if self._retrack_if_corrected(p["image"], p["timestamp"], p["corr"]):
            self.n_discarded_chained += 1
            return
        host, done = p["ctl"]
        if done is not None:
            done.synchronize()
        # `current` becomes this frame: keep `current_image` the same frame
        # (the newest image fed may be one ahead)
        self.current_image = p["image"]
        # forward ids a fuse replaced since the dispatch
        # (CheckReplacedInLastFrame, Tracking.cc:504-517)
        self._check_replaced_in_last_frame()
        # the local block's context is the pipeline start's; the rest is
        # this frame's own
        _, _, local_kfs, slots, L, _, ids_snap, corr = p["aux"]
        # track_ms = this frame's dispatch plus its consume, not the time it
        # spent in flight
        t0 = time.perf_counter() - p["disp_s"]
        self._fused_consume((t0, self.last_frame, local_kfs, slots, L, p["timestamp"], ids_snap, corr),
                            p["out"], p["feats"], host.numpy())
        self.last_frame = self.current

    def flush_pipeline(self):
        """Consume the in-flight frame, if any, so that the trajectory, the
        map and the stats are current."""
        with self.map.update_lock:
            self._consume_pending()

    def _track_serial(self, image: np.ndarray, timestamp: float):
        """One synchronous frame: the fused path, or an extraction without
        map.update_lock and tracking under it. The serial mode's frame, and
        the pipelined mode's frame that cannot chain or fuse."""
        self.current_image = image
        if self._can_fuse():
            self._grab_fused(image, timestamp)
        else:
            self.current = self.build_frame(image, timestamp)
            with self.map.update_lock:
                self._track()
        self.last_frame = self.current

    def _grab_pipelined(self, image: np.ndarray, timestamp: float):
        """Per-frame entry of the pipelined mode. Returns the Tcw of the
        last consumed frame: one frame late while a frame is in flight.
        Host phases hold map.update_lock; device dispatches do not."""
        m = self.map
        with m.update_lock:
            p = self._pending
            # the chain extends only while the map is as the in-flight frame
            # saw it (no point mutation, keyframe insertion or erasure, reset
            # or correction), outside localization mode and for at most 8
            # frames, since chained frames reuse the start's local block;
            # otherwise drain and restart from the host
            guards = self._guards()
            can_chain = (p is not None and not self.localization_only and not m.mp_dirty
                         and self._chain_len < 8 and guards == {k: p[k] for k in guards})
            if p is not None and not can_chain:
                self._consume_pending()
                p = None
        if p is None:
            if self._can_fuse():
                self._start_pipeline(image, timestamp)
            else:
                self._track_serial(image, timestamp)
            return self._last_T()

        t0 = time.perf_counter()
        out, feats, ctl = self._dispatch_chained(image, p)
        # guards as this frame was dispatched: a change after it (a keyframe
        # from the consume below, a mapper stage) breaks the chain next frame
        newp = dict(out=out, feats=feats, ctl=ctl, image=image, timestamp=timestamp,
                    aux=p["aux"], lblock=p["lblock"], ppR=p["out"].R, ppt=p["out"].t,
                    disp_s=time.perf_counter() - t0, **guards)
        with m.update_lock:
            self._consume_pending()  # frame k-1
            if self.state != State.OK or self._stat.get("method") != "fused":
                # frame k-1 was lost, reset or rescued by a fallback: the
                # outputs that frame k chained on were rejected; track k again
                self.n_discarded_chained += 1
                self.n_retracked_frames += 1
                self._track_serial(image, timestamp)
                return self._last_T()
        self.n_chained_frames += 1
        self._chain_len += 1
        self._pending = newp
        return self._last_T()

    # ------------------------------------------------------------------ track

    def _track(self):
        f = self.current
        t0 = time.perf_counter()
        self._stat = {"frame_id": f.id, "timestamp": f.timestamp,
                      "n_kp": int(f.kp_valid.sum()), "method": ""}
        if self.state == State.NO_IMAGES_YET:
            self.state = State.NOT_INITIALIZED
        if self.state == State.NOT_INITIALIZED:
            self._monocular_initialization()
            return
        ok = False
        if self.localization_only:
            ok = self._tracking_with_known_map()
        elif self.state == State.OK:
            self._check_replaced_in_last_frame()
            if self.velocity is not None:
                ok = self._track_with_motion_model()
                self._stat["method"] = "motion"
            if not ok:
                ok = self._track_reference_keyframe()
                self._stat["method"] = "refkf"
            if not ok:
                ok = self._relocalization()
                self._stat["method"] = "reloc"
        else:  # LOST
            ok = self._relocalization()
            self._stat["method"] = "reloc"
        self._stat["inliers_frame"] = self.matches_inliers if ok else 0
        # no local map while localization runs on visual odometry
        # (Tracking.cc:296-301)
        if ok and not (self.localization_only and self.do_vo):
            ok = self._track_local_map()
        self._stat["inliers_local"] = self.matches_inliers
        self._finish_track(ok, t0)

    def _finish_track(self, ok: bool, t0: float):
        """Shared tail of Track() (Tracking.cc:305-383): stats, state,
        velocity, outlier cleanup, keyframe decision, trajectory log, and
        the reset when tracking is lost right after initialization."""
        f = self.current
        self._stat["ok"] = bool(ok)
        self._stat["track_ms"] = (time.perf_counter() - t0) * 1e3
        self._stat["n_kfs"] = self.map.n_keyframes()
        self._stat["n_mps"] = len(self.map.map_points)
        self.frame_stats.append(self._stat)
        self.state = State.OK if ok else State.LOST
        if ok:
            if self.last_frame is not None and self.last_frame.pose_set:
                Rl, tl = self.last_frame.Rcw, self.last_frame.tcw
                Rv = f.Rcw @ Rl.T
                self.velocity = (Rv, f.tcw - Rv @ tl)
            f.mp_ids[f.outlier] = -1
            f.outlier[:] = False
            if not self.localization_only and self._need_new_keyframe():
                self._create_new_keyframe()
            self._log_trajectory(False)
        else:
            self.velocity = None
            if self.map.n_keyframes() <= 5:
                log.info("Track lost soon after initialisation, resetting")
                self.reset()
                return
            self._log_trajectory(True)

    def _log_trajectory(self, lost: bool):
        f = self.current
        if self.ref_kf_id is None:
            return
        kf = self.map.keyframes.get(self.ref_kf_id)
        if kf is None or not f.pose_set:
            if self.trajectory:
                prev = self.trajectory[-1]
                self.trajectory.append((prev[0], prev[1], prev[2], f.timestamp, True))
            return
        R_rel = f.Rcw @ kf.Rcw.T
        self.trajectory.append((kf.id, R_rel, f.tcw - R_rel @ kf.tcw, f.timestamp, lost))

    # ------------------------------------------------- monocular initialization

    def _monocular_initialization(self):
        f = self.current
        n_valid = int(f.kp_valid.sum())
        if self.init_ref is None or self.init_ref.kp_valid.sum() <= 100:
            if n_valid > 100:
                self.init_ref = f
            return
        if n_valid <= 100:
            self.init_ref = None
            return
        ref = self.init_ref
        attempt = self._two_view_attempt(ref, f)
        if attempt is None:
            self.init_ref = None
            return
        idx, res = attempt
        if not bool(res.success):
            return
        self._create_initial_map(ref, f, *graphs_mod.fetch(idx, res.triangulated, res.R21, res.t21,
                                                           res.points3d))

    def _two_view_attempt(self, ref: Frame, f: Frame):
        """One initialization attempt's device work: the bootstrap matcher,
        then (with at least 100 matches, read on the host between the two
        programs as in the JAX tracker) the two-view RANSAC. Returns (idx,
        `twoview.InitResult`), or None with too few matches."""
        programs = self._initializer_programs()
        args = (ref.j_und, ref.j_angle, ref.j_bits, ref.j_valid, ref.j_octave,
                f.j_und, f.j_angle, f.j_bits, f.j_valid, f.j_octave)
        if programs is None:
            idx, _, valid = matcher.search_for_initialization(*args, window=100.0)
        else:
            idx, _, valid = programs[0](*args)
        if int(valid.sum()) < 100:
            return None
        noise = self.uniform_noise((self.config.shapes.ransac_hypotheses, ref.n_kp))
        return idx, twoview.initialize_two_view(torch.as_tensor(noise, device=self.device), self.jK,
                                                ref.j_und, f.j_und[idx], valid,
                                                stages=programs and programs[1])

    def _create_initial_map(self, ref: Frame, cur: Frame, idx, tri, R21, t21, pts3d):
        """Reference CreateInitialMapMonocular (Tracking.cc:455-551)."""
        from ceres_mono_orb_slam2_tpu_torch.models.optimization import global_bundle_adjustment

        m = self.map
        ref.set_pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        cur.set_pose(R21, t21)
        kf1 = m.new_keyframe(ref)
        kf2 = m.new_keyframe(cur)
        m.keyframe_origins.append(kf1.id)
        for i in np.nonzero(tri)[0]:
            j = int(idx[i])
            mp = m.new_map_point(pts3d[i], cur.desc[j], kf2.id)
            m.add_observation(mp, kf1, int(i))
            m.add_observation(mp, kf2, j)
            m.compute_distinctive_descriptor(mp)
            m.update_normal_and_depth(mp, self.scale_factors)
            cur.mp_ids[j] = mp.id
        m.update_connections(kf1)
        m.update_connections(kf2)
        log.info("New Map created with %d points", m.n_map_points())

        # full BA on the 2-KF map (GlobalBundleAdjustemnt(map, 20))
        programs = self._initializer_programs()
        global_bundle_adjustment(m, self.config, n_iters=20, device=self.device,
                                 robust_step=programs and programs[2])

        # depth normalisation: median scene depth -> 1
        kf1_ = m.keyframes[kf1.id]
        depths = [(kf1_.Rcw @ mp.pos + kf1_.tcw)[2] for mp in
                  (m.get_mp(int(mid)) for mid in kf1_.mp_ids if mid >= 0) if mp is not None]
        median_depth = float(np.median(depths)) if depths else -1.0
        if median_depth < 0 or kf2.tracked_map_points(1, m) < 80:
            log.info("Wrong initialization, resetting")
            self.reset()
            return
        inv = 1.0 / median_depth
        kf2_ = m.keyframes[kf2.id]
        kf2_.tcw = (kf2_.tcw * inv).astype(np.float32)
        for mp in m.all_map_points():
            mp.pos = (mp.pos * inv).astype(np.float32)
            m.update_normal_and_depth(mp, self.scale_factors)
        cur.set_pose(kf2_.Rcw, kf2_.tcw)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf1.id)
            self.local_mapper.insert_keyframe(kf2.id)
        self.ref_kf_id = kf2.id
        self.last_kf_id = kf2.id
        self.init_ref = None
        self.state = State.OK

    # ------------------------------------------------------------ frame tracking

    @staticmethod
    def _dedup_mp_ids(mp_ids: np.ndarray):
        """Keep only the first slot of a duplicated map-point id."""
        seen = set()
        for i in np.nonzero(mp_ids >= 0)[0]:
            mid = int(mp_ids[i])
            if mid in seen:
                mp_ids[i] = -1
            else:
                seen.add(mid)

    def _check_replaced_in_last_frame(self):
        lf = self.last_frame
        for i in np.nonzero(lf.mp_ids >= 0)[0]:
            lf.mp_ids[i] = self.map.resolve(int(lf.mp_ids[i]))
        self._dedup_mp_ids(lf.mp_ids)

    def _gather_frame_points(self, frame: Frame):
        """Positions of the frame's live associated map points, aligned to
        keypoint slots (dead bindings are dropped): (pos (N,3), ok (N,))."""
        n = frame.n_kp
        pos = np.zeros((n, 3), np.float32)
        m = self.map
        bound = frame.mp_ids >= 0
        if len(m.mp_alive):
            safe = np.where(bound, frame.mp_ids, 0)
            ok = bound & (safe < len(m.mp_alive)) & m.mp_alive[np.minimum(safe, len(m.mp_alive) - 1)]
        else:
            ok = np.zeros(n, bool)
        frame.mp_ids[bound & ~ok] = -1
        pos[ok] = m.mp_pos[frame.mp_ids[ok]]
        return pos, ok

    def _pose_optimize(self, frame: Frame) -> int:
        pos, ok = self._gather_frame_points(frame)
        if ok.sum() < 3:
            return 0
        w = self.inv_sigma2[frame.kp_octave].astype(np.float32)
        res = self._solve_pose(self.jK, frame.Rcw, frame.tcw, pos, frame.j_und, w, ok)
        R, t, inl = graphs_mod.fetch(res.R, res.t, res.inliers)
        frame.set_pose(R, t)
        frame.outlier = ok & ~inl
        return int(inl.sum())

    def _update_last_frame(self):
        """Reference UpdateLastFrame (Tracking.cc:553-564): re-anchor the last
        frame on its reference keyframe, which local BA may have moved."""
        if not self.trajectory:
            return
        kf_id, R_rel, t_rel, _, _ = self.trajectory[-1]
        kf = self.map.keyframes.get(kf_id)
        if kf is None or kf.bad:
            return
        self.last_frame.set_pose(R_rel @ kf.Rcw, R_rel @ kf.tcw + t_rel)

    def _track_with_motion_model(self) -> bool:
        """Reference TrackWithMotionModel (Tracking.cc:617-671)."""
        f, lf = self.current, self.last_frame
        self._update_last_frame()
        Rv, tv = self.velocity
        f.set_pose(Rv @ lf.Rcw, Rv @ lf.tcw + tv)
        pos, ok = self._gather_frame_points(lf)
        if ok.sum() < 10:
            return False
        K = self.jK
        Xc = self._dev(pos) @ self._dev(f.Rcw).T + self._dev(f.tcw)
        z = Xc[:, 2].clamp_min(1e-6)
        pr_uv = torch.stack([K[0, 0] * Xc[:, 0] / z + K[0, 2], K[1, 1] * Xc[:, 1] / z + K[1, 2]], -1)
        pr_valid = self._dev(ok) & (Xc[:, 2] > 0)
        n = 0
        for th in (15.0, 30.0):  # retry wider (Tracking.cc:662-668)
            idx, _, valid = matcher.search_by_projection_frame(
                f.j_und, f.j_octave, f.j_angle, f.j_bits, f.j_valid,
                pr_uv, lf.j_octave, lf.j_angle, lf.j_bits, pr_valid, self.j_scale, th=th)
            idx, vi = graphs_mod.fetch(idx, valid)
            n = int(vi.sum())
            if n >= 20:
                break
        if n < 20:
            return False
        f.mp_ids[:] = -1
        f.mp_ids[idx[vi]] = lf.mp_ids[np.nonzero(vi)[0]]
        self._dedup_mp_ids(f.mp_ids)
        self.matches_inliers = self._pose_optimize(f)
        f.mp_ids[f.outlier] = -1
        f.outlier[:] = False
        if self.localization_only:
            # Tracking.cc:665-669: do_vo flags weak map tracking by inliers,
            # but the mode accepts the frame on the raw match count
            self.do_vo = self.matches_inliers < 10
            return n > 20
        return self.matches_inliers >= 10

    def _tracking_with_known_map(self) -> bool:
        """Reference TrackingWithKnownMap (Tracking.cc:185-236): the
        localization-mode state machine. Lost: relocalize. Otherwise the
        motion model (or the reference keyframe without a velocity), unless
        the last frame tracked too few map points (do_vo): then both the
        motion model and a relocalization, and a relocalization that
        succeeds wins and ends do_vo."""
        f = self.current
        if self.state == State.LOST:
            self._stat["method"] = "reloc"
            ok = self._relocalization()
            if ok:
                self.do_vo = False
            return ok
        if not self.do_vo:
            if self.velocity is not None:
                self._stat["method"] = "motion"
                return self._track_with_motion_model()
            self._stat["method"] = "refkf"
            return self._track_reference_keyframe()
        self._stat["method"] = "vo-dual"
        mm_ok, mm_state = False, None
        if self.velocity is not None:
            mm_ok = self._track_with_motion_model()
            mm_state = (f.Rcw.copy(), f.tcw.copy(), f.mp_ids.copy(), f.outlier.copy())
        reloc_ok = self._relocalization()
        if mm_ok and not reloc_ok:
            f.set_pose(mm_state[0], mm_state[1])
            f.mp_ids[:] = mm_state[2]
            f.outlier[:] = mm_state[3]
            for i in np.nonzero((f.mp_ids >= 0) & ~f.outlier)[0]:
                mp = self.map.get_mp(int(f.mp_ids[i]))
                if mp is not None:
                    mp.n_found += 1
        elif reloc_ok:
            self.do_vo = False
        return reloc_ok or mm_ok

    def _track_reference_keyframe(self) -> bool:
        """Reference TrackReferenceKeyFrame (Tracking.cc:566-607)."""
        f = self.current
        kf = self.map.keyframes.get(self.ref_kf_id)
        if kf is None or kf.bad:
            return False
        kf_has_mp = (kf.mp_ids >= 0) & kf.kp_valid
        idx, _, valid = matcher.search_by_descriptor(
            f.j_angle, f.j_bits, f.j_valid, self._dev(kf.kp_angle),
            matcher.unpack_u8(kf.desc, self.device), self._dev(kf_has_mp), ratio=0.7)
        idx, vi = graphs_mod.fetch(idx, valid)
        if int(vi.sum()) < 15:
            return False
        f.mp_ids[:] = -1
        f.mp_ids[vi] = kf.mp_ids[idx[vi]]
        if self.last_frame is not None and self.last_frame.pose_set:
            f.set_pose(self.last_frame.Rcw, self.last_frame.tcw)
        self.matches_inliers = self._pose_optimize(f)
        f.mp_ids[f.outlier] = -1
        f.outlier[:] = False
        return self.matches_inliers >= 10

    # -------------------------------------------------------------- local map

    def _local_keyframes(self, frame: Frame):
        """UpdateLocalKeyFrames (Tracking.cc:838-977): keyframes observing
        the frame's map points by shared count, expanded with one neighbour /
        child / parent per source keyframe, capped at 80."""
        counts = {}
        for mid in frame.mp_ids:
            if mid < 0:
                continue
            mp = self.map.get_mp(int(mid))
            if mp is None:
                continue
            for kf_id in mp.observations:
                counts[kf_id] = counts.get(kf_id, 0) + 1
        if not counts:
            return []
        local_kfs = []
        seen = set()
        for kf_id in sorted(counts, key=counts.get, reverse=True):
            kf = self.map.keyframes.get(kf_id)
            if kf is not None and not kf.bad:
                local_kfs.append(kf_id)
                seen.add(kf_id)
        for kf_id in list(local_kfs):
            if len(local_kfs) > 80:
                break
            kf = self.map.keyframes.get(kf_id)
            if kf is None:
                continue
            for nb in kf.best_covisible(10) + list(kf.children) + (
                    [kf.parent] if kf.parent is not None else []):
                if nb not in seen:
                    nkf = self.map.keyframes.get(nb)
                    if nkf is not None and not nkf.bad:
                        local_kfs.append(nb)
                        seen.add(nb)
                        break
        return local_kfs

    def _update_local_map(self):
        local_kfs = self._local_keyframes(self.current)
        if not local_kfs:
            return [], []
        self.ref_kf_id = local_kfs[0]
        mp_ids = []
        mp_seen = set()
        for kf_id in local_kfs:
            for mid in self.map.keyframes[kf_id].mp_ids:
                if mid >= 0 and mid not in mp_seen and self.map.get_mp(int(mid)) is not None:
                    mp_ids.append(int(mid))
                    mp_seen.add(mid)
        return local_kfs, mp_ids

    def _track_local_map(self) -> bool:
        """Reference TrackLocalMap (Tracking.cc:673-715) + SearchLocalPoints."""
        f = self.current
        local_kfs, mp_ids = self._update_local_map()
        if not mp_ids:
            return False
        in_frame = set(int(m) for m in f.mp_ids if m >= 0)
        cand = [m for m in mp_ids if m not in in_frame]
        for mid in in_frame:
            mp = self.map.get_mp(mid)
            if mp is not None:
                mp.n_visible += 1
                mp.last_frame_seen = f.id
        cap = self.config.shapes.max_local_points
        if len(cand) > cap and not getattr(self, "_warned_local_cap", False):
            self._warned_local_cap = True
            log.warning("local map truncated: %d candidate points > cap %d "
                        "(raise StaticShapes.max_local_points; warned once)", len(cand), cap)
        cand = cand[:cap]
        self._stat["local_kfs"] = len(local_kfs)
        self._stat["local_points"] = len(cand)
        if cand:
            ga = np.asarray(cand, np.int64)
            m = self.map
            uv, level, viewcos, visible = frustum.frustum_and_scale(
                self._dev(f.Rcw), self._dev(f.tcw), self.jK, self.j_bounds,
                self._dev(m.mp_pos[ga]), self._dev(m.mp_normal[ga]), self._dev(m.mp_mind[ga]),
                self._dev(m.mp_maxd[ga]), torch.ones(len(cand), dtype=torch.bool, device=self.device),
                self.log_scale, self.n_levels)
            for i in np.nonzero(graphs_mod.fetch(visible)[0])[0]:
                mp = self.map.map_points[cand[i]]
                mp.n_visible += 1
                mp.last_frame_seen = f.id
            th = 5.0 if self.current.id < self.last_reloc_frame_id + 2 else 1.0
            kp_free = self._dev(f.mp_ids < 0) & f.j_valid
            mp_bits = matcher.unpack_bits_pm1(self._dev(m.mp_desc[ga]))
            idx, _, valid = matcher.search_by_projection_points(
                f.j_und, f.j_octave, f.j_bits, f.j_valid, kp_free,
                uv, level, viewcos, mp_bits, visible, self.j_scale, th=th)
            ii, vi = graphs_mod.fetch(idx, valid)
            for q in np.nonzero(vi)[0]:
                f.mp_ids[ii[q]] = cand[q]

        self.matches_inliers = self._pose_optimize(f)
        inl = ~f.outlier
        for i in np.nonzero(f.mp_ids >= 0)[0]:
            mp = self.map.get_mp(int(f.mp_ids[i]))
            if mp is not None and inl[i]:
                mp.n_found += 1
        f.mp_ids[f.outlier] = -1
        f.outlier[:] = False
        if self.current.id < self.last_reloc_frame_id + self.max_frames and self.matches_inliers < 50:
            return False
        return self.matches_inliers >= 30

    # ------------------------------------------------------------ keyframe mgmt

    def _need_new_keyframe(self) -> bool:
        """Reference NeedNewKeyFrame (Tracking.cc:717-775), mono branch."""
        m = self.map
        n_kfs = m.n_keyframes()
        self.keyframe_wanted = False
        if self.current.id < self.last_reloc_frame_id + self.max_frames and n_kfs > self.max_frames:
            return False
        min_obs = 3 if n_kfs > 2 else 2
        ref_kf = m.keyframes.get(self.ref_kf_id)
        ref_matches = ref_kf.tracked_map_points(min_obs, m) if ref_kf else 0
        mapper_idle = self.local_mapper.accepting() if self.local_mapper else True
        c1a = self.current.id >= self.last_kf_frame_id() + self.max_frames
        c1b = self.current.id >= self.last_kf_frame_id() + self.min_frames and mapper_idle
        c2 = self.matches_inliers < ref_matches * 0.9 and self.matches_inliers > 15
        # a keyframe this frame would have made had the mapper been idle: a
        # threaded facade lets the mapper finish before the next frame
        # (`MonoSLAM.track_monocular`), instead of dropping it again
        self.keyframe_wanted = c2 and not mapper_idle
        if (c1a or c1b) and c2:
            if mapper_idle:
                return True
            if self.local_mapper is not None:
                self.local_mapper.interrupt_ba()
        return False

    def last_kf_frame_id(self) -> int:
        kf = self.map.keyframes.get(self.last_kf_id)
        return kf.frame_id if kf is not None else -(10 ** 9)

    def _create_new_keyframe(self):
        f = self.current
        kf = self.map.new_keyframe(f)
        for i in np.nonzero(f.mp_ids >= 0)[0]:
            mp = self.map.get_mp(int(f.mp_ids[i]))
            if mp is not None:
                self.map.add_observation(mp, kf, int(i))
        self.ref_kf_id = kf.id
        self.last_kf_id = kf.id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf.id)

    # ------------------------------------------------------------ relocalization

    def _project_candidates(self, f: Frame, cand_mp, th: float, dist_th: int):
        """Bind still-free keypoints of `f` to the candidate keyframe's map
        points `cand_mp` by projection under f's pose (window `th`, Hamming
        gate `dist_th`), skipping points the frame already holds."""
        ga = np.asarray(cand_mp, np.int64)
        Xc = self.map.mp_pos[ga] @ f.Rcw.T + f.tcw
        zok = Xc[:, 2] > 1e-6
        z = np.maximum(Xc[:, 2], 1e-6)
        uvp = np.stack([self.cam.fx * Xc[:, 0] / z + self.cam.cx,
                        self.cam.fy * Xc[:, 1] / z + self.cam.cy], -1).astype(np.float32)
        already = set(int(m) for m in f.mp_ids if m >= 0)
        fresh = np.array([m not in already for m in cand_mp])
        M = len(cand_mp)
        idx, _, valid = matcher.search_by_projection_frame(
            f.j_und, f.j_octave, f.j_angle, f.j_bits, f.j_valid & self._dev(f.mp_ids < 0),
            self._dev(uvp), torch.zeros(M, dtype=torch.int32, device=self.device),
            torch.zeros(M, dtype=torch.float32, device=self.device),
            matcher.unpack_u8(self.map.mp_desc[ga], self.device), self._dev(zok & fresh),
            self.j_scale, th=th, check_rotation=False, dist_th=dist_th)
        ii, vi = graphs_mod.fetch(idx, valid)
        for q in np.nonzero(vi)[0]:
            f.mp_ids[ii[q]] = cand_mp[q]

    def _reloc_pose_optimize(self, f: Frame) -> int:
        n_good = self._pose_optimize(f)
        f.mp_ids[f.outlier] = -1
        f.outlier[:] = False
        return n_good

    def _relocalization(self) -> bool:
        """Reference Relocalization (Tracking.cc:979-1137). Candidate
        keyframes come from the BoW database; RANSAC runs over all
        candidates in one batched call (the equivalent of the reference's
        `iterate(5)` round-robin across solvers: no candidate goes deep
        before every candidate has had its chance), then refinement visits
        the candidates in descending inlier order."""
        f = self.current
        if self.relocalizer is None:
            return False
        cand_ids = self.relocalizer.detect_relocalization_candidates(f)
        if not cand_ids:
            return False
        n = f.n_kp
        built = []  # (kf, pos, ok, ids) per viable candidate
        for kf_id in cand_ids:
            kf = self.map.keyframes.get(kf_id)
            if kf is None or kf.bad:
                continue
            kf_has_mp = (kf.mp_ids >= 0) & kf.kp_valid
            idx, _, valid = matcher.search_by_descriptor(
                f.j_angle, f.j_bits, f.j_valid, self._dev(kf.kp_angle),
                matcher.unpack_u8(kf.desc, self.device), self._dev(kf_has_mp), ratio=0.75)
            kidx, vi = graphs_mod.fetch(idx, valid)
            if vi.sum() < 15:
                continue
            # 2D-3D sets aligned to the current frame's keypoints
            pos = np.zeros((n, 3), np.float32)
            ok = np.zeros(n, bool)
            ids = np.full(n, -1, np.int64)
            for q in np.nonzero(vi)[0]:
                mp = self.map.get_mp(int(kf.mp_ids[kidx[q]]))
                if mp is not None:
                    pos[q] = mp.pos
                    ok[q] = True
                    ids[q] = mp.id
            if ok.sum() >= 15:
                built.append((kf, pos, ok, ids))
        if not built:
            return False

        built = built[:RELOC_MAX_CANDIDATES]
        C = len(built)
        w = self.inv_sigma2[f.kp_octave].astype(np.float32)
        # one shape a frame size, as the JAX tracker's: the candidates padded
        # to RELOC_MAX_CANDIDATES with rows that hold no valid point; the
        # draws are made at the actual count, then padded
        Cb = RELOC_MAX_CANDIDATES
        noise = torch.as_tensor(self.uniform_noise((C, RELOC_HYPOTHESES, n)), device=self.device)
        noise = torch.cat([noise, noise.new_zeros((Cb - C, RELOC_HYPOTHESES, n))])
        pos_b = np.zeros((Cb, n, 3), np.float32)
        ok_b = np.zeros((Cb, n), bool)
        for ci, (_, pos, ok, _) in enumerate(built):
            pos_b[ci], ok_b[ci] = pos, ok
        res = pnp.ransac_pnp_multi(
            noise, self.jK, self._dev(pos_b), f.j_und[None].expand(Cb, n, 2),
            self._dev(w)[None].expand(Cb, n), self._dev(ok_b), stages=self._ransac_stages())
        succ, Rs, ts, inls, ns = (a[:C] for a in graphs_mod.fetch(*res))
        for ci in np.argsort(-ns, kind="stable"):
            if not succ[ci]:
                continue
            kf, pos, ok, ids = built[ci]
            f.set_pose(Rs[ci], ts[ci])
            inl = inls[ci]
            f.mp_ids[:] = -1
            f.mp_ids[inl] = ids[inl]
            n_good = self._reloc_pose_optimize(f)
            if n_good >= 50:
                self.last_reloc_frame_id = f.id
                return True
            # widen with a projection search against this keyframe's map points
            cand_mp = [int(m) for m in kf.mp_ids if m >= 0 and self.map.get_mp(int(m)) is not None]
            if not cand_mp:
                continue
            self._project_candidates(f, cand_mp, th=10.0, dist_th=100)
            n_good = self._reloc_pose_optimize(f)
            if n_good >= 50:
                self.last_reloc_frame_id = f.id
                return True
            # narrow second pass (Tracking.cc:1095-1116): if the wide pass got
            # close (30 < nGood < 50), search again in a tight window (th=3)
            # under a strict descriptor gate (64) around the refined pose
            if 30 < n_good < 50:
                self._project_candidates(f, cand_mp, th=3.0, dist_th=64)
                n_good = self._reloc_pose_optimize(f)
                if n_good >= 50:
                    self.last_reloc_frame_id = f.id
                    return True
        return False

    # ------------------------------------------------------------------ reset

    def reset(self):
        """Reference Tracking::Reset (Tracking.cc:1139-1179)."""
        # an in-flight pipelined frame rode the old map
        self._pending = None
        self.map.clear()
        if self.local_mapper is not None:
            self.local_mapper.reset()
            # the reference reset protocol drains the loop thread too
            if self.local_mapper.loop_closer is not None:
                self.local_mapper.loop_closer.reset()
        if self.relocalizer is not None:
            self.relocalizer.clear()
        self.state = State.NOT_INITIALIZED
        self.last_frame = None
        self.velocity = None
        self.do_vo = False
        self.ref_kf_id = None
        self.init_ref = None
        self.last_kf_id = -1
        self.trajectory.clear()
        self.keyframe_wanted = False
        self.n_resets += 1

    def relocalize_next(self):
        """Make the next frame relocalize against the map, as after a lost
        frame: for a map that was loaded rather than built. Without it the
        next frame would start a monocular initialization inside the loaded
        map (the JAX package's `load_map` leaves its tracker so)."""
        self._pending = None
        self.state = State.LOST
        self.last_frame = None
        self.current = None
        self.velocity = None
        self.do_vo = False
        self.ref_kf_id = None
        self.init_ref = None
        self.last_kf_id = -1
        self.trajectory.clear()
