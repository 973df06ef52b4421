"""Integrated multi-stream SLAM: S complete systems, batched device stages.

Port of `ceres_mono_orb_slam2_tpu/parallel/multisystem.py`. Each stream is a
complete `MonoSLAM` (its own map, local mapping, loop closing,
relocalization) with per-stream host state, while the per-frame device work
of the streams goes through one set of launches:

- one extraction of the (S', H, W) image batch: one launch of each
  hand-written ORB kernel for all streams of the batch;
- each stream's local-map block gathered from its own pool and stacked;
- one batched fused step (`models/fused_track.FusedStep` with a leading
  stream axis): each stream's pose solves keep their own damping and freeze
  on their own convergence;
- one stacked upload of each small host input and ONE device-to-host copy of
  all streams' packed control buffers.

With `graphs=True` (the default) that device phase is one captured program
per number of batched streams S' (`utils/graphs.py`; no lane padding, so at
most one per S' <= S): the per-stream local-map gathers and the stacks of
the last frames' features write the program's static buffers before the
replay.

Streams that cannot fuse on a frame (initialising, LOST, fallback states)
take their ordinary single-stream path that frame; only the streams that can
fuse are batched (S' <= S, whatever lanes they are), and a lone one takes
the single-stream device phase.

With `threaded=True` every stream's `MonoSLAM` has its own mapper thread,
which each of its new keyframes wakes; the streams' trackers stay serial
(not pipelined): `track_batch` consumes each frame itself. A stream whose
map a loop correction or a global-BA apply rewrote during the batched device
phase tracks that frame again on its single-stream path
(`Tracking.n_retracked_frames`), so its extractions are its frames plus its
re-tracks.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models import fused_track
from ceres_mono_orb_slam2_tpu_torch.models.device_map import _pool_gather
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.utils import graphs as graphs_mod
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class MultiStreamSLAM:
    """S independent SLAM systems whose per-frame device work batches into
    single device calls. Host orchestration (covisibility graph, keyframe
    decisions, mapping, loop closure) stays per stream."""

    def __init__(self, config, n_streams: int, vocabulary=None,
                 vocabularies: Optional[list] = None, threaded: bool = False,
                 device=DEFAULT_DEVICE, graphs: bool = True):
        self.config = config
        self.n_streams = n_streams
        self.device = resolve_device(device)
        vocs = vocabularies if vocabularies is not None else [vocabulary] * n_streams
        self.streams: List[MonoSLAM] = [
            MonoSLAM(config, device=self.device, vocabulary=vocs[s], threaded=threaded, graphs=graphs)
            for s in range(n_streams)
        ]
        # all streams share one extractor and one fused step (same config,
        # same constant tables)
        self.extractor = self.streams[0].extractor
        self.fused_step = self.streams[0].tracker._ensure_fused_step()
        for s in self.streams:
            s.extractor = self.extractor
            s.tracker.extractor = self.extractor
            s.tracker._fused_step = self.fused_step
            # a pending in-flight frame would never be consumed in order by
            # track_batch's direct prepare / consume calls
            s.tracker.pipelined = False
        self.graphs = bool(graphs)
        # the batched device phase, captured per S' (its capture holds every
        # stream's map lock)
        self._frontend_fn = _batched_frontend(self.extractor, self.fused_step)
        self.program = graphs_mod.CapturedFunction(
            self._frontend_fn, self.device, name="batched_frontend",
            lock=lambda maps=[s.map for s in self.streams]: _holding(m.update_lock for m in maps))
        self.n_batched_frames = 0
        self.n_single_frames = 0
        # cumulative wall-time split of the batched frames (seconds): host
        # prepare (serial per stream), batched device dispatch, the blocking
        # control copy, host consume (serial per stream)
        self.phase_s = {"prepare": 0.0, "dispatch": 0.0, "fetch": 0.0,
                        "consume": 0.0, "frames": 0}

    # -------------------------------------------------------------- frontend

    def _batched_frontend(self, args: list):
        """The device phase of the streams whose `_fused_prepare` args are
        given: (out, feats, ctl) with a leading axis over those streams,
        `ctl` the packed control buffers on the host."""
        host = lambda k: torch.from_numpy(np.stack([a[k] for a in args]))  # noqa: E731
        slots = host(10).to(self.device)  # one upload of all streams' slots
        if self.graphs:
            # the gathers from the streams' pools (they differ) and the
            # stacks write the program's static buffers
            lblock = [graphs_mod.Fill(
                slots.shape + args[0][11].dev[i].shape[1:], args[0][11].dev[i].dtype,
                lambda dst, i=i: [torch.index_select(a[11].dev[i], 0, slots[k], out=dst[k])
                                  for k, a in enumerate(args)]) for i in range(6)]
            out, feats, packed = self.program(
                host(0), *(graphs_mod.stacked(a[k] for a in args) for k in (1, 2, 3)),
                *(host(k) for k in (4, 5, 6, 7, 8)), tuple(lblock), args[0][12], host(9))
        else:
            up = lambda k: host(k).to(self.device)  # noqa: E731
            # per-stream local-map gathers; the gathered L-blocks share shapes
            # and stack
            blocks = [_pool_gather(*a[11].dev, slots[k]) for k, a in enumerate(args)]
            lblock = [torch.stack([b[i] for b in blocks]) for i in range(6)]
            out, feats, packed = self._frontend_fn(
                up(0), *(torch.stack([a[k] for a in args]) for k in (1, 2, 3)),
                *(up(k) for k in (4, 5, 6, 7, 8)), lblock, args[0][12], up(9))
        t_fetch = time.perf_counter()
        return out, feats, graphs_mod.fetch(packed)[0], t_fetch

    # ----------------------------------------------------------------- track

    def track_batch(self, images, timestamps) -> list:
        """Track one frame on every stream. `images`: (S, H, W) array or
        list of S images; `timestamps`: list of S. Returns S entries of
        Tcw (4, 4) or None, exactly like S track_monocular calls."""
        S = self.n_streams
        assert len(images) == S and len(timestamps) == S
        # 8-bit entry like Tracking.grab_image
        images = [img if img.dtype == np.uint8
                  else np.clip(img + 0.5, 0.0, 255.0).astype(np.uint8)
                  for img in images]
        results = [None] * S

        t_p0 = time.perf_counter()
        preps = [None] * S
        for i, sysm in enumerate(self.streams):
            tr = sysm.tracker
            sysm._wait_for_wanted_keyframe()
            if tr._can_fuse() and tr.extractor is self.extractor:
                with sysm.map.update_lock:
                    preps[i] = tr._fused_prepare(images[i], timestamps[i])

        batch_idx = [i for i, p in enumerate(preps) if p is not None]
        if len(batch_idx) >= 2:
            self.n_batched_frames += 1
            t_d0 = time.perf_counter()
            out, feats, ctl, t_f0 = self._batched_frontend([preps[i][0] for i in batch_idx])
            t_c0 = time.perf_counter()
            for k, i in enumerate(batch_idx):
                sysm = self.streams[i]
                aux = preps[i][1]
                with sysm.map.update_lock:
                    # a correction on the stream's mapper or global-BA
                    # thread during the batch: the stream tracks this frame
                    # again on its own
                    if not sysm.tracker._retrack_if_corrected(images[i], timestamps[i], aux[-1]):
                        sysm.tracker._fused_consume(
                            aux, out.stream(k), type(feats)(*(a[k] for a in feats)), ctl[k])
                results[i] = self._finish_stream(i)
            t_c1 = time.perf_counter()
            ph = self.phase_s
            ph["prepare"] += t_d0 - t_p0
            ph["dispatch"] += t_f0 - t_d0
            ph["fetch"] += t_c0 - t_f0
            ph["consume"] += t_c1 - t_c0
            ph["frames"] += 1
        elif batch_idx:
            # lone fusable stream: its ordinary single-stream device phase
            i = batch_idx[0]
            sysm = self.streams[i]
            self.n_single_frames += 1
            with sysm.map.update_lock:
                sysm.tracker._fused_finish(*preps[i])
            results[i] = self._finish_stream(i)

        for i, sysm in enumerate(self.streams):
            if preps[i] is None:  # initialising / LOST / not fusable: normal path
                self.n_single_frames += 1
                results[i] = sysm.track_monocular(images[i], timestamps[i])
        return results

    def _finish_stream(self, i: int):
        """Post-track work and return value of MonoSLAM.track_monocular:
        the stream's mapping runs here, or on its mapper thread when
        threaded."""
        sysm = self.streams[i]
        sysm.tracker.last_frame = sysm.tracker.current
        sysm._map_after_frame()
        return sysm.tracker._last_T()

    def programs(self) -> list:
        """`CapturedFunction.report()` of the batched program per S'."""
        return self.program.report()

    def shutdown(self):
        for s in self.streams:
            s.shutdown()


def _batched_frontend(extractor, fused_step):
    """The batched device phase on its (S', ...) inputs: one extraction, the
    fused step with the stream axis, the packed control buffers."""
    def frontend(images, last_oct, last_angle, last_desc, last_pos, last_ok, last_local_row,
                 R_pred, t_pred, lblock, bounds, th_local):
        feats = extractor.extract(images)
        out = fused_step(feats.xy, feats.octave, feats.angle, feats.desc, feats.valid,
                         last_oct, last_angle, last_desc, last_pos, last_ok, last_local_row,
                         R_pred, t_pred, *lblock, bounds, th_local)
        return out, feats, fused_track.pack_control(out, feats.valid)

    return frontend


@contextlib.contextmanager
def _holding(locks):
    """Hold every lock of `locks`, taken in order."""
    with contextlib.ExitStack() as stack:
        for lock in locks:
            stack.enter_context(lock)
        yield
