"""Captures before frame 0: the port of the JAX package's `models/prewarm.py`.

A `CapturedFunction` (`utils/graphs.py`, the port's `jax.jit`) captures a
program at the first call of its key. Left to the live loop, that first call
stalls its frame: the spiral's first fused frame took 3.3-4.8 s on an H100,
about 0.1 s as a replay, and it holds `map.update_lock` for its capture, so
a threaded mapper's first pass waited 1.3-2.6 s for it as well. `prewarm(slam, h,
w)` calls once, on dummy inputs, each tracker program whose key the
configuration and the image size (h, w) fix, so that each captures then,
under the locks it takes in the live loop:

- the frontend (extraction with both kernels, the fused step and
  `pack_control`; one program serves serial and chained frames); a
  non-image extractor such as `utils/geosim.GeoExtractor` is never called
  (it draws its own noise): dummy features of its shapes stand in;
- a non-fused frame's extraction (an `ORBExtractor` only);
- the unfused pose solve at the extractor's N;
- relocalization's four RANSAC stages, padded to `RELOC_MAX_CANDIDATES`;
- the bootstrap matcher at N;
- with a loop closer, the Sim(3) refinement's LM iteration at N rows, on
  the mapper stream.

It first sets the image bounds of (h, w) and sizes and syncs the device map
pool. Left out, as the JAX module leaves loop closure's programs out: the
programs keyed by sizes that vary from frame to frame or map to map, which
the port solves at their actual size (it has no shape buckets): the
two-view RANSAC stages (the match count), the initial map's global BA, the
local BA windows, the essential graph and the global BA (the map's shape).

The results of the system do not change: no random generator draws (the
RANSAC noise is zeros), no `Frame` or `KeyFrame` is made (so no frame id is
taken), the map stays empty, the tracker waits for its first image and the
kernels' `launch_counts` are put back. Without graphs, and on the CPU, where
programs stage without capture, each function runs once.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.models.frame import undistorted_keypoints
from ceres_mono_orb_slam2_tpu_torch.models.tracking import (
    RELOC_HYPOTHESES, RELOC_MAX_CANDIDATES, State)
from ceres_mono_orb_slam2_tpu_torch.ops import matcher, pnp
from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import FrameFeatures, ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.utils import graphs

log = logging.getLogger(__name__)


def _dummy_features(n: int, device) -> FrameFeatures:
    """A batch of one frame of n invalid keypoints, in the dtypes and
    layouts an extractor returns."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros((1, n) + shape, dtype=dtype, device=device)

    return FrameFeatures(xy=z(2), response=z(), angle=z(), octave=z(dtype=torch.int32),
                         desc=z(32, dtype=torch.uint8), valid=z(dtype=torch.bool))


def prewarm(slam, h: int, w: int) -> dict:
    """Capture each program of `slam` whose key (h, w) and the configuration
    fix (see the module docstring). Returns {phase: seconds since the start,
    ..., "total_s": seconds}. Raises unless `slam` has seen no frame."""
    tr, m = slam.tracker, slam.map
    if tr.state is not State.NO_IMAGES_YET or tr.current is not None or m.n_keyframes():
        raise RuntimeError("prewarm: call it on a fresh MonoSLAM, before its first frame")
    device = tr.device
    t_start = time.perf_counter()
    done = {}

    def mark(name, stream=None):
        if device.type == "cuda":
            (stream or torch.cuda.current_stream(device)).synchronize()
        done[name] = time.perf_counter() - t_start
        log.info("prewarm %s: %.3f s", name, done[name])

    counts = dict(kernels.launch_counts)
    try:
        with m.update_lock:
            tr.set_image_size(h, w)
            pool = tr._ensure_pool()
            pool.sync()
        mark("pool")

        ex = tr.extractor
        image = np.zeros((h, w), np.uint8)
        if isinstance(ex, ORBExtractor):
            feats, stand_in = tr._extract(image), None
            mark("extract")
        else:
            feats = stand_in = _dummy_features(ex.n, device)
        f = type(feats)(*(a[0] for a in feats))
        n = int(f.xy.shape[0])

        if tr.fused_enabled:
            L = slam.config.shapes.max_local_points
            args = (image, f.octave, f.angle, f.desc, np.zeros((n, 3), np.float32), np.zeros(n, bool),
                    np.full(n, -1, np.int32), np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                    np.asarray(1.0, np.float32), np.full(L, pool.cap, np.int64), pool, tr.j_bounds)
            tr._fused_dispatch(args, feats=stand_in)
            mark("frontend")

        und = undistorted_keypoints(f.xy, tr.cam)
        weight = np.ones(n, np.float32)
        tr._solve_pose(tr.jK, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                       np.zeros((n, 3), np.float32), und, weight, np.zeros(n, bool))
        mark("pose_opt")

        C = RELOC_MAX_CANDIDATES
        pnp.ransac_pnp_multi(torch.zeros((C, RELOC_HYPOTHESES, n), device=device), tr.jK,
                             tr._dev(np.zeros((C, n, 3), np.float32)), und[None].expand(C, n, 2),
                             tr._dev(weight)[None].expand(C, n), tr._dev(np.zeros((C, n), bool)),
                             stages=tr._ransac_stages())
        mark("reloc")

        side = (und, f.angle, matcher.unpack_bits_pm1(f.desc), f.valid, f.octave)
        programs = tr._initializer_programs()
        if programs is None:
            matcher.search_for_initialization(*side, *side, window=100.0)
        else:
            programs[0](*side, *side)
        mark("init_match")

        lc = slam.loop_closer
        if lc is not None:
            with graphs.on_owner_stream(device, "mapper"):
                empty = tuple(np.zeros((0,) + shape, np.float32) for shape in ((3,), (3,), (2,), (2,), (), ()))
                lc.refine_sim3(empty, torch.eye(3, device=device), torch.zeros(3, device=device),
                               torch.ones((), device=device), rows=n)
                mark("sim3", graphs.owner_stream(device, "mapper"))
    finally:
        kernels.launch_counts.update(counts)
    done["total_s"] = time.perf_counter() - t_start
    log.info("prewarm done: %s", done)
    return done
