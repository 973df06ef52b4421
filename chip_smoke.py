"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels of `ceres_mono_orb_slam2_tpu_torch/csrc/` with
     nvcc (one process per source, started together; `graph_if.cu` is the
     IF node of `utils/graphs.run_if`, not a kernel of the table);
  2. hold each kernel bit-exact to its plain PyTorch version on packed
     pyramids: the 8-level KITTI 1241x376 pyramid at B=1 and B=8 and the
     8-level TUM 640x480 one at B=1, u8-valued and float pyramids, FAST
     margins 0 and EDGE, both patch sets, keypoints on the clamp edge; then
     on frame 0's own pyramid and keypoints (B=1) and on frames 0-7 as one
     batch (B=8), where each kernel and its plain version are timed
     (`time_ms`) beside the kernel's bound;
  3. solve one bundle-adjustment problem on the card twice and require
     bit-identical results;
  4. run the serial `MonoSLAM` over 60 rendered frames of the spiral ring
     world at 1241x376 with 2000 ORB features, asserting initialisation,
     tracking, mapping, exactly one launch of each kernel per frame and
     trajectory accuracy; every system of this and the later phases replays
     its captured programs (`utils/graphs.py`: the frontend, the pose solve,
     the batched step), and the kernel launches are counted through the
     replays;
     `[graphs]`: first the two streams' rules (`graphs_streams`: a captured
     call off its owner's stream raises, `graphs.fetch` gives the bits of
     `.cpu().numpy()`, a tensor handed to the mapper stream reads as
     written); then replay against eager in one process, each frame through a
     system with graphs and one with graphs=False in turn: every fused or
     chained frame's FusedOut fields, features and control buffer and every
     pose equal to the bit on the spiral's first 16 frames serial and
     pipelined, on 16 frames of the geometric strafe pipelined (it chains),
     on [reloc]'s frames 0-52 and a blinded tracker's relocalization (the
     captured pose solve) with its fused frame at th_local 5.0, and there
     every non-fused frame's features (the extraction program), BoW word
     ids, RANSAC result (its four stage programs) and unfused pose solve;
     the LM iterations each round of the fused frames', the unfused and
     the S=8 step's pose solves ran (`PoseOptResult.iters`: the pose
     solve's iterations are CUDA-graph IF nodes, skipped after
     convergence), and a replayed fused frame's device kernels fewer than
     an eager one's; a held start: the
     spiral's frame 0 shown 8 times, then its next frames until the map
     initialises and one more: every initialization attempt's matches and
     `InitResult` (the matcher's and the two-view RANSAC's programs), the
     initial map after its global BA (its LM iterations replayed) and every
     pose equal to the bit, the ms of one attempt (eager, replayed, first
     call), of the initial global BA, and the host API launches of one
     attempt both ways; one S=8
     `make_multistream_step`; the batched local BA (its LM iterations
     replayed under IF nodes on `done`) on batches A, B, A, C, D, E of 8
     windows (their index widths before and after the widening) and the
     loop closer's Sim(3) refinement (its LM iteration replayed at
     one padded row count) on two problems, each equal to op by op to the
     bit, A's second solve and the second refinement replayed; the median
     frame of both; one fused frame of
     each under torch.profiler: its host API launches (`cudaLaunchKernel`,
     `cudaGraphLaunch`) and copies, and its kernels on the card against the
     replay-counted launches; the memory of every program;
     `[threaded]`: the first 32 frames through `MonoSLAM(threaded=True)` fed
     at full rate (local mapping on the mapper thread and the mapper
     stream; a frame after one that wanted a keyframe busy local mapping
     could not take waits for it), the same bars, the mapper alive until
     `shutdown()`, the mean stage ms beside the serial run's; `[pipelined]`: with `pipelined=True` as well,
     paced by `wait_mapper_idle()` after each frame, a coverage check of
     chaining rather than the mode's full-rate traffic (at full rate the
     tracker inserts a keyframe whenever the mapper goes idle, so the map
     changes between every two frames and no frame chains): frames chain,
     and the kernels launch once per frame and once more per re-tracked
     frame; frame times of the three side by side;
  5. `[bow]`: a 1,111,111-node (10^6-word) vocabulary on the card, frame 0's
     descriptors through the tree on the card and on the CPU (equal word
     ids and node paths), the transform's time; a small vocabulary trained,
     written as ORBvoc text and parsed back;
  6. `[solvers]`: batched P3P RANSAC over 8 candidates x 2000 points, Horn
     Sim(3) RANSAC and refinement, the essential graph on a drifted ring of
     200 poses, and the matrix-free CG bundle adjustment (against the dense
     solver, and twice for bit-identical results), each on a seeded problem
     with a known answer; a non-fused frame's extraction
     (`Tracking.build_frame`), the RANSAC stages and the CG BA's LM
     iterations replayed as the system replays them, equal to their eager
     calls to the bit, each kernel counted once per extraction; RANSAC at 1
     and 3 live candidates padded to 8 as the tracker pads them, against
     the live candidates alone (equal success, inliers and counts, R and t
     within 1e-6); the two-view initializer on a pair padded to 4096 rows
     (the budget of nFeatures 2500: 32,768 cheirality matrices, twice
     what one call of cuSOLVER's batched eigensolver takes) eagerly and
     through its stage programs, equal to the bit; the chunked eigensolver
     against one call and other chunk sizes, and one call at 32,768
     matrices in a subprocess (refused, the limit the chunks answer);
  7. `[reloc]`: `MonoSLAM` with a trained vocabulary over 56 rendered
     640x480 frames of the ring world with frames 44-46 blacked out: LOST,
     then relocalized from pixels without a reset, one launch of each
     kernel per frame;
  8. `[loop]`: `MonoSLAM` with the geometric front end (2000 features a
     frame) over a closed 72-frame circle, twice: loop detected, corrected,
     essential graph and global BA run through the full system; the second
     run threaded, its global BA on the `gba` thread, paced by
     `wait_mapper_idle()` and a join of the `gba` thread after each frame,
     equal to the first to the bit; the Sim(3) refinements' row count and
     their program's captures and replays;
  9. `[multistream]`: `make_multistream_step` at 1241x376, 2000 features and
     4096 map points a stream on `synthetic_stream_state`, S=8 against each
     stream alone (counts equal, poses within a tolerance), the step's time
     and device launches at S=1 and S=8, one launch of each kernel a step;
     the batched local BA of 8 problems against 8 single solves, replayed
     and op by op (both timed, equal to the bit, captures and replays);
 10. `[multisystem]`: `MultiStreamSLAM` with 8 streams over 18 rendered
     1241x376 frames each, stream 0 the spiral of phase 4: its decisions
     equal to the serial run's and its camera centres within 1e-3 of it,
     every stream initialised, tracked and accurate, one launch of each
     kernel per batched frame, what the streams' initializer programs
     cost the tracker pool; then the same bars with `threaded=True` (a
     mapper thread per stream) over the first 9 frames;
 11. `[cli]`: the mono_slam CLI as a user runs it, in this process: 36
     frames of the strafe world rendered at 640x480 through the TUM2 lens
     and written as a TUM folder (PNGs from a stdlib-zlib writer, rgb.txt),
     a reference-format YAML config and an ORBvoc.txt trained on the
     sequence; run 1 `--threaded` over frames 0-35, run 2 `--load-map
     --localization` over a folder of frames 12-35 (a kidnapped restart in
     the mapped area): exit code 0, state OK, the four output files parsed,
     ATE of FrameTrajectory.txt under 1% (run 1) and 2% (run 2), run 2's
     first frame relocalized, every frame tracked, no keyframe added, one
     launch of each kernel per extraction; the host API launches of one
     localization frame, one fused frame and one relocalizing frame against
     the saved map with graphs and with graphs=False, a localization frame's extraction one
     replay of its program; the native decoder bit-exact
     against the plain one on the PNGs; `python -m ...cli --help` in a
     subprocess;
 12. `[viewer]`: the viewers as a user runs them, on [cli]'s strafe world
     (640x480, TUM2 lens, its config), `MonoSLAM(threaded=True)` at full
     rate: run A over 12 frames without viewers; run B with snapshots
     every 5 frames and the live HTTP viewer on a free port, polled by a
     client during the frames, then the menu (localization on and off,
     reset) and 6 frames that initialise again: the renders decode to their
     sizes, the toggles and the reset act, no render failed, no viewer
     thread and no open port after `shutdown()`; run C the CLI with
     `--viewer --live-viewer 0 --threaded` over 12 frames of a TUM folder;
     one launch of each kernel per extraction in each run; reports the
     renders' ms and run B's median frame over run A's;
 13. `[sharded]`: the multi-device half of `parallel/` on 4 ranks
     (`parallel/mesh.py` `spawn`; NCCL with a rank per card where 4 cards
     are visible, else gloo with all 4 on this card: every tensor of the
     solves lives on the card, only the collectives' bytes pass through host
     memory): `bundle_adjustment_cg_sharded` at KITTI map scale (1000 poses,
     100,000 points, 600,000 observations over a 4-way `obs` axis, 20 LM x
     50 CG) twice, bit-identical, its Huber cost below 0.1x the initial,
     within 1e-3 of the single-process solve on this card and its inliers
     within 0.1%; that single-process solve with its LM iterations
     replayed as the loop closer's CG global BA replays them, equal to the
     eager solve to the bit; `optimize_essential_graph_sharded` on a drifted ring of
     1000 poses against the single-process solve (R 5e-4, t 5e-3, s 1e-3),
     the ring closing; `shard_step_over_mesh` on a (2, 2) mesh over
     [multistream]'s inputs against the single-process S=8 step (counts
     equal, R 1e-5, t 1e-4), one launch of each kernel per rank and step;
     the transport's collectives, each solve's ms beside the single
     process's;
 14. print the card's name and power limit.
`python3 chip_smoke.py --only multistream,multisystem` (or `--only sharded`,
`--only graphs`) runs the build, the kernel checks, the spiral and the named
phases only (a quicker check while developing). The script prints its total
seconds.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

H, W, N_FRAMES = 376, 1241, 60  # the KITTI-width spiral sequence
# [threaded]'s frames of the spiral: 60 until the [viewer] phase came, which
# the cut to 40 paid for (with [multisystem]'s, below), 32 since the
# [sharded] phase
THREADED_FRAMES = 32
TUM_H, TUM_W = 480, 640  # the relocalization and loop sequences
# circle, step 0.0635; 104 frames (6.6 rad) until the [cli] phase came, which
# the cut to 64 paid for, and 56 since the [sharded] phase: 9 frames still
# follow the blackout
RELOC_FRAMES, RELOC_BLACKOUT = 56, (44, 45, 46)
# the loop's circle revisits after ~63 frames; a view holds ~9% of the ring's
# landmarks, so 24000 of them fill the 2000 keypoints of a frame
LOOP_FRAMES, LOOP_STEP, LOOP_LANDMARKS = 72, 0.1, 24000
# NVIDIA H100 SXM peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
SCORE_OPS = 118  # f32 min/max/sub of one FAST score in csrc/fast_nms.cu
NMS_OPS = 8  # f32 max/compare of one suppression

TIMING_CALLS = 50  # fn() calls captured back to back in one CUDA graph
TIMING_REPLAYS = 5
N_STREAMS = 8  # the multi-stream phases
# frames a stream of [multisystem]: 30 until the [viewer] phase came, 24 until
# the [sharded] phase came
MS_FRAMES = 18
# frames a stream of its threaded run: a batch frame there takes 6-9 s on any
# host (8 mapper threads and the tracker share one GIL), so 30 would add
# ~150 s to the script; 12 until the [cli] phase came, 9 since (a window of
# 5 batch frames from MS_STEADY)
MS_THREADED_FRAMES = 9
MS_STEADY = 4  # [multisystem]'s batch-frame times count from here (streams initialise by then)
JOIN_TIMEOUT_S = 600.0
MAP_POINTS = 4096  # map points a stream of the multi-stream step
# [cli]: a TUM-layout folder rendered through the reference's configs/TUM2.yaml
# lens (Freiburg2 Kinect), the strafe world; run 1 maps frames 0-35 (0-47
# until the [sharded] phase came), run 2 restarts kidnapped at frame 12 in
# localization mode over frames 12-35
TUM2_K = (520.908620, 521.007327, 325.141442, 249.701764)  # fx fy cx cy
TUM2_DIST = (0.231222, -0.784899, -0.003257, -0.000105, 0.917205)
CLI_FRAMES, CLI_MAP_FRAMES, CLI_LOC_FRAMES = 36, 36, range(12, 36)
CLI_STEP = 0.12
# [viewer]: [cli]'s world, lens and config, threaded at full rate; run A
# without the viewers, run B with both (a snapshot every VIEWER_EVERY
# frames, the live viewer polled by a client), then VIEWER_REINIT_FRAMES
# after a menu reset; run C the CLI with --viewer --live-viewer 0; runs A and
# B took 16 frames until the [sharded] phase came
VIEWER_FRAMES, VIEWER_REINIT_FRAMES, VIEWER_CLI_FRAMES, VIEWER_EVERY = 12, 6, 12, 5
RENDER_REPEATS = 10  # renders of each view timed after run B's frames
# [sharded]: 4 ranks (NCCL, one a card, where 4 cards are visible, else gloo
# on cuda:0); CG BA at the KITTI map scale `bundle_adjustment_cg` names
# (1000 poses, 100,000 points each seen by 6 poses: 600,000 observations),
# the essential graph on a ring of 1000 poses, the dp x mp step on
# [multistream]'s inputs
SHARDED_RANKS, SHARDED_POSES, SHARDED_POINTS, SHARDED_VIEWS = 4, 1000, 100_000, 6
SHARDED_RING = 1000
SHARDED_TIMEOUT_S = 400.0  # the ranks' collectives and the join of all of them
# [graphs]: replay against eager in one process: the spiral's first frames
# serial and pipelined, the geometric strafe pipelined (it chains), [reloc]'s
# frames up to and after the blackout then a blinded tracker's
# relocalization and its wide-radius fused frame, one S=8 batched step
GRAPH_FRAMES, GRAPH_GEO_FRAMES, GRAPH_RELOC_FRAMES = 16, 16, 53
# [graphs]' held start: the spiral's frame 0 shown this often (a camera
# held still before it moves: the tracker tries to initialise on every
# frame), then the spiral's next frames until the map initialises
HELD_FRAMES, HELD_MAX_FRAMES = 8, 12
# [solvers]' two-view initializer: a pair of TWO_VIEW_MATCHES matches padded
# to the extractor's budget of nFeatures 2500 (`_round_up_pow2`)
TWO_VIEW_ROWS, TWO_VIEW_MATCHES = 4096, 2500


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, calls: int = TIMING_CALLS, replays: int = TIMING_REPLAYS) -> float:
    """Device ms of one fn() call.

    After warm-up, `calls` calls of fn are captured back to back into one
    CUDA graph, so their outputs are allocated once, at capture, and no host
    work (Python, ctypes, allocation) sits between the launches. Each replay
    runs between one CUDA-event pair; the result is the median replay over
    `calls`. The inputs stay in the 50 MB L2 from one call to the next, as
    on the main path, where the extractor has just written the pyramid.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def phase_build():
    from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.load()._name
    log(f"[build] {path} nvcc {cuda_build.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")


def slam_config(h: int = H, w: int = W, max_local_points: int = 4096):
    from ceres_mono_orb_slam2_tpu_torch.utils.config import (
        CameraConfig, ORBConfig, SlamConfig, StaticShapes)

    return SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=w / 2.0, cy=h / 2.0, fps=30.0),
                      orb=ORBConfig(n_features=2000, n_levels=8, scale_factor=1.2,
                                    ini_th_fast=20, min_th_fast=7),
                      shapes=StaticShapes(max_local_points=max_local_points))


def random_pyramid(layout, B: int, integer: bool, g) -> torch.Tensor:
    if integer:
        return torch.randint(0, 256, (B, layout.total), device="cuda", generator=g).float()
    return torch.rand((B, layout.total), device="cuda", generator=g) * 255.0


def random_keypoints(layout, counts, B: int, g):
    """Level-major (B, N) int32 centres: per level the 4 level corners (their
    patches clamp on two sides), then random ones inside the EDGE margin."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.kernels import EDGE

    ys, xs = [], []
    for (h, w), n in zip(layout.shapes, counts):
        y = torch.randint(EDGE, h - EDGE, (B, n), device="cuda", generator=g)
        x = torch.randint(EDGE, w - EDGE, (B, n), device="cuda", generator=g)
        m = min(n, 4)
        y[:, :m] = torch.tensor([0, 0, h - 1, h - 1][:m], device="cuda")
        x[:, :m] = torch.tensor([0, w - 1, 0, w - 1][:m], device="cuda")
        ys.append(y)
        xs.append(x)
    return (torch.cat(ys, 1).to(torch.int32).contiguous(),
            torch.cat(xs, 1).to(torch.int32).contiguous())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, where: str) -> float:
    """Max |got - want|, raising unless the two are equal (tolerance 0)."""
    e = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version at {where}: max err {e}")
    return e


def bound(n_bytes: float, n_ops: float):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fast_nms_work(layout, B: int, edge: int):
    """(bytes, ops) of fast_nms_pyramid with margin `edge`: one FAST score
    for every pixel that an output outside the margin reads (rows and
    columns edge-1 .. size-edge) and one suppression for every such output;
    the pixels those scores read (edge-4 .. size-edge+3, every pixel at
    edge 0) read once, and the whole output written once."""
    def band(pad: int) -> int:  # pixels per frame within size - 2 * edge + pad
        return sum(max(min(h, h - 2 * edge + pad), 0) * max(min(w, w - 2 * edge + pad), 0)
                   for h, w in layout.shapes)

    return 4 * B * (band(8) + layout.total), B * (SCORE_OPS * band(2) + NMS_OPS * band(0))


def gather_work(layout, ys: torch.Tensor, xs: torch.Tensor, counts):
    """(bytes, ops) of gather_pyramid_patches on these keypoints: the
    distinct pyramid pixels the patches cover (each read once), the centres,
    and both outputs written once (31x31 float32, 39x39 uint8); a bf16
    rounding per value, and to_u8's add and clamp per 39x39 value."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.kernels import DESC_R, HALF_PATCH

    B, N = ys.shape
    b = torch.arange(B, device=ys.device)[:, None]
    covered, start = 0, 0
    for (h, w), n in zip(layout.shapes, counts):
        centres = torch.zeros((B, 1, h, w), device=ys.device)
        centres[b, 0, ys[:, start:start + n].long(), xs[:, start:start + n].long()] = 1.0
        for r in (HALF_PATCH, DESC_R):
            covered += int((F.max_pool2d(centres, 2 * r + 1, stride=1, padding=r) > 0).sum())
        start += n
    s31, s39 = (2 * HALF_PATCH + 1) ** 2, (2 * DESC_R + 1) ** 2
    return 4 * covered + 8 * B * N + B * N * (4 * s31 + s39), B * N * (s31 + 4 * s39)


def phase_kernels(seq, cfg):
    """Bit-exact checks of both kernels on packed pyramids, then their
    main-path times on frame 0 (B=1) and on frames 0-7 as one batch (B=8),
    beside their bounds. Returns the per-kernel JSON rows: the B=1 numbers
    under the contract's keys, the B=8 ones under "b8"."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor, _level_sizes
    from ceres_mono_orb_slam2_tpu_torch.utils.config import ORBConfig

    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"fast_nms": 0.0, "gather_patches": 0.0}
    kitti = k.PyramidLayout.of(_level_sizes(H, W, 8, 1.2))
    tum = k.PyramidLayout.of(_level_sizes(480, 640, 8, 1.2))
    kitti_n = [int(n) for n in cfg.orb.features_per_level]
    tum_n = [int(n) for n in ORBConfig(n_features=1000).features_per_level]
    for name, layout, counts, B in (("KITTI 1241x376", kitti, kitti_n, 1),
                                    ("KITTI 1241x376", kitti, kitti_n, 8),
                                    ("TUM 640x480", tum, tum_n, 1)):
        for integer in (True, False):
            raw = random_pyramid(layout, B, integer, g)
            blurred = random_pyramid(layout, B, integer, g)
            where = f"{name} B={B} {'u8-valued' if integer else 'float'}"
            for edge in (0, k.EDGE):
                err["fast_nms"] = max(err["fast_nms"], check_equal(
                    "fast_nms", k.fast_nms_pyramid(raw, layout, edge),
                    k.fast_nms_pyramid_plain(raw, layout, edge), f"{where} edge={edge}"))
            ys, xs = random_keypoints(layout, counts, B, g)
            got = k.gather_pyramid_patches(raw, blurred, layout, ys, xs, counts)
            want = k.gather_pyramid_patches_plain(raw, blurred, layout, ys, xs, counts)
            for a, b, r in zip(got, want, (k.HALF_PATCH, k.DESC_R)):
                err["gather_patches"] = max(err["gather_patches"],
                                            check_equal(f"gather_patches r={r}", a, b, where))
        log(f"[kernels] {name} B={B}, {len(layout.shapes)} levels, N={sum(counts)}: fast_nms "
            f"(edge 0 and {k.EDGE}) and gather_patches (r=15 float32, r=19 uint8, corner "
            f"keypoints clamped) bit-exact on u8-valued and float pyramids (torch.equal)")
    # the one-level calls of both kernels
    img = random_pyramid(kitti, 2, False, g)[:, :H * W].reshape(2, H, W).contiguous()
    one = k.PyramidLayout.of([(H, W)])
    ys, xs = random_keypoints(one, [300], 2, g)
    check_equal("fast_nms", k.fast_nms(img), k.nms3(k.fast_score_map(img)), "one level")
    for r in (k.HALF_PATCH, k.DESC_R):
        check_equal(f"gather_patches r={r}", k.gather_patches(img, ys, xs, r),
                    k.gather_patches_plain(img, ys, xs, r), "one level")
    log(f"[kernels] one-level fast_nms and gather_patches (r=15, 19) at 2x{H}x{W}: bit-exact")

    # the main path's inputs: frame 0's packed pyramid and its keypoints
    # (B=1, the serial path), and frames 0-7 as one batch (B=8, the
    # multi-stream path)
    ex = ORBExtractor(cfg.orb, device="cuda")
    frames = np.clip(seq.images[:N_STREAMS] + 0.5, 0.0, 255.0).astype(np.uint8)
    measured = {}
    for B in (1, N_STREAMS):
        layout, raw, blurred = ex.pyramid(torch.from_numpy(frames[:B]).cuda().float())
        ys, xs, _, valid, counts = ex.detect(raw, layout)
        ys = torch.where(valid, ys, k.EDGE).to(torch.int32).contiguous()
        xs = torch.where(valid, xs, k.EDGE).to(torch.int32).contiguous()
        fast = (lambda: k.fast_nms_pyramid(raw, layout, k.EDGE),
                lambda: k.fast_nms_pyramid_plain(raw, layout, k.EDGE))
        gather = (lambda: k.gather_pyramid_patches(raw, blurred, layout, ys, xs, counts),
                  lambda: k.gather_pyramid_patches_plain(raw, blurred, layout, ys, xs, counts))
        check_equal("fast_nms", fast[0](), fast[1](), f"frames 0-{B - 1}")
        for a, b in zip(gather[0](), gather[1]()):
            check_equal("gather_patches", a, b, f"frames 0-{B - 1}")
        torch.cuda.synchronize()
        for name, fns, work in (("fast_nms", fast, fast_nms_work(layout, B, k.EDGE)),
                                ("gather_patches", gather, gather_work(layout, ys, xs, counts))):
            ms, plain_ms = time_ms(fns[0]), time_ms(fns[1])
            bound_ms, bound_by = bound(*work)
            measured[name, B] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "share": bound_ms / ms, "bytes": work[0]}
            log(f"[kernels] {name}, frames 0-{B - 1} (B={B}, 8 levels, {int(valid.sum())} keypoints): "
                f"{ms * 1e3:.2f} us per launch, {ms * 1e3 / B:.2f} us per frame (plain {plain_ms * 1e3:.2f} "
                f"us); bound {bound_ms * 1e3:.2f} us by {bound_by} ({work[0] / 1e6:.3f} MB, "
                f"{work[1] / 1e9:.4f} GOP), share {bound_ms / ms:.3f}")
    rows = []
    for name, line in (("fast_nms", 75), ("gather_patches", 270)):
        one = measured[name, 1]
        rows.append({"name": name, "route": "cuda",
                     "source": f"ceres_mono_orb_slam2_tpu_torch/csrc/{name}.cu",
                     "replaces": f"ceres_mono_orb_slam2_tpu/ops/orb/kernels.py:{line}",
                     "max_abs_err": err[name], "ms": one["ms"], "plain_ms": one["plain_ms"],
                     "bound_ms": one["bound_ms"], "bound_by": one["bound_by"], "share": one["share"],
                     "library_ms": None, f"b{N_STREAMS}": measured[name, N_STREAMS]})
    return rows


def ba_problem(seed: int = 0, P: int = 20, M: int = 3000, per_point: int = 4):
    """A local-BA-sized problem on the card: P poses along a line, M points
    seen by `per_point` poses each, pixel noise and 2% gross outliers."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 620.0], [0, 500.0, 188.0], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-6, 6, M), rng.uniform(-2, 2, M), rng.uniform(6, 20, M)], -1)
    R = np.repeat(np.eye(3)[None], P, 0)
    t = np.stack([-0.3 * np.arange(P), np.zeros(P), np.zeros(P)], -1)
    op = np.stack([rng.choice(P, per_point, replace=False) for _ in range(M)]).reshape(-1)
    oj = np.repeat(np.arange(M), per_point)
    Xc = pts[oj] + t[op]
    uv = K[:2, :2].diagonal() * Xc[:, :2] / Xc[:, 2:] + K[:2, 2]
    uv += rng.standard_normal(uv.shape) * 0.7
    bad = rng.random(len(uv)) < 0.02
    uv[bad] += rng.uniform(20, 60, (bad.sum(), 2))
    t0 = t + rng.standard_normal(t.shape) * 0.02
    t0[:2] = t[:2]
    fixed = np.zeros(P, bool)
    fixed[:2] = True
    dev = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")  # noqa: E731
    return (dev(K), dev(R), dev(t0), dev(pts + rng.standard_normal(pts.shape) * 0.05),
            dev(op, torch.int64), dev(oj, torch.int64), dev(uv), dev(rng.choice([1.0, 0.69], len(op))),
            dev(np.ones(len(op), bool), torch.bool), dev(fixed, torch.bool),
            dev(np.ones(M, bool), torch.bool))


def phase_ba():
    """Bundle adjustment twice on one CUDA problem: bit-identical results."""
    from ceres_mono_orb_slam2_tpu_torch.ops import optim

    args = ba_problem()
    runs = [optim.bundle_adjustment(*args) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"[ba] P={args[1].shape[0]} M={args[3].shape[0]} O={args[4].shape[0]}: cost "
        f"{float(runs[0].cost):.6f} / {float(runs[1].cost):.6f}, inliers "
        f"{int(runs[0].inlier_obs.sum())}, two calls bit-identical: {same}")
    if not same:
        raise AssertionError("bundle_adjustment is not deterministic on the card")


def render_sequence():
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence

    t0 = time.perf_counter()
    seq = make_rendered_sequence(N_FRAMES, H, W, 500.0, 500.0, motion="spiral", step=0.06,
                                 seed=11, device="cuda")
    log(f"[slam] rendered {N_FRAMES} frames {W}x{H} in {time.perf_counter() - t0:.1f} s")
    return seq


def phase_slam(seq, cfg):
    """The serial MonoSLAM over the 60 rendered KITTI-width frames."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    n_frames = N_FRAMES
    # the extractor's CUDA path against its CPU path on the first frame
    fc = ORBExtractor(cfg.orb, device="cuda").extract(seq.images[0])
    fh = ORBExtractor(cfg.orb, device="cpu").extract(seq.images[0])
    fc = [a.cpu() for a in fc]
    l0 = fh.octave[0] == 0
    if not (torch.equal(fc[0][0][l0], fh.xy[0][l0]) and torch.equal(fc[4][0][l0], fh.desc[0][l0])):
        raise AssertionError("extractor: level-0 keypoints/descriptors differ between CUDA and CPU")
    same = (fc[0] == fh.xy).all(-1) & (fc[4] == fh.desc).all(-1)
    log(f"[slam] extractor CUDA vs CPU on frame 0: level 0 bit-exact, "
        f"{float(same.float().mean()) * 100:.2f}% of all keypoints identical")

    slam = MonoSLAM(cfg, device="cuda")
    k.reset_launch_counts()
    poses, frame_ms = [], []
    for i in range(n_frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        poses.append(slam.track_monocular(seq.images[i], float(seq.timestamps[i])))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(k.launch_counts)

    tracked = [p is not None for p in poses]
    first = tracked.index(True) if any(tracked) else n_frames
    est, gt = [], []
    for i, T in enumerate(poses):
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(seq.gt_centers()[i])
    est, gt = np.asarray(est), np.asarray(gt)
    traj_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()) if len(gt) > 1 else 0.0
    ate_pct = 100.0 * ate_rmse(est, gt) / traj_len if traj_len > 0 else float("inf")
    n_after = n_frames - first
    frac = sum(tracked[first:]) / max(n_after, 1)
    steady = np.asarray(frame_ms[10:])
    log(f"[slam] init frame {first}, tracked {sum(tracked)}/{n_frames} "
        f"({100 * frac:.1f}% after init), keyframes {slam.map.n_keyframes()}, "
        f"map points {slam.map.n_map_points()}, n_local_ba {slam.local_mapper.n_local_ba}, "
        f"n_fused_frames {slam.tracker.n_fused_frames}, launches {launches}")
    log(f"[slam] ATE {ate_pct:.4f}% of {traj_len:.3f} m; per-frame ms (frames 10+): "
        f"median {np.median(steady):.2f}, p95 {np.percentile(steady, 95):.2f}, "
        f"max {steady.max():.2f}")
    # bit-level fingerprints, to compare runs of the same code
    log(f"[slam] repeat check: ATE {ate_pct!r} %, sum of camera centres {float(est.sum())!r}")
    checks = {
        "initialises within 10 frames": first < 10,
        "tracks >= 90% after init": frac >= 0.9,
        ">= 3 keyframes": slam.map.n_keyframes() >= 3,
        "n_local_ba >= 1": slam.local_mapper.n_local_ba >= 1,
        "n_fused_frames > 0": slam.tracker.n_fused_frames > 0,
        "fast_nms launched once per frame": launches["fast_nms"] == n_frames,
        "gather_patches launched once per frame": launches["gather_patches"] == n_frames,
        "ATE < 1% of trajectory": ate_pct < 1.0,
        "finite poses": all(np.isfinite(T).all() for T in poses if T is not None),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slam checks failed: {failed}")
    timing = {"median": float(np.median(steady)), "p95": float(np.percentile(steady, 95)),
              "frame_ms": frame_ms, "stage_ms": stage_means([slam.local_mapper]),
              "stage_ms_after_first": stage_means([slam.local_mapper], skip=1)}
    return launches, poses, timing


def phase_concurrent(seq, cfg, serial: dict, pipelined: bool):
    """The spiral of phase 4 (its first THREADED_FRAMES frames) through
    `MonoSLAM(threaded=True)` fed at full rate, or all of it with
    `pipelined=True` as well and paced by `wait_mapper_idle()`
    after each frame (a coverage check: at full rate no frame chains), then
    `shutdown()`: phase 4's bars, the mapper thread
    alive until shutdown, and for the pipelined mode chained frames and one
    launch of each kernel per frame plus one per re-tracked frame. A frame's
    time is the host's wall time of its `track_monocular` call (the pose is
    on the host when it returns); the whole run's wall time includes the
    pacing and the drain at shutdown."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    name = "pipelined" if pipelined else "threaded"
    n = N_FRAMES if pipelined else THREADED_FRAMES
    slam = MonoSLAM(cfg, device="cuda", threaded=True, pipelined=pipelined)
    if not pipelined:  # as a user's loop prewarms before its frame 0
        phases, ms = timed(lambda: slam.prewarm(*seq.images.shape[-2:]))
        log(f"[{name}] prewarm {ms:.1f} ms, phases (s since its start) "
            f"{ {key: round(v, 3) for key, v in phases.items()} }")
    torch.cuda.synchronize()
    k.reset_launch_counts()
    poses, frame_ms = [], []
    t_run = time.perf_counter()
    for i in range(n):
        t = time.perf_counter()
        poses.append(slam.track_monocular(seq.images[i], float(seq.timestamps[i])))
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if pipelined and not slam.wait_mapper_idle(timeout=JOIN_TIMEOUT_S):
            raise AssertionError("[pipelined] the mapper thread did not go idle")
    alive = slam._worker.is_alive()
    slam.shutdown()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_run
    launches = dict(k.launch_counts)
    tr, lm = slam.tracker, slam.local_mapper
    n_extractions = n + tr.n_retracked_frames  # each re-tracked frame extracts again

    if pipelined:  # poses return a frame late: read the drained log
        ts, est = slam.get_frame_trajectory()
        frame_of = {float(t): i for i, t in enumerate(seq.timestamps)}
        idx = [frame_of[float(t)] for t in ts]
    else:
        idx = [i for i, T in enumerate(poses) if T is not None]
        est = np.asarray([-T[:3, :3].T @ T[:3, 3] for T in poses if T is not None])
    first = min(idx) if idx else n
    frac = len(idx) / max(n - first, 1)
    gt = seq.gt_centers()[idx]
    traj_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()) if len(gt) > 1 else 0.0
    ate_pct = 100.0 * ate_rmse(est, gt) / traj_len if traj_len > 0 else float("inf")
    steady = np.asarray(frame_ms[10:])
    serial_steady = np.asarray(serial["frame_ms"][10:n])
    serial_s = sum(serial["frame_ms"][:n]) / 1e3
    stage_ms = stage_means([lm])
    mapping_s = sum(sum(v for key, v in p.items() if key != "kf") for p in lm.pass_ms) / 1e3
    log(f"[{name}] init frame {first}, tracked {len(idx)}/{n} ({100 * frac:.1f}% after init), "
        f"keyframes {slam.map.n_keyframes()}, map points {slam.map.n_map_points()}, n_local_ba "
        f"{lm.n_local_ba}, n_ba_aborted {lm.n_ba_aborted}, n_fused_frames {tr.n_fused_frames}, "
        f"n_chained_frames {tr.n_chained_frames}, n_discarded_chained {tr.n_discarded_chained}, "
        f"n_retracked_frames {tr.n_retracked_frames}, launches {launches} over {n_extractions} "
        f"extractions")
    log(f"[{name}] ATE {ate_pct:.4f}% of {traj_len:.3f} m (repeat check: ATE {ate_pct!r} %, sum of camera "
        f"centres {float(est.sum())!r}); per-frame ms (frames 10+): median {np.median(steady):.2f}, p95 "
        f"{np.percentile(steady, 95):.2f}, max {steady.max():.2f} beside the serial run's median "
        f"{np.median(serial_steady):.2f}, p95 {np.percentile(serial_steady, 95):.2f}; "
        f"{'' if pipelined else f'first fused frame {first_fused_ms(slam, seq.timestamps, frame_ms):.1f} ms; '}"
        f"whole run "
        f"{total_s:.2f} s with {'the pacing and ' if pipelined else ''}the drain at shutdown beside the "
        f"serial run's {serial_s:.2f} s")
    log(f"[{name}] mapper: {len(lm.pass_ms)} passes, {mapping_s:.2f} s in all, mean stage ms "
        f"{stage_ms} beside the serial run's {serial['stage_ms']} (same call), after the first pass "
        f"{stage_means([lm], skip=1)} beside {serial['stage_ms_after_first']}, on the "
        f"{mapper_stream_name()}; frames that waited for local mapping {slam.n_keyframe_waits}, longest "
        f"wait {slam.max_keyframe_wait_ms:.1f} ms; the mapper's programs (captures, replays on the mapper "
        f"stream, kept, dropped, shared pool MB) {program_summaries(slam)}")
    checks = {
        "initialises within 10 frames": first < 10,
        "tracks >= 90% after init": frac >= 0.9,
        ">= 3 keyframes": slam.map.n_keyframes() >= 3,
        "n_local_ba >= 1": lm.n_local_ba >= 1,
        "the mapper thread alive until shutdown": alive,
        "the mapper thread stopped at shutdown": not slam._worker.is_alive(),
        "fast_nms launched once per extraction": launches["fast_nms"] == n_extractions,
        "gather_patches launched once per extraction": launches["gather_patches"] == n_extractions,
        "ATE < 1% of trajectory": ate_pct < 1.0,
        "finite poses": all(np.isfinite(T).all() for T in poses if T is not None),
    }
    if pipelined:
        checks["n_chained_frames > 0"] = tr.n_chained_frames > 0
        checks["pipeline drained"] = tr._pending is None
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} checks failed: {failed}")
    return launches, n_extractions


def timed(fn):
    """(result, ms) of fn(), on the host's clock around work that ends in a
    synchronisation of the current stream and of the mapper stream, the two
    streams on which the port queues all its work (the tracker's on the
    default stream, the mapper's on its own; their side streams join
    them). Not the whole device: a threaded system's mapper may be
    capturing a program meanwhile, and a device-wide synchronisation from
    another thread invalidates a capture."""
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    mapper = graphs.owner_stream("cuda", "mapper")
    torch.cuda.current_stream().synchronize()
    mapper.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.current_stream().synchronize()
    mapper.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def on_mapper_stream(fn):
    """fn() on the mapper stream, as the loop closer runs its programs
    there, after the current stream's queued work and before its next."""
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    current, mapper = torch.cuda.current_stream(), graphs.owner_stream("cuda", "mapper")
    mapper.wait_stream(current)
    with torch.cuda.stream(mapper):
        out = fn()
    current.wait_stream(mapper)
    return out


STAGES = ("process_new", "cull_mp", "triangulate", "fuse", "lba", "cull_kf")


def stage_means(local_mappers, skip: int = 0) -> dict:
    """Mean wall ms of each mapping stage over the passes of every
    `LocalMapping` given, without each one's first `skip` passes (a
    threaded mapper's first pass waits for the tracker's first captures)."""
    passes = [p for lm in local_mappers for p in lm.pass_ms[skip:]]
    return {st: round(float(np.mean([p[st] for p in passes if st in p] or [0.0])), 2) for st in STAGES}


def trace_events(prof) -> list:
    """(name, on the device) of every event a finished torch.profiler run
    recorded, read from its Kineto results: the events that `prof.events()`
    makes into FunctionEvents, without building them and their tree, which
    takes tens of seconds for the ~200,000 events of an eager frame."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda) for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def profiled(fn):
    """(fn()'s result, the device kernels and copies that the call
    launches), from torch.profiler with CUDA activity only."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(on_device for _, on_device in trace_events(prof))


def device_launches(fn):
    return profiled(fn)[1]


def phase_bow(seq, cfg):
    """The BoW transform at the ORBvoc shape on the card against the CPU, and
    the vocabulary's training and text round trip."""
    from ceres_mono_orb_slam2_tpu_torch.ops import bow
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor

    t0 = time.perf_counter()
    voc = bow.synth_vocabulary(k=10, levels=6, seed=0)
    if len(voc.node_desc) != 1_111_111 or voc.n_words != 1_000_000:
        raise AssertionError(f"vocabulary shape {len(voc.node_desc)} nodes, {voc.n_words} words")
    t_build = time.perf_counter() - t0
    feats = ORBExtractor(cfg.orb, device="cuda").extract(seq.images[0])
    desc, valid = feats.desc[0], feats.valid[0]
    before = torch.cuda.memory_allocated()
    on_card = bow.make_transform_fn(voc, device="cuda")
    resident = torch.cuda.memory_allocated() - before
    wid, path = on_card(desc, valid)
    wid_h, path_h = bow.make_transform_fn(voc, device="cpu")(desc.cpu(), valid.cpu())
    if not (torch.equal(wid.cpu(), wid_h) and torch.equal(path.cpu(), path_h)):
        raise AssertionError("[bow] word ids or node paths differ between the card and the CPU")
    n_valid = int(valid.sum())
    if int((wid >= 0).sum()) != n_valid or int(wid.max()) >= voc.n_words:
        raise AssertionError("[bow] word ids out of range")
    for _ in range(3):
        on_card(desc, valid)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        on_card(desc, valid)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / 20
    launches = device_launches(lambda: on_card(desc, valid))
    log(f"[bow] {len(voc.node_desc)} nodes, {voc.n_words} words (built on the host in {t_build:.1f} s), "
        f"{resident / 1e6:.1f} MB resident on the card; {desc.shape[0]} descriptors ({n_valid} valid), "
        f"{len(set(wid_h[wid_h >= 0].tolist()))} distinct words: word ids and node paths "
        f"(N, {path.shape[1]}) equal between card and CPU (torch.equal); transform "
        f"{ms:.3f} ms per frame over 20 calls, {launches} launches")

    # train, write as ORBvoc text, parse back
    d = desc.cpu().numpy()[valid.cpu().numpy()]
    t0 = time.perf_counter()
    small = bow.train_vocabulary(d, k=6, levels=3, seed=0, docs=[d[::2], d[1::2]], device="cuda")
    t_train = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path_txt = os.path.join(tmp, "voc.txt")
        bow.dump_orbvoc_text(small, path_txt)
        size = os.path.getsize(path_txt)
        back = bow.parse_orbvoc_text(path_txt)
    ones = np.ones(len(d), bool)
    w0 = bow.make_transform_fn(small, device="cuda")(d, ones)[0].cpu().numpy()
    w1 = bow.make_transform_fn(back, device="cuda")(d, ones)[0].cpu().numpy()
    same = (back.n_words == small.n_words and back.k == small.k
            and np.array_equal(small.node_desc[np.nonzero(small.is_leaf)[0][w0]],
                               back.node_desc[np.nonzero(back.is_leaf)[0][w1]])
            and np.allclose(small.word_weight[w0], back.word_weight[w1], rtol=1e-6))
    log(f"[bow] train_vocabulary(k=6, levels=3) on {len(d)} descriptors: {len(small.node_desc)} nodes, "
        f"{small.n_words} words in {t_train:.2f} s; ORBvoc text {size} bytes written and parsed back: "
        f"every descriptor quantizes to the same leaf and weight: {same}")
    if not same:
        raise AssertionError("[bow] the vocabulary's text round trip changed the tree")


def _rot(w):
    from ceres_mono_orb_slam2_tpu_torch.ops import lie

    return lie.so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def _dev(a, dtype=None):
    return torch.as_tensor(np.asarray(a, dtype), device="cuda")


def solver_pnp(seed: int = 0, C: int = 8, N: int = 2000, NH: int = 256):
    """ransac_pnp_multi: C candidates x N points; candidate 2 holds the true
    3D points for 40% of its matches, the others hold unrelated points."""
    from ceres_mono_orb_slam2_tpu_torch.ops import pnp
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
    R, t = _rot([0.1, -0.2, 0.05]), np.array([0.3, -0.1, 0.5], np.float32)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 10, N)], -1)
    Xc = X @ R.T + t
    uv = 500.0 * Xc[:, :2] / Xc[:, 2:] + K[:2, 2] + rng.standard_normal((N, 2)) * 0.5
    Xs = rng.permutation(X)[None].repeat(C, 0) + rng.standard_normal((C, N, 3))
    inlier = rng.random(N) < 0.4
    Xs[2] = np.where(inlier[:, None], X, Xs[2])
    args = (_dev(K), _dev(Xs, np.float32), _dev(uv, np.float32)[None].expand(C, N, 2),
            _dev(rng.choice([1.0, 0.694, 0.482], N), np.float32)[None].expand(C, N),
            torch.ones((C, N), dtype=torch.bool, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((C, NH, N), device="cuda", generator=g)
    run = lambda: pnp.ransac_pnp_multi(noise, *args)  # noqa: E731
    run()
    res, ms = timed(run)
    # the tracker's split: its four stages replayed around the three
    # host-checked linear-algebra calls
    stages = pnp.RansacStages(*(graphs.CapturedFunction(fn, "cuda", name=f"ransac_{name}")
                                for name, fn in zip(pnp.RansacStages._fields, pnp.RansacStages())))
    replay = lambda: pnp.ransac_pnp_multi(noise, *args, stages=stages)  # noqa: E731
    first = replay()
    rep, ms_rep = timed(replay)
    same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(res, rep, first))
    best = int(res.n_inliers.argmax())
    err_R = float(np.abs(res.R[best].cpu().numpy() - R).max())
    err_t = float(np.abs(res.t[best].cpu().numpy() - t).max())
    found = int((res.inliers[best].cpu().numpy() & inlier).sum())
    log(f"[solvers] ransac_pnp_multi {C} candidates x {N} points x {NH} hypotheses (x4 P3P seeds): "
        f"best candidate {best}, {int(res.n_inliers[best])} inliers ({found} of {int(inlier.sum())} true), "
        f"|R - R*| {err_R:.2e}, |t - t*| {err_t:.2e}; {ms:.2f} ms, {device_launches(run)} launches; "
        f"its 4 stages replayed: {ms_rep:.2f} ms, {device_launches(replay)} launches, equal to the eager "
        f"call to the bit: {same}; pool MB {round(stages.p3p.pool_bytes() / 1e6, 1)}")
    if not same:
        raise AssertionError("[solvers] the replayed RANSAC stages differ from the eager call")
    if not (best == 2 and bool(res.success[2]) and found >= 0.9 * inlier.sum()
            and err_R < 1e-2 and err_t < 5e-2 and int(res.success.sum()) == 1):
        raise AssertionError("[solvers] ransac_pnp_multi did not find the true pose")
    # the tracker's padding: the live candidates, then rows with no valid
    # point and zero draws up to 8, through the replayed stages, against the
    # live candidates alone (eagerly, at their own batch size)
    for live in ([2], [0, 1, 2]):
        pad = lambda a: torch.cat([a[live], a.new_zeros((C - len(live),) + a.shape[1:])])  # noqa: E731
        padded = pnp.ransac_pnp_multi(pad(noise), args[0], pad(args[1]), *args[2:4], pad(args[4]),
                                      stages=stages)
        alone = pnp.ransac_pnp_multi(noise[live], args[0], args[1][live], args[2][live], args[3][live],
                                     args[4][live])
        n = len(live)
        equal = {f: torch.equal(getattr(padded, f)[:n], getattr(alone, f))
                 for f in ("success", "inliers", "n_inliers")}
        err = [float((getattr(padded, f)[:n] - getattr(alone, f)).abs().max()) for f in ("R", "t")]
        log(f"[solvers] ransac_pnp_multi {n} live candidates padded to {C} (replayed) against the {n} alone "
            f"(eager): equal {equal}, max |R - R'| {err[0]:.2e}, |t - t'| {err[1]:.2e}, to the bit: "
            f"{all(torch.equal(a[:n], b) for a, b in zip(padded, alone))}; padded rows succeed: "
            f"{bool(padded.success[n:].any())}")
        if not (all(equal.values()) and max(err) <= 1e-6 and not bool(padded.success[n:].any())):
            raise AssertionError(f"[solvers] RANSAC padded to {C} differs from its {n} live candidates")


def solver_extraction(seq, cfg):
    """A non-fused frame's extraction through `Tracking.build_frame`, on
    the spiral's frame 0: a tracker with graphs (its extraction program)
    against one with graphs=False, features equal to the bit in every call,
    host ms of a call after warm-up (the `Frame`'s host copies included),
    and each kernel counted once per extraction through the replays."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k

    slams = [MonoSLAM(cfg, device="cuda", graphs=g) for g in (True, False)]
    names = ("kp_und", "kp_octave", "kp_angle", "desc", "kp_valid")
    k.reset_launch_counts()
    same, ms = True, {}
    for _ in range(3):  # the first call of the program runs eagerly, then captures
        fg, fe = (slam.tracker.build_frame(seq.images[0], 0.0) for slam in slams)
        same &= all(np.array_equal(getattr(fg, n), getattr(fe, n)) for n in names)
    for slam, g in zip(slams, (True, False)):
        ms[g] = float(np.median([timed(lambda: slam.tracker.build_frame(seq.images[0], 0.0))[1]
                                 for _ in range(5)]))
    launches = dict(k.launch_counts)
    (prog,) = slams[0].tracker.programs()
    for slam in slams:
        slam.shutdown()
    log(f"[solvers] a non-fused frame's extraction {W}x{H} (Tracking.build_frame): replayed {ms[True]:.2f} ms "
        f"against {ms[False]:.2f} eager; features equal to the bit: {same}; program {prog['name']} "
        f"{prog['captures']} capture, {prog['replays']} replays, pool MB {round(prog['pool_mb'], 1)}; "
        f"kernel launches {launches} over 16 extractions")
    if not same:
        raise AssertionError("[solvers] the extraction program's features differ from graphs=False's")
    if launches != {"fast_nms": 16, "gather_patches": 16}:
        raise AssertionError("[solvers] a kernel was not counted once per extraction")
    return launches, 16


SIM3_XI = (0.2, -0.1, 0.3, 0.05, -0.04, 0.08, float(np.log(1.3)))  # the true S12 of the Sim(3) problems


def sim3_matches(seed: int, N: int):
    """N matches of the similarity `SIM3_XI` with 0.3 px noise, 30% of them
    wrong, as numpy: (X1, X2, uv1, uv2) float64 and the wrong ones' mask."""
    from ceres_mono_orb_slam2_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    R12, t12, s12 = (a.numpy() for a in lie.sim3_exp(torch.tensor(SIM3_XI)))
    X2 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 8, N)], -1)
    X1 = s12 * X2 @ R12.T + t12
    proj = lambda X: 500.0 * X[:, :2] / X[:, 2:] + np.array([320.0, 240.0])  # noqa: E731
    uv1 = proj(X1) + rng.standard_normal((N, 2)) * 0.3
    uv2 = proj(X2) + rng.standard_normal((N, 2)) * 0.3
    bad = rng.random(N) < 0.3
    X1[bad] = rng.permutation(X1)[bad] + rng.uniform(0.5, 1.0, (int(bad.sum()), 3))
    return (X1, X2, uv1, uv2), bad


def solver_sim3(seed: int = 1, N: int = 300, NH: int = 256):
    """ransac_sim3 then optimize_sim3 on N matches, 30% of them wrong, of a
    known similarity."""
    from ceres_mono_orb_slam2_tpu_torch.ops import lie, sim3opt, sim3solver

    K = _dev([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
    xi = torch.tensor(SIM3_XI)
    s12 = float(torch.exp(xi[6]))
    (X1, X2, uv1, uv2), bad = sim3_matches(seed, N)
    args = tuple(_dev(a, np.float32) for a in (X1, X2, uv1, uv2, np.ones(N), np.ones(N)))
    valid = torch.ones(N, dtype=torch.bool, device="cuda")
    noise = torch.rand((NH, N), device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    ransac = lambda: sim3solver.ransac_sim3(noise, K, K, *args, valid)  # noqa: E731
    ransac()
    res, ms_r = timed(ransac)
    refine = lambda: sim3opt.optimize_sim3(K, K, *args, res.inliers, res.R, res.t, res.s)  # noqa: E731
    refine()
    opt, ms_o = timed(refine)
    err = float(torch.linalg.norm(lie.sim3_log(opt.R, opt.t, opt.s).cpu() - xi))
    log(f"[solvers] ransac_sim3 {N} matches x {NH} hypotheses: {int(res.n_inliers)} inliers of "
        f"{int((~bad).sum())} true, {ms_r:.2f} ms, {device_launches(ransac)} launches; optimize_sim3 "
        f"(15 LM iterations): {int(opt.n_inliers)} inliers, |log(S) - xi*| {err:.2e}, s {float(opt.s):.4f} "
        f"(true {s12:.4f}), {ms_o:.2f} ms, {device_launches(refine)} launches")
    if not (bool(res.success) and err < 0.02 and int(opt.n_inliers) >= 0.9 * (~bad).sum()
            and not bool((opt.inliers.cpu().numpy() & bad).any())):
        raise AssertionError("[solvers] ransac_sim3 + optimize_sim3 did not recover the similarity")


def drifted_ring(P: int, seed: int, radius: float = 5.0):
    """A ring of P poses with exact odometry and one loop edge, and an
    initialisation that integrates the odometry with noise and scale drift."""
    from ceres_mono_orb_slam2_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(P) / P
    Rt = np.stack([_rot([0.0, a, 0.0]).T for a in ang]).astype(np.float64)
    cw = np.stack([radius * np.sin(ang), np.zeros(P), radius * (1 - np.cos(ang))], -1)
    tt = -np.einsum("pij,pj->pi", Rt, cw)
    ei = np.arange(P)
    ej = (ei + 1) % P
    Rm = np.einsum("eij,ekj->eik", Rt[ej], Rt[ei])
    tm = tt[ej] - np.einsum("eij,ej->ei", Rm, tt[ei])
    R0, t0, s0 = [Rt[0]], [tt[0]], [1.0]
    sig = np.array([0.004] * 3 + [0.002] * 3 + [0.003])
    for k in range(P - 1):
        dR, dt, ds = (a.double().numpy() for a in lie.sim3_exp(
            torch.as_tensor((rng.standard_normal(7) * sig).astype(np.float32))))
        Rk, tk = Rm[k] @ R0[k], Rm[k] @ t0[k] + tm[k]
        R0.append(dR @ Rk), t0.append(ds * dR @ tk + dt), s0.append(ds * s0[k])
    fixed = np.zeros(P, bool)
    fixed[0] = True
    return (Rt, tt), (np.array(R0), np.array(t0), np.array(s0), ei, ej, Rm, tm, np.ones(P), fixed)


def solver_essential_graph(P: int = 200):
    from ceres_mono_orb_slam2_tpu_torch.ops import sim3opt

    (Rt, tt), (R0, t0, s0, ei, ej, Rm, tm, sm, fixed) = drifted_ring(P, seed=2)
    args = (_dev(R0, np.float32), _dev(t0, np.float32), _dev(s0, np.float32), _dev(ei), _dev(ej),
            _dev(Rm, np.float32), _dev(tm, np.float32), _dev(sm, np.float32),
            torch.ones(P, dtype=torch.bool, device="cuda"), _dev(fixed))
    centre = lambda R, t, s: -np.einsum("pji,pj->pi", R, t / s[:, None])  # noqa: E731
    c_true, c0 = centre(Rt, tt, np.ones(P)), centre(R0, t0, s0)
    gap0 = float(np.linalg.norm(c0[-1] - c0[0]) - np.linalg.norm(c_true[-1] - c_true[0]))
    cost0 = float(sim3opt.optimize_essential_graph(*args, gn_iters=0).cost)
    run = lambda: sim3opt.optimize_essential_graph(*args)  # noqa: E731
    res, ms = timed(run)
    again, n_launches = profiled(run)
    c1 = centre(*(a.cpu().numpy().astype(np.float64) for a in (res.R, res.t, res.s)))
    gap1 = float(np.linalg.norm(c1[-1] - c1[0]) - np.linalg.norm(c_true[-1] - c_true[0]))
    err0, err1 = float(np.abs(c0 - c_true).max()), float(np.abs(c1 - c_true).max())
    same = all(torch.equal(a, b) for a, b in zip(res, again))
    log(f"[solvers] optimize_essential_graph ring of {P} poses, {len(ei)} edges, 30 GN x 100 PCG: cost "
        f"{cost0:.4e} -> {float(res.cost):.4e}, loop gap error {gap0:.4f} -> {gap1:.4f}, max centre error "
        f"{err0:.4f} -> {err1:.4f} (radius 5); {ms:.1f} ms, {n_launches} launches; "
        f"two calls bit-identical: {same}")
    if not (float(res.cost) < 1e-2 * cost0 and abs(gap1) < 0.1 * abs(gap0) and err1 < 0.25 * err0 and same):
        raise AssertionError("[solvers] the essential graph did not close the ring")


def solver_ba_cg():
    """bundle_adjustment_cg on ba_problem(): the Huber cost of the dense
    solver's solution within 1%, two calls bit-identical, and its LM
    iterations replayed (`cg_lm_iteration`) equal to the eager call."""
    from ceres_mono_orb_slam2_tpu_torch.ops import optim
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    args = ba_problem()
    run = lambda: optim.bundle_adjustment_cg(*args, iters=20, cg_iters=50, robust=True)  # noqa: E731
    run()
    cg, ms = timed(run)
    again, n_launches = profiled(run)
    step = graphs.CapturedFunction(optim.cg_lm_iteration, "cuda", name="gba_lm_cg", owner="mapper")
    replay = lambda: on_mapper_stream(lambda: optim.bundle_adjustment_cg(*args, iters=20, step=step))  # noqa: E731
    first = replay()
    rep, ms_rep = timed(replay)
    same_rep = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(cg, rep, first))
    dense, ms_dense = timed(lambda: optim.bundle_adjustment(*args, iters_huber=20, iters_trimmed=0))
    # the dense solver reports its trimmed cost: a zero-iteration CG call
    # evaluates the Huber cost of its solution
    evaluate = lambda R, t, pts: float(optim.bundle_adjustment_cg(  # noqa: E731
        args[0], R, t, pts, *args[4:], iters=0).cost)
    c0, c_cg, c_dense = evaluate(*args[1:4]), float(cg.cost), evaluate(dense.R, dense.t, dense.points)
    same = all(torch.equal(a, b) for a, b in zip(cg, again))
    log(f"[solvers] bundle_adjustment_cg P={args[1].shape[0]} M={args[3].shape[0]} O={args[4].shape[0]}, "
        f"20 LM x 50 CG: Huber cost {c0:.3f} -> {c_cg:.3f} (dense Schur solver: {c_dense:.3f}, "
        f"{ms_dense:.1f} ms), inliers {int(cg.inlier_obs.sum())}; {ms:.1f} ms, "
        f"{n_launches} launches; two calls bit-identical: {same}; LM iterations replayed: {ms_rep:.1f} ms, "
        f"equal to the eager call to the bit: {same_rep}, pool MB "
        f"{round(step.pool_bytes() / 1e6, 1)}")
    if not (same and same_rep):
        raise AssertionError("bundle_adjustment_cg is not deterministic on the card, or its replay differs")
    if not (c_cg < 0.5 * c0 and abs(c_cg - c_dense) <= 0.01 * c_dense):
        raise AssertionError("[solvers] bundle_adjustment_cg does not reach the dense solver's cost")


def same_bits(xs, ys) -> bool:
    """Equal dtype, shape and bytes, element by element (NaN included) of
    two sequences of tensors or arrays."""
    def bits(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a.dtype.str, a.shape, a.tobytes()

    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(bits(x) == bits(y) for x, y in zip(xs, ys))


def solver_two_view(seed: int = 3, N: int = TWO_VIEW_ROWS, n: int = TWO_VIEW_MATCHES, NH: int = 256):
    """`initialize_two_view` on n matches of a known motion (10% of them
    wrong) padded to N rows, as the tracker passes nFeatures 2500's budget:
    eagerly and through its four stage programs (a first call, then
    replays), successful and equal to the bit; the H path's 8 N cheirality
    matrices go through the eigensolver in chunks. Then the chunks on the
    card: 32,768 matrices in chunks of `EIGH_BATCH` against chunks of 4096,
    16,384 in one call against chunks of 4096, to the bit; and one call at
    32,768 in a subprocess, which cuSOLVER refused in PR 11's runs."""
    from ceres_mono_orb_slam2_tpu_torch.ops import twoview
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
    R, t = _rot([0.01, 0.03, 0.005]), np.array([0.5, 0.02, 0.05], np.float32)
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(5, 12, n)], -1)
    proj = lambda Xc: 500.0 * Xc[:, :2] / Xc[:, 2:] + K[:2, 2]  # noqa: E731
    uv1 = proj(X) + rng.standard_normal((n, 2)) * 0.3
    uv2 = proj(X @ R.T + t) + rng.standard_normal((n, 2)) * 0.3
    bad = rng.random(n) < 0.1
    uv2[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
    pad = lambda a: np.concatenate([a, np.zeros((N - n,) + a.shape[1:], a.dtype)])  # noqa: E731
    args = (_dev(K), _dev(pad(uv1), np.float32), _dev(pad(uv2), np.float32), _dev(pad(np.ones(n, bool))))
    noise = torch.rand((NH, N), device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    stages = twoview.TwoViewStages(*(graphs.CapturedFunction(fn, "cuda", name=f"two_view_{name}")
                                     for name, fn in zip(twoview.TwoViewStages._fields,
                                                         twoview.TwoViewStages())))
    run = lambda: twoview.initialize_two_view(noise, *args)  # noqa: E731
    replay = lambda: twoview.initialize_two_view(noise, *args, stages=stages)  # noqa: E731
    eager, eager_first_ms = timed(run)
    first, first_ms = timed(replay)
    ms, same = {"eager": [], "replayed": []}, same_bits(first, eager)
    for _ in range(5):
        for name, fn in (("eager", run), ("replayed", replay)):
            out, t_ms = timed(fn)
            ms[name].append(t_ms)
            same &= same_bits(out, eager)
    err_R = float(np.abs(eager.R21.cpu().numpy() - R).max())
    cos_t = float(eager.t21.cpu().numpy() @ (t / np.linalg.norm(t)))
    log(f"[solvers] initialize_two_view {n} matches padded to {N} rows x {NH} hypotheses "
        f"({8 * N} cheirality matrices on the H path, in chunks of {twoview.EIGH_BATCH}): success "
        f"{bool(eager.success)}, homography {bool(eager.used_homography)}, {int(eager.n_inliers)} inliers, "
        f"{int(eager.triangulated.sum())} triangulated, |R - R*| {err_R:.2e}, t . t* {cos_t:.6f}; ms eager "
        f"{np.median(ms['eager']):.2f} (first {eager_first_ms:.2f}), its 4 stages replayed "
        f"{np.median(ms['replayed']):.2f} (first call {first_ms:.2f}), every call equal to the eager one to "
        f"the bit: {same}; programs "
        f"{[(p['name'], p['captures'], p['replays']) for f in stages for p in f.report()]}")
    # the pose is one minimal set's 8-point fit, unrefined: a coarse bar
    if not (same and bool(eager.success) and err_R < 5e-2 and cos_t > 0.95):
        raise AssertionError("[solvers] the two-view initializer at 4096 rows failed, or its programs differ")

    g = torch.Generator(device="cuda").manual_seed(seed)
    B = torch.randn((2 * twoview.EIGH_BATCH, 4, 4), device="cuda", generator=g)
    A = B @ B.transpose(-1, -2)
    chunks = twoview.smallest_eigvecs(A)
    one_call = torch.linalg.eigh(A[:twoview.EIGH_BATCH])[1][..., :, 0]
    default = twoview.EIGH_BATCH
    twoview.EIGH_BATCH = 4096
    try:
        small, small_half = twoview.smallest_eigvecs(A), twoview.smallest_eigvecs(A[:default])
    finally:
        twoview.EIGH_BATCH = default
    equal = {"chunks of 16,384 and of 4096 at 32,768": torch.equal(chunks, small),
             "one call and chunks of 4096 at 16,384": torch.equal(one_call, small_half)
             and torch.equal(one_call, chunks[:default])}
    code = ("import torch; g = torch.Generator(device='cuda').manual_seed(0); "
            f"B = torch.randn(({2 * default}, 4, 4), device='cuda', generator=g); "
            "torch.linalg.eigh(B @ B.transpose(-1, -2)); torch.cuda.synchronize(); print('accepted')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    said = (r.stdout.strip().splitlines() or r.stderr.strip().splitlines() or [""])[-1][:240]
    log(f"[solvers] the eigensolver's chunks, random SPD 4x4: equal to the bit {equal}; one call at "
        f"{2 * default} matrices in a subprocess: exit {r.returncode}, {said!r}")
    if not all(equal.values()):
        raise AssertionError("[solvers] the chunked eigensolver's bits depend on the chunk size")


def phase_solvers(seq, cfg):
    for solver in (solver_pnp, solver_sim3, solver_essential_graph, solver_ba_cg, solver_two_view):
        solver()
    return solver_extraction(seq, cfg)


def trajectory_ate(slam, seq):
    """ATE of the resolved trajectory (every tracked frame re-based on its
    reference keyframe's final pose) in percent of its length."""
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    ts, est = slam.get_frame_trajectory()
    frame_of = {float(t): k for k, t in enumerate(seq.timestamps)}
    gt = np.stack([seq.gt_centers()[frame_of[float(t)]] for t in ts])
    traj = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return 100.0 * ate_rmse(est, gt) / traj, float(est.sum())


@functools.lru_cache(maxsize=1)
def reloc_setup():
    """[reloc]'s inputs, made once a process ([graphs] runs them too): the
    ring world on a circle at TUM width, a vocabulary trained on the
    sequence's own descriptors, the images with three black frames mid-ring.
    Returns (config, sequence, vocabulary, images)."""
    from ceres_mono_orb_slam2_tpu_torch.ops import bow
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence

    t0 = time.perf_counter()
    cfg = slam_config(TUM_H, TUM_W)
    seq = make_rendered_sequence(RELOC_FRAMES, TUM_H, TUM_W, 500.0, 500.0, motion="circle",
                                 step=0.0635, seed=11, device="cuda")
    ex = ORBExtractor(cfg.orb, device="cuda")
    corpus = []
    for i in range(0, RELOC_FRAMES, 4):
        fe = ex.extract(seq.images[i])
        corpus.append(fe.desc[0][fe.valid[0]].cpu().numpy())
    t1 = time.perf_counter()
    voc = bow.train_vocabulary(np.concatenate(corpus), k=10, levels=4, seed=0, docs=corpus, device="cuda")
    log(f"[reloc] rendered {RELOC_FRAMES} frames {TUM_W}x{TUM_H} and extracted {len(corpus)} of them in "
        f"{t1 - t0:.1f} s; vocabulary (k=10, levels=4) of {voc.n_words} words trained on "
        f"{sum(len(c) for c in corpus)} descriptors in {time.perf_counter() - t1:.1f} s")
    images = seq.images.copy()
    images[list(RELOC_BLACKOUT)] = 0.0  # kidnap: three black frames mid-ring
    return cfg, seq, voc, images


def phase_reloc():
    """Kidnap relocalization from pixels at TUM width: the ring world on a
    circle, three black frames mid-ring, a vocabulary trained on the
    sequence's own descriptors."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k

    cfg, seq, voc, images = reloc_setup()
    slam = MonoSLAM(cfg, vocabulary=voc, device="cuda")
    k.reset_launch_counts()
    states, frame_ms = [], []
    for i in range(RELOC_FRAMES):
        _, ms = timed(lambda: slam.track_monocular(images[i], float(seq.timestamps[i])))
        frame_ms.append(ms)
        states.append(slam.get_tracking_state())
    launches = dict(k.launch_counts)
    ate_pct, centre_sum = trajectory_ate(slam, seq)
    slam.shutdown()
    trk, lc = slam.tracker, slam.loop_closer
    lost_at = states.index("LOST") if "LOST" in states else -1
    # start of the last unbroken run of OK frames
    recovered_at = next((i + 1 for i in reversed(range(RELOC_FRAMES)) if states[i] != "OK"), 0)
    recovered_at = recovered_at if recovered_at < RELOC_FRAMES else -1
    reloc_frames = [st["frame_id"] for st in trk.frame_stats if st["method"] == "reloc" and st["ok"]]
    live = [kf for kf in slam.map.keyframes.values() if not kf.bad]
    gap_th = max(12, len(live) // 2)
    long_range = sum(1 for kf in live for nb in kf.covisible if kf.id - nb >= gap_th)
    steady = np.asarray(frame_ms[10:])
    log(f"[reloc] states {''.join(st[0] for st in states)}")
    log(f"[reloc] LOST first at frame {lost_at}, OK without a break from frame {recovered_at}, "
        f"{states.count('OK')}/{RELOC_FRAMES} frames OK, relocalized at frames {reloc_frames}, n_resets {trk.n_resets}, last_reloc_frame_id "
        f"{trk.last_reloc_frame_id}; keyframes {slam.map.n_keyframes()}, map points "
        f"{slam.map.n_map_points()}, launches {launches}")
    log(f"[reloc] ATE of the resolved trajectory {ate_pct:.4f}% (repeat check: ATE {ate_pct!r} %, sum of "
        f"camera centres {centre_sum!r}); not asserted: n_loops_closed {lc.n_loops_closed}, n_detects "
        f"{lc.n_detects}, n_candidate_events {lc.n_candidate_events}, long-range covisibility edges "
        f"{long_range}; per-frame ms (frames 10+): median {np.median(steady):.2f}, p95 "
        f"{np.percentile(steady, 95):.2f}; relocalizing frames "
        f"{[round(frame_ms[i], 1) for i in reloc_frames]} ms")
    checks = {
        "LOST within frames 44-49": "LOST" in states[44:50],
        "OK again before the last five frames, and from then on": lost_at < recovered_at < RELOC_FRAMES - 5,
        "n_resets == 0": trk.n_resets == 0,
        "last_reloc_frame_id >= 0": trk.last_reloc_frame_id >= 0,
        "fast_nms launched once per frame": launches["fast_nms"] == RELOC_FRAMES,
        "gather_patches launched once per frame": launches["gather_patches"] == RELOC_FRAMES,
        "ATE < 3.5% of trajectory": ate_pct < 3.5,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"reloc checks failed: {failed}")
    return launches, RELOC_FRAMES


def loop_system(threaded: bool = False, graphs: bool = True):
    """A MonoSLAM on the closed geometric circle (its vocabulary, the
    geometric front end of seed 3) and the ground-truth camera centres."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops import bow
    from ceres_mono_orb_slam2_tpu_torch.utils.geosim import GeoExtractor, GeoWorld, make_geo_trajectory

    cfg = slam_config(TUM_H, TUM_W, max_local_points=16384)
    Rcw, tcw = make_geo_trajectory(LOOP_FRAMES, "circle", LOOP_STEP)
    world = GeoWorld(np.random.default_rng(0), LOOP_LANDMARKS, shape="ring")
    voc = bow.train_vocabulary(world.desc[:4000], k=8, levels=3, seed=0, device="cuda")
    slam = MonoSLAM(cfg, vocabulary=voc, device="cuda", threaded=threaded, graphs=graphs)
    slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, cfg.orb.n_features, TUM_H, TUM_W,
                                          px_noise=0.3, bit_noise=2, seed=3, device="cuda")
    return slam, np.einsum("tij,tj->ti", Rcw.transpose(0, 2, 1), -tcw)


def run_loop(threaded: bool = False):
    """One run of the closed geometric circle through the full system;
    threaded, each frame waits for the mapper thread and for a running
    global BA, so that the run makes the serial run's every decision."""
    from ceres_mono_orb_slam2_tpu_torch.utils.geosim import frame_image
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    slam, gt_c = loop_system(threaded)
    gx = slam.tracker.extractor
    est, gt, frame_ms, changed = [], [], [], []

    def frame(i):
        T = slam.track_monocular(frame_image(i, TUM_H, TUM_W), i / 30.0)
        if threaded:
            if not slam.wait_mapper_idle(timeout=JOIN_TIMEOUT_S):
                raise AssertionError("[loop] the mapper thread did not go idle")
            gba = slam.loop_closer.gba_thread
            if gba is not None and gba.is_alive():
                gba.join(timeout=JOIN_TIMEOUT_S)
        return T

    for i in range(LOOP_FRAMES):
        T, ms = timed(lambda: frame(i))
        frame_ms.append(ms)
        changed.append(slam.map_changed())
        if T is not None:
            est.append(-T[:3, :3].T @ T[:3, 3])
            gt.append(gt_c[i])
    est, gt = np.stack(est), np.stack(gt)
    traj = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    n_kp = np.mean([(s >= 0).sum() for s in gx.slot_lm_by_frame.values()])
    alive = threaded and slam._worker.is_alive()
    state = slam.get_tracking_state()
    if threaded:
        slam.shutdown()
    return dict(slam=slam, state=state, tracked=len(est), frame_ms=frame_ms,
                ate_pct=100.0 * ate_rmse(est, gt) / traj, centre_sum=float(est.sum()),
                changed=changed, mean_keypoints=float(n_kp), worker_alive=alive)


def phase_loop():
    """Loop closing through the full system with the geometric front end,
    twice: serial, then threaded with the global-BA thread; the two runs
    must agree to the bit."""
    runs = []
    for r, threaded in enumerate((False, True)):
        run, ms = timed(lambda: run_loop(threaded))
        runs.append(run)
        slam = run["slam"]
        lc = slam.loop_closer
        log(f"[loop] run {r} ({'threaded, global BA on its own thread' if threaded else 'serial'}): "
            f"{LOOP_FRAMES} frames {TUM_W}x{TUM_H}, {run['mean_keypoints']:.0f} keypoints a "
            f"frame of {LOOP_LANDMARKS} landmarks, in {ms / 1e3:.1f} s: state {run['state']}, tracked "
            f"{run['tracked']}/{LOOP_FRAMES}, keyframes {slam.map.n_keyframes()}, map points "
            f"{slam.map.n_map_points()}, n_loops_closed {lc.n_loops_closed}, n_gba_runs {lc.n_gba_runs}, "
            f"n_detects {lc.n_detects}, ATE {run['ate_pct']:.4f}%, map_changed() true at frames "
            f"{[i for i, c in enumerate(run['changed']) if c]}")
        log(f"[loop] run {r}: the mapper's programs (captures, replays on the mapper stream, kept, dropped, "
            f"shared pool MB): {program_summaries(slam)}")
        for st in lc.loop_stats:
            log(f"[loop] run {r}: loop at keyframe {st['kf']} <-> {st['match_kf']}: Sim(3) RANSAC and "
                f"refinement {st['sim3_ms']:.1f} ms, correction and fusion {st['correct_fuse_ms']:.1f} ms, "
                f"essential graph {st['essential_graph_ms']:.1f} ms ({st['edges']} edges; its device solve "
                f"{st['essential_graph_solve_ms']:.1f} ms), global BA "
                f"{st['gba_ms']:.1f} ms (P={st.get('P')} M={st.get('M')} O={st.get('O')}, "
                f"{st.get('solver')} solver); frame of the closure "
                f"{max(run['frame_ms']):.1f} ms, median frame {np.median(run['frame_ms'][10:]):.1f} ms")
        sim3 = lc._sim3_step.report()
        log(f"[loop] run {r}: Sim(3) refinements {sum(p['calls'] for p in sim3) // 15} (15 LM iterations "
            f"each), their program's rows, captures and replays "
            f"{[(max(d[0] for d in p['shapes'] if d), p['captures'], p['replays']) for p in sim3]}")
        log(f"[loop] run {r} repeat check: ATE {run['ate_pct']!r} %, sum of camera centres "
            f"{run['centre_sum']!r}")
        checks = {
            "state OK at the end": run["state"] == "OK",
            "at least 67 frames tracked": run["tracked"] >= LOOP_FRAMES - 5,
            "n_loops_closed >= 1": lc.n_loops_closed >= 1,
            "n_gba_runs >= 1": lc.n_gba_runs >= 1,
            "ATE < 2% of trajectory": run["ate_pct"] < 2.0,
            "map_changed() true once per big change, then false":
                sum(run["changed"]) == lc.n_loops_closed and not slam.map_changed(),
            "about 2000 keypoints a frame": run["mean_keypoints"] >= 1800,
        }
        if threaded:
            checks["the mapper thread alive until shutdown"] = run["worker_alive"]
            checks["global BA ran on the gba thread"] = lc.gba_thread is not None
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"loop checks failed (run {r}): {failed}")
    same = (runs[0]["ate_pct"] == runs[1]["ate_pct"] and runs[0]["centre_sum"] == runs[1]["centre_sum"])
    log(f"[loop] serial and threaded runs bit-identical (ATE and sum of camera centres): {same}")
    if not same:
        raise AssertionError("[loop] the threaded run differs from the serial run")


def ba_window(seed: int, P: int = 16, M: int = 2048, O: int = 8192):
    """A local-BA window of the size of a KITTI-scale local map, as numpy:
    16 keyframes (4 fixed) along a line, 2048 points, 8192 observations with
    0.5 px noise."""
    rng = np.random.default_rng(seed)
    K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.22], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-10, 10, M), rng.uniform(-3, 3, M), rng.uniform(5, 40, M)], -1)
    R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    t = np.stack([np.array([0.5 * i, 0, 0], np.float32) for i in range(P)])
    op = rng.integers(0, P, O)
    oj = rng.integers(0, M, O)
    Xc = pts[oj] + t[op]
    uv = K[:2, :2].diagonal() * Xc[:, :2] / Xc[:, 2:] + K[:2, 2]
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    pts0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    return (K, R, t, pts0, op, oj, uv, np.ones(O, np.float32), np.ones(O, bool),
            np.arange(P) < 4, np.ones(M, bool))


def ba_batch(seeds):
    """The `ba_window`s of `seeds` on the card, one by one and stacked as
    the batched local BA takes them: (windows, (K, R (S, P, 3, 3), ...))."""
    one = [tuple(_dev(a) for a in ba_window(s)) for s in seeds]
    return one, (one[0][0],) + tuple(torch.stack([p[i] for p in one]) for i in range(1, 11))


def index_widths(batch) -> tuple:
    """The widths (by pose, by point, by pair) of the batched local BA's
    index blocks of `batch` before their widening: its largest segments."""
    S, P = batch[9].shape
    M = batch[10].shape[1]
    stream = torch.arange(S, device="cuda")[:, None]
    op, oj = (batch[4].long() + stream * P).reshape(-1), (batch[5].long() + stream * M).reshape(-1)
    return tuple(int(torch.bincount(k).max()) for k in (op, oj, oj * P + batch[4].long().reshape(-1)))


def stream_ba_programs(solve) -> list:
    """(name, captures, replays, kept) of the batched local BA's programs."""
    return [(d["name"], d["captures"], d["replays"], d["kept"]) for d in (f.summary() for f in solve.captured())]


def phase_multistream(cfg):
    """The batched multi-stream step at S=8 against each stream alone, its
    time and launches at S=1 and S=8, and the batched local BA, replayed and
    op by op."""
    from ceres_mono_orb_slam2_tpu_torch.ops import optim
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as ms

    S = N_STREAMS
    images, state = ms.synthetic_stream_state(cfg, S, MAP_POINTS, seed=0, h=H, w=W, device="cuda")
    step = ms.make_multistream_step(cfg, H, W, device="cuda")
    images = torch.from_numpy(np.clip(images + 0.5, 0.0, 255.0).astype(np.uint8)).cuda()
    alone = lambda s: (images[s:s + 1], ms.StreamState(*(a[s:s + 1] for a in state)))  # noqa: E731
    step(images, state)  # warm-up
    k.reset_launch_counts()
    res = step(images, state)
    torch.cuda.synchronize()
    launches = dict(k.launch_counts)
    singles = [step(*alone(s)) for s in range(S)]
    err_R = max(float((singles[s].Rcw[0] - res.Rcw[s]).abs().max()) for s in range(S))
    err_t = max(float((singles[s].tcw[0] - res.tcw[s]).abs().max()) for s in range(S))
    n_m, n_i = res.n_matches.tolist(), res.n_inliers.tolist()
    n_m1 = [int(r.n_matches[0]) for r in singles]
    n_i1 = [int(r.n_inliers[0]) for r in singles]
    log(f"[multistream] {W}x{H}, {cfg.orb.n_features} features, {MAP_POINTS} map points a stream, S={S}: "
        f"matches {n_m} (alone {n_m1}), inliers {n_i} (alone {n_i1}); batched against alone: "
        f"max |R - R1| {err_R:.2e}, max |t - t1| {err_t:.2e}; kernel launches of one step {launches}")
    timing = {}
    for n, args in ((1, alone(0)), (S, (images, state))):
        run = lambda: step(*args)  # noqa: E731
        ms_all = [timed(run)[1] for _ in range(5)]
        timing[n] = (float(np.median(ms_all)), device_launches(run))
        log(f"[multistream] step at S={n}: {timing[n][0]:.2f} ms (median of 5: {[round(m, 1) for m in ms_all]}), "
            f"{n / timing[n][0] * 1e3:.2f} frames/s in aggregate, {timing[n][1]} device launches")
    log(f"[multistream] device launches S={S} / S=1: {timing[S][1] / timing[1][1]:.3f}; "
        f"step ms S={S} / S=1: {timing[S][0] / timing[1][0]:.3f}")

    # the batched local BA: 8 windows in one solve, its LM iterations
    # replayed and op by op, against 8 single solves
    one, batch = ba_batch(range(S))
    solvers = [ms.make_multistream_local_ba(device="cuda", graphs=g) for g in (True, False)]
    solve_batch, solve_eager = (lambda f=f: f(*batch) for f in solvers)
    solve_each = lambda: [optim.bundle_adjustment(*p) for p in one]  # noqa: E731
    solve_batch(), solve_eager(), solve_each()  # warm-up (the first captures)
    ms_all = [[timed(solve_batch)[1], timed(solve_eager)[1]] for _ in range(3)]
    ms_b, ms_e = (float(np.median(m)) for m in zip(*ms_all))
    (rb, _), (re_, _) = timed(solve_batch), timed(solve_eager)
    rs, ms_s = timed(solve_each)
    centre = lambda R, t: -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # noqa: E731
    err_c = max(float((centre(rb.R[s], rb.t[s]) - centre(rs[s].R, rs[s].t)).abs().max()) for s in range(S))
    err_p = max(float((rb.points[s] - rs[s].points).abs().max()) for s in range(S))
    same_inl = all(torch.equal(rb.inlier_obs[s], rs[s].inlier_obs) for s in range(S))
    rel_cost = max(abs(float(rb.cost[s]) / float(rs[s].cost) - 1.0) for s in range(S))
    log(f"[multistream] batched local BA, S={S} x (P=16, M=2048, O=8192): replayed {ms_b:.1f} ms, op by op "
        f"{ms_e:.1f} ms (medians of 3, in turns: {[[round(x, 1) for x in m] for m in ms_all]}), replayed / op "
        f"by op {ms_b / ms_e:.3f}; device launches replayed {device_launches(solve_batch)}, op by op "
        f"{device_launches(solve_eager)}; programs (captures, replays, kept) {stream_ba_programs(solvers[0])}; "
        f"replay equal to op by op to the bit: {same_bits(rb, re_)}; {S} single solves {ms_s:.1f} ms, "
        f"{device_launches(solve_each)} launches; per stream against its single solve: camera centres "
        f"within {err_c:.2e}, points within {err_p:.2e}, relative cost within {rel_cost:.2e}, "
        f"inlier observations equal: {same_inl}")
    checks = {
        "match counts equal to each stream alone": n_m == n_m1,
        "inlier counts equal to each stream alone": n_i == n_i1,
        "every stream matches and solves": min(n_m) > 100 and min(n_i) > 100,
        "R within 1e-5 and t within 1e-4 of each stream alone": err_R < 1e-5 and err_t < 1e-4,
        "one launch of each kernel per step": launches == {"fast_nms": 1, "gather_patches": 1},
        "launches at S=8 below twice those at S=1": timing[S][1] < 2 * timing[1][1],
        "BA camera centres within 1e-3 and points within 5e-2 of the single solves":
            err_c < 1e-3 and err_p < 5e-2,
        "BA costs within 1e-3 relative": rel_cost < 1e-3,
        "batched BA replayed equal to op by op to the bit": same_bits(rb, re_),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"multistream checks failed: {failed}")
    return launches, 1


def run_multisystem(seqs, cfg, threaded: bool, n_frames: int):
    """`MultiStreamSLAM` over the first n_frames frames of each sequence:
    (system, poses per stream, batch-frame ms, launches, workers alive at the
    end)."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.parallel.multisystem import MultiStreamSLAM

    S = len(seqs)
    torch.cuda.reset_peak_memory_stats()
    system = MultiStreamSLAM(cfg, n_streams=S, device="cuda", threaded=threaded)
    k.reset_launch_counts()
    poses, frame_ms = [[] for _ in range(S)], []
    for i in range(n_frames):
        res, ms = timed(lambda: system.track_batch([q.images[i] for q in seqs],
                                                   [float(q.timestamps[i]) for q in seqs]))
        frame_ms.append(ms)
        for s in range(S):
            poses[s].append(res[s])
    alive = all(m._worker.is_alive() for m in system.streams) if threaded else None
    system.shutdown()
    launches = dict(k.launch_counts)
    return system, poses, frame_ms, launches, alive


def phase_multisystem(seq, cfg, serial_poses, serial: dict):
    """`MultiStreamSLAM` with 8 streams over 18 rendered KITTI-width frames
    each, then with a mapper thread per stream over the first 9 of them
    (at full rate 8 mapper threads and the tracker share one GIL, which
    stretches a batch frame several times): stream 0 is the spiral that the
    serial MonoSLAM of phase 4 ran, the others the same ring world under
    other steps along the spiral and other ring worlds (seeds) under the
    same motion."""
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, make_rendered_sequence

    S = N_STREAMS
    t0 = time.perf_counter()
    variants = [(11, 0.05), (11, 0.055), (11, 0.065), (11, 0.07), (12, 0.06), (13, 0.06), (11, 0.0525)]
    seqs = [seq] + [make_rendered_sequence(MS_FRAMES, H, W, 500.0, 500.0, motion="spiral", step=step,
                                           seed=seed, device="cuda") for seed, step in variants]
    log(f"[multisystem] rendered {S - 1} more sequences of {MS_FRAMES} frames {W}x{H} (seed, step) "
        f"{variants} in {time.perf_counter() - t0:.1f} s")
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    paths, unthreaded_ms, stages = {}, None, {}
    for threaded, n_frames in ((False, MS_FRAMES), (True, MS_THREADED_FRAMES)):
        name = "multisystem_threaded" if threaded else "multisystem"
        system, poses, frame_ms, launches, alive = run_multisystem(seqs, cfg, threaded, n_frames)
        peak = torch.cuda.max_memory_allocated()
        first, frac, ate = [], [], []
        for s in range(S):
            tracked = [T is not None for T in poses[s]]
            first.append(tracked.index(True) if any(tracked) else n_frames)
            frac.append(sum(tracked[first[s]:]) / max(n_frames - first[s], 1))
            est = np.asarray([centre(T) for T in poses[s] if T is not None])
            gt = seqs[s].gt_centers()[:n_frames][np.asarray(tracked)]
            traj = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()) if len(gt) > 1 else 0.0
            ate.append(100.0 * ate_rmse(est, gt) / traj if traj > 0 else float("inf"))
        ph = system.phase_s
        n_b = max(ph["frames"], 1)
        # extractions: the batched frames, the single-path frames, and the
        # frames a stream tracked again after a correction landed mid-batch
        n_calls = (system.n_batched_frames + system.n_single_frames
                   + sum(m.tracker.n_retracked_frames for m in system.streams))
        log(f"[{name}] S={S}, {n_frames} frames a stream: n_batched_frames {system.n_batched_frames}, "
            f"n_single_frames {system.n_single_frames}, launches {launches}; init frames {first}, tracked "
            f"after init {[round(100 * f, 1) for f in frac]} %, ATE {[round(a, 4) for a in ate]} %, "
            f"keyframes {[m.map.n_keyframes() for m in system.streams]}, map points "
            f"{[m.map.n_map_points() for m in system.streams]}, n_local_ba "
            f"{[m.local_mapper.n_local_ba for m in system.streams]}")
        init = [p for m in system.streams for p in m.tracker.programs()
                if p["name"].startswith(("init_", "two_view_"))]
        log(f"[{name}] the streams' initializer programs (each stream's tracker owns its own): "
            f"{len(init)} programs, {sum(p['captures'] for p in init)} captures, "
            f"{sum(p['replays'] for p in init)} replays, static inputs "
            f"{sum(p['input_mb'] for p in init):.2f} MB; the tracker pool they share "
            f"{max((p['pool_mb'] for p in init), default=0.0):.1f} MB")
        if threaded:  # beside the unthreaded run's same frames
            same = np.asarray(unthreaded_ms[MS_STEADY:n_frames])
            beside = (f"the unthreaded run's {S / np.median(same) * 1e3:.2f} over the same frames "
                      f"(median {np.median(same):.2f} ms)")
        else:
            unthreaded_ms = frame_ms
            beside = f"{1e3 / serial['median']:.2f} of the serial run (median frame {serial['median']:.2f} ms)"
        steady = np.asarray(frame_ms[MS_STEADY:])
        log(f"[{name}] phase_s per batched frame (mean of {ph['frames']}): prepare "
            f"{ph['prepare'] / n_b * 1e3:.1f} ms, dispatch {ph['dispatch'] / n_b * 1e3:.1f} ms, fetch "
            f"{ph['fetch'] / n_b * 1e3:.1f} ms, consume (with local mapping unless threaded) "
            f"{ph['consume'] / n_b * 1e3:.1f} ms; batch frame ms (frames {MS_STEADY}+): median "
            f"{np.median(steady):.2f}, p95 {np.percentile(steady, 95):.2f} = "
            f"{S / np.median(steady) * 1e3:.2f} frames/s in aggregate, beside {beside}; peak device "
            f"memory {peak / 1e6:.1f} MB")
        mappers = [m.local_mapper for m in system.streams]
        stages[name] = stage_means(mappers), stage_means(mappers, skip=1)
        log(f"[{name}] mean stage ms over every stream's mapping passes {stages[name][0]}, after each "
            f"stream's first {stages[name][1]}"
            + (f" beside the unthreaded run's {stages['multisystem'][0]}, {stages['multisystem'][1]} (same "
               f"call)" if threaded else "") + f", every mapper on the {mapper_stream_name()}")
        checks = {
            "every stream initialises within 10 frames": max(first) < 10,
            "every stream tracks >= 90% after init": min(frac) >= 0.9,
            "every stream's ATE < 1% of its trajectory": max(ate) < 1.0,
            "every frame from frame 4 on batched": system.n_batched_frames >= n_frames - 4,
            "every stream ran local BA": min(m.local_mapper.n_local_ba for m in system.streams) >= 1,
            "fast_nms launched once per batched and per single-path frame": launches["fast_nms"] == n_calls,
            "gather_patches launched once per batched and per single-path frame":
                launches["gather_patches"] == n_calls,
        }
        if threaded:
            checks["every mapper thread alive until shutdown"] = alive
        else:
            same_decisions = all((a is None) == (b is None)
                                 for a, b in zip(serial_poses[:n_frames], poses[0]))
            err0 = max((float(np.linalg.norm(centre(a) - centre(b)))
                        for a, b in zip(serial_poses[:n_frames], poses[0])
                        if a is not None and b is not None), default=float("inf"))
            log(f"[{name}] stream 0 against the serial run: decisions equal {same_decisions}, camera "
                f"centres within {err0:.3e}")
            checks["stream 0 makes the serial run's decisions"] = same_decisions
            checks["stream 0's camera centres within 1e-3 of the serial run"] = err0 < 1e-3
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{name} checks failed: {failed}")
        paths[name] = (launches, n_calls)
    return paths


def write_tum_folder(d: str, images: np.ndarray, timestamps, frames) -> list:
    """`rgb.txt` and `rgb/*.png` of the TUM RGB-D layout for `frames`;
    returns the PNG paths."""
    from ceres_mono_orb_slam2_tpu_torch.utils import png

    os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
    paths = []
    with open(os.path.join(d, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for i in frames:
            name = f"rgb/{timestamps[i]:.6f}.png"
            png.write(os.path.join(d, name), images[i])
            f.write(f"{timestamps[i]:.6f} {name}\n")
            paths.append(os.path.join(d, name))
    return paths


def write_tum2_config(path: str, n_features: int):
    """A reference-format (OpenCV FileStorage) YAML config with the TUM2
    camera."""
    fx, fy, cx, cy = TUM2_K
    k1, k2, p1, p2, k3 = TUM2_DIST
    with open(path, "w") as f:
        f.write(f"%YAML:1.0\nCamera.fx: {fx}\nCamera.fy: {fy}\nCamera.cx: {cx}\nCamera.cy: {cy}\n"
                f"Camera.k1: {k1}\nCamera.k2: {k2}\nCamera.p1: {p1}\nCamera.p2: {p2}\nCamera.k3: {k3}\n"
                f"Camera.fps: 30.0\nCamera.RGB: 1\nORBextractor.nFeatures: {n_features}\n"
                f"ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
                f"ORBextractor.minThFAST: 7\n")


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv, device: str):
    """`cli.main(argv)` in this process, its output printed and kept:
    (return code, output, wall seconds, launches by kernel)."""
    from ceres_mono_orb_slam2_tpu_torch import cli
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k

    buf = io.StringIO()
    if device == "cuda":
        torch.cuda.synchronize()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = cli.main([*argv, "--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0, dict(k.launch_counts)


def cli_summary(text: str) -> dict:
    """The numbers of the CLI's exit lines."""
    out = {}
    for line in text.splitlines():
        w = line.replace(",", "").split()
        if line.startswith("tracked "):
            out.update(frames=int(w[1]), state=w[4], keyframes=int(w[5]), map_points=int(w[7]))
        elif line.startswith("re-tracked "):
            out["retracked"] = int(w[1])
        elif line.startswith("loaded map: "):
            out.update(loaded_keyframes=int(w[2]), loaded_map_points=int(w[4]))
        elif line.startswith(("median tracking time: ", "mean tracking time: ")):
            out[w[0]] = float(w[-1])
    return out


def check_cli_outputs(d: str, summary: dict, seq, max_ate_pct: float) -> dict:
    """Parse the four output files of a run; returns the checks and the
    ATE (percent of the trajectory length, Sim(3)-aligned) of
    FrameTrajectory.txt against the ground truth."""
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    def tum_rows(name):
        rows = np.loadtxt(os.path.join(d, name), ndmin=2)
        ok = rows.shape[1] == 8 and np.isfinite(rows).all() and np.allclose(
            np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
        return rows, ok

    kf_rows, kf_ok = tum_rows("KeyFrameTrajectory.txt")
    fr_rows, fr_ok = tum_rows("FrameTrajectory.txt")
    data = np.load(os.path.join(d, "map.npz"))
    with open(os.path.join(d, "map.yaml")) as f:
        yaml_text = f.read()
    idx = [int(np.argmin(np.abs(seq.timestamps - t))) for t in fr_rows[:, 0]]
    gt = seq.gt_centers()[idx]
    traj = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    ate = 100.0 * ate_rmse(fr_rows[:, 1:4], gt) / traj
    checks = {
        "KeyFrameTrajectory.txt: one TUM row per keyframe": kf_ok and len(kf_rows) == summary["keyframes"],
        "FrameTrajectory.txt: TUM rows": fr_ok and len(fr_rows) >= 2,
        "map.npz: every keyframe and point": (len(data["kf_ids"]) == summary["keyframes"]
                                              and len(data["mp_ids"]) == summary["map_points"]),
        "map.yaml: OpenCV-YAML with every keyframe and point": (
            yaml_text.startswith("%YAML:1.0\n---\nMapPoints:\n")
            and yaml_text.count("   - { id: ") == summary["keyframes"] + summary["map_points"]),
        f"ATE of FrameTrajectory.txt < {max_ate_pct}% of the trajectory": ate < max_ate_pct,
    }
    return dict(checks=checks, ate=ate, rows=len(fr_rows), idx=idx)


def mode_launches(cfg, voc, map_path: str, images, timestamps, device: str, graphs: bool = True) -> dict:
    """Launches of one tracked frame (the tracker only, without local
    mapping) against a loaded map, in localization mode, in the normal
    mode, where it takes the fused path, and relocalizing: a system loads
    the map, tracks frames 12-14 in localization mode (relocalization, the
    reference keyframe, the motion model) and frame 15 under
    torch.profiler, then leaves the mode, tracks frame 16 (fused) and frame
    17 under the profiler, then is blinded and relocalizes frame 18 under
    it (without graphs frame 17 is not profiled: `[graphs]` profiles an
    eager fused frame, and one takes ~30 s under the profiler). Per mode:
    (host API launches, graph launches among them,
    device kernels and copies, the method, ms under the profiler, the
    extraction program's replays in the frame, the kernel launches counted
    in it)."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.models.tracking import State
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k

    slam = MonoSLAM(cfg, vocabulary=voc, device=device, graphs=graphs)
    slam.load_map(map_path)
    slam.activate_localization_mode()
    out = {}
    for mode, warm, measured in (("localization", (12, 13, 14), 15), ("normal", (16,), 17),
                                 ("relocalization", (), 18)):
        if mode == "normal":
            slam.deactivate_localization_mode()
        if mode == "relocalization":  # blinded: the programs of frame 12's relocalization replay
            slam.tracker.state, slam.tracker.velocity = State.LOST, None
        for i in warm:
            slam.track_monocular(images[i], float(timestamps[i]))
        if mode == "normal" and not graphs:
            slam.track_monocular(images[measured], float(timestamps[measured]))
            continue
        ext = slam.tracker._extraction
        replays, counted = ext[1].n_replays if ext else 0, dict(k.launch_counts)
        t0 = time.perf_counter()
        _, api, dev = api_launches(lambda: slam.tracker.grab_image(images[measured], float(timestamps[measured])))
        ms = (time.perf_counter() - t0) * 1e3
        ext = slam.tracker._extraction
        out[mode] = (sum(n for name, n in api.items() if "Launch" in name),
                     sum(n for name, n in api.items() if "GraphLaunch" in name), sum(dev.values()),
                     slam.tracker.frame_stats[-1]["method"], ms, (ext[1].n_replays if ext else 0) - replays,
                     {name: k.launch_counts[name] - n for name, n in counted.items()})
    slam.shutdown()
    return out


def phase_cli(device: str = "cuda"):
    """The mono_slam CLI as a user runs it: a TUM-layout folder rendered
    through the TUM2 lens (PNGs and rgb.txt), a reference-format config and
    an ORBvoc.txt in; run 1 (`--threaded`) maps frames 0-35, run 2
    (`--load-map --localization`) restarts kidnapped at frame 12 over frames
    12-35 against the saved map; both in this process, so the kernels'
    launches are counted; then `python -m ...cli --help` in a subprocess."""
    from ceres_mono_orb_slam2_tpu_torch.ops import bow
    from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
    from ceres_mono_orb_slam2_tpu_torch.utils import native
    from ceres_mono_orb_slam2_tpu_torch.utils.config import load_config
    from ceres_mono_orb_slam2_tpu_torch.utils.datasets import imread_gray_plain, reader
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence

    fx, fy, cx, cy = TUM2_K
    t0 = time.perf_counter()
    seq = make_rendered_sequence(CLI_FRAMES, TUM_H, TUM_W, fx, fy, motion="strafe", step=CLI_STEP, seed=11,
                                 dist=np.array(TUM2_DIST, np.float32), cx=cx, cy=cy, device=device)
    u8 = np.clip(seq.images + 0.5, 0.0, 255.0).astype(np.uint8)
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    paths = write_tum_folder(os.path.join(root, "tum"), u8, seq.timestamps, range(CLI_FRAMES))
    write_tum_folder(os.path.join(root, "tum_kidnap"), u8, seq.timestamps, CLI_LOC_FRAMES)
    config = os.path.join(root, "TUM2.yaml")
    write_tum2_config(config, n_features=2000)
    cfg = load_config(config)
    ex = ORBExtractor(cfg.orb, device=device)
    corpus = []
    for i in range(0, CLI_MAP_FRAMES, 4):
        fe = ex.extract(u8[i])
        corpus.append(fe.desc[0][fe.valid[0]].cpu().numpy())
    voc = bow.train_vocabulary(np.concatenate(corpus), k=10, levels=4, seed=0, docs=corpus, device=device)
    voc_path = os.path.join(root, "ORBvoc.txt")
    bow.dump_orbvoc_text(voc, voc_path)
    log(f"[cli] rendered {CLI_FRAMES} frames {TUM_W}x{TUM_H} through the TUM2 lens and wrote them as a TUM "
        f"folder, the config and a vocabulary of {voc.n_words} words (k=10, levels=4) in "
        f"{time.perf_counter() - t0:.1f} s")
    checks = {}
    if native.available():
        same = all(np.array_equal(native.imread_gray(p), imread_gray_plain(p)) for p in paths)
        log(f"[cli] native library built ({native.library_path().name}); native decoder against the plain "
            f"one on the {len(paths)} PNGs: bit-exact {same}")
        checks["native decoder bit-exact against the plain one"] = same
    else:
        log(f"[cli] native library NOT built: {native.build_error()}")
    log(f"[cli] image reader: {reader()}")

    out1, out2 = os.path.join(root, "run1"), os.path.join(root, "run2")
    stats1, stats2 = os.path.join(root, "stats1.jsonl"), os.path.join(root, "stats2.jsonl")
    rc1, text1, wall1, launches1 = run_cli(
        ["--config", config, "--images", os.path.join(root, "tum"), "--voc", voc_path, "--threaded",
         "--max-frames", str(CLI_MAP_FRAMES), "--output-dir", out1, "--stats-out", stats1], device)
    s1 = cli_summary(text1)
    res1 = check_cli_outputs(out1, s1, seq, 1.0)
    n1 = CLI_MAP_FRAMES + s1.get("retracked", 0)
    rc2, text2, wall2, launches2 = run_cli(
        ["--config", config, "--images", os.path.join(root, "tum_kidnap"), "--voc", voc_path,
         "--load-map", os.path.join(out1, "map.npz"), "--localization", "--output-dir", out2,
         "--stats-out", stats2], device)
    s2 = cli_summary(text2)
    res2 = check_cli_outputs(out2, s2, seq, 2.0)
    n2 = len(CLI_LOC_FRAMES) + s2.get("retracked", 0)
    with open(stats2) as f:
        st2 = [json.loads(line) for line in f]
    methods = collections.Counter(st["method"] for st in st2)
    frame_launches = {graphs: mode_launches(cfg, voc, os.path.join(out1, "map.npz"), u8, seq.timestamps, device,
                                            graphs) for graphs in (True, False)} if device == "cuda" else {}
    helped = subprocess.run([sys.executable, "-m", "ceres_mono_orb_slam2_tpu_torch.cli", "--help"],
                            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                            timeout=300)
    tmp.cleanup()
    for name, s, wall, res, launches, n in (("run 1 (--threaded, frames 0-35)", s1, wall1, res1, launches1, n1),
                                           ("run 2 (--load-map --localization, frames 12-35)", s2, wall2, res2,
                                            launches2, n2)):
        log(f"[cli] {name}: {s.get('frames')} frames, state {s.get('state')}, {s.get('keyframes')} keyframes, "
            f"{s.get('map_points')} map points; tracking time median {s.get('median', float('nan')):.6f} s, mean "
            f"{s.get('mean', float('nan')):.6f} s; wall {wall:.1f} s; ATE of FrameTrajectory.txt "
            f"{res['ate']:.4f}% over {res['rows']} rows; launches {launches} over {n} extractions")
    log(f"[cli] run 2 loaded {s2.get('loaded_keyframes')} keyframes and {s2.get('loaded_map_points')} map "
        f"points; methods {dict(methods)}; first frame {st2[0]['method'] if st2 else None} ok "
        f"{st2[0]['ok'] if st2 else None}, its tracking {st2[0]['track_ms'] if st2 else float('nan'):.1f} ms")
    for graphs, modes in frame_launches.items():
        for mode, (n_api, n_graph, n_dev, method, ms, replays, kern) in modes.items():
            log(f"[cli] one frame against run 1's map, {mode}, {'graphs' if graphs else 'graphs=False'}: "
                f"method {method}, {n_api} host API launches ({n_graph} graph launches), {n_dev} device "
                f"kernels and copies, {ms:.1f} ms under the profiler; extraction replays {replays}, kernel "
                f"launches counted {kern}")
    log(f"[cli] python -m ceres_mono_orb_slam2_tpu_torch.cli --help: exit {helped.returncode}")
    checks.update({
        "run 1 exit code 0": rc1 == 0,
        "run 1 final state OK": s1.get("state") == "OK",
        **{f"run 1 {c}": ok for c, ok in res1["checks"].items()},
        "run 2 exit code 0": rc2 == 0,
        "run 2 final state OK": s2.get("state") == "OK",
        **{f"run 2 {c}": ok for c, ok in res2["checks"].items()},
        "run 2 loaded run 1's keyframes": s2.get("loaded_keyframes") == s1.get("keyframes"),
        "run 2 adds no keyframe": s2.get("keyframes") == s2.get("loaded_keyframes"),
        "run 2's first frame relocalizes": bool(st2) and st2[0]["method"] == "reloc" and st2[0]["ok"],
        "run 2 tracks every frame": len(st2) == len(CLI_LOC_FRAMES) and all(st["ok"] for st in st2),
        "--help in a subprocess exits 0": helped.returncode == 0 and "usage" in helped.stdout,
    })
    if device == "cuda":
        for kname in ("fast_nms", "gather_patches"):
            checks[f"run 1 {kname} launched once per extraction"] = launches1[kname] == n1
            checks[f"run 2 {kname} launched once per extraction"] = launches2[kname] == n2
        loc = frame_launches[True]["localization"]
        checks["a localization frame's extraction is one replay of its program, each kernel counted once"] = (
            loc[5] == 1 and loc[6] == {"fast_nms": 1, "gather_patches": 1})
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cli checks failed: {failed}")
    return {"cli": (launches1, n1), "cli_localization": (launches2, n2)}


def http_get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.read()


def post_menu(port: int, form: bytes) -> int:
    """POST a menu form; urllib follows the 303 to the page: 200."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/menu", data=form, method="POST",
                                 headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def viewer_threads() -> list:
    return sorted(t.name for t in threading.enumerate() if t.name.startswith("viewer-") and t.is_alive())


def refuses(port: int) -> bool:
    try:
        http_get(port, "/state.json")
    except OSError:
        return True
    return False


def poll_viewer(port: int, stop: threading.Event, answers: collections.Counter, errors: list):
    """A client of the live viewer: GET /frame.png, /map.png and
    /state.json in turn until `stop`, counting the answers and keeping the
    errors."""
    while not stop.is_set():
        for path in ("/frame.png", "/map.png", "/state.json"):
            try:
                http_get(port, path)
                answers[path] += 1
            except OSError as e:
                errors.append(f"{path}: {e!r}")
        stop.wait(0.05)


def phase_viewer(device: str = "cuda"):
    """The viewers on the path a user runs: [cli]'s strafe world at 640x480
    through the TUM2 lens and its config, `MonoSLAM(threaded=True)` fed at
    full rate. Run A without viewers; run B with `use_viewer=True` (a
    snapshot every VIEWER_EVERY frames) and the live viewer on a free port,
    polled by a client thread during the frames, then the menu: localization
    on and off, reset, and VIEWER_REINIT_FRAMES frames that initialise again;
    run C the CLI in this process with `--viewer --live-viewer 0
    --threaded` over a TUM folder, from a working directory of its own.
    Reports the renders, the ms of one map and one frame render and run B's
    median frame over run A's: what the viewers cost the tracker."""
    from ceres_mono_orb_slam2_tpu_torch import viewer as V
    from ceres_mono_orb_slam2_tpu_torch.live_viewer import MENU_DEFAULTS, PLACEHOLDER
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.utils import png
    from ceres_mono_orb_slam2_tpu_torch.utils.config import load_config
    from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence

    fx, fy, cx, cy = TUM2_K
    seq = make_rendered_sequence(VIEWER_FRAMES, TUM_H, TUM_W, fx, fy, motion="strafe", step=CLI_STEP, seed=11,
                                 dist=np.array(TUM2_DIST, np.float32), cx=cx, cy=cy, device=device)
    u8 = np.clip(seq.images + 0.5, 0.0, 255.0).astype(np.uint8)
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    config = os.path.join(root, "TUM2.yaml")
    write_tum2_config(config, n_features=2000)
    cfg = load_config(config)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def track(slam, frames) -> list:
        ms = []
        for i in frames:
            t = time.perf_counter()
            slam.track_monocular(u8[i], float(seq.timestamps[i]))
            ms.append((time.perf_counter() - t) * 1e3)
        return ms

    # run A: no viewer
    slam = MonoSLAM(cfg, device=device, threaded=True)
    sync()
    k.reset_launch_counts()
    ms_a = track(slam, range(VIEWER_FRAMES))
    slam.shutdown()
    sync()
    run_a = (dict(k.launch_counts), VIEWER_FRAMES + slam.tracker.n_retracked_frames)
    state_a, kfs_a = slam.get_tracking_state(), slam.map.n_keyframes()

    # run B: both viewers, a client polling the live one
    snaps = os.path.join(root, "snapshots")
    slam = MonoSLAM(cfg, device=device, threaded=True, use_viewer=True, live_viewer_port=0)
    slam.viewer.out_dir, slam.viewer.every = snaps, VIEWER_EVERY
    lv = slam.live_viewer
    port = lv.port
    threads_up = viewer_threads()
    stop, answers, poll_errors = threading.Event(), collections.Counter(), []
    client = threading.Thread(target=poll_viewer, args=(port, stop, answers, poll_errors), name="client")
    sync()
    k.reset_launch_counts()
    client.start()
    try:
        ms_b = track(slam, range(VIEWER_FRAMES))
        stop.set()
        client.join(timeout=JOIN_TIMEOUT_S)
        deadline = time.perf_counter() + 60.0  # the render of the last frame
        while lv._last_frame_id != slam.tracker.current.id and time.perf_counter() < deadline:
            time.sleep(0.05)
        frame_png, map_png = http_get(port, "/frame.png"), http_get(port, "/map.png")
        st_b = json.loads(http_get(port, "/state.json"))
        # one frame render and one map render, each the copy under the map
        # lock and the drawing and encoding outside it, as the live viewer
        # makes them
        render_ms = {}
        for view in ("frame", "map"):
            t = time.perf_counter()
            for _ in range(RENDER_REPEATS):
                with slam.map.update_lock:
                    g = lv.renderer.frame_geometry() if view == "frame" else lv.renderer.map_geometry()
                if view == "frame":
                    lv.renderer.draw_frame(io.BytesIO(), geom=g)
                else:
                    lv.renderer.snapshot(io.BytesIO(), geom=g)
            render_ms[view] = (time.perf_counter() - t) * 1e3 / RENDER_REPEATS
        codes = [post_menu(port, b"localization=on&points=on&keyframes=on&graph=on")]
        loc_on = slam.tracker.localization_only
        codes.append(post_menu(port, b"points=on&keyframes=on&graph=on"))
        loc_off = not slam.tracker.localization_only
        codes.append(post_menu(port, b"reset=1"))
        emptied = (slam.map.n_keyframes(), slam.map.n_map_points())
        menu_after_reset = json.loads(http_get(port, "/state.json"))["menu"]
        ms_re = track(slam, range(VIEWER_REINIT_FRAMES))
        state_re, kfs_re = slam.get_tracking_state(), slam.map.n_keyframes()
        n_renders, n_render_errors = lv.n_renders, lv.n_render_errors
    finally:
        stop.set()
        slam.shutdown()
    sync()
    run_b = (dict(k.launch_counts), VIEWER_FRAMES + VIEWER_REINIT_FRAMES + slam.tracker.n_retracked_frames)
    threads_down, port_refused = viewer_threads(), refuses(port)
    snap_names = sorted(os.listdir(snaps))
    snap_shapes = set()
    for name in snap_names:
        with open(os.path.join(snaps, name), "rb") as f:
            snap_shapes.add(png.decode(f.read()).shape)
    frame_img, map_img = png.decode(frame_png), png.decode(map_png)
    want_snaps = [f"map_{i:05d}.png" for i in range(VIEWER_EVERY, VIEWER_FRAMES + VIEWER_REINIT_FRAMES + 1,
                                                    VIEWER_EVERY)]

    # run C: the CLI
    tum = os.path.join(root, "tum")
    write_tum_folder(tum, u8, seq.timestamps, range(VIEWER_CLI_FRAMES))
    work = os.path.join(root, "cli_cwd")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc, text, wall_c, launches_c = run_cli(["--config", config, "--images", tum, "--viewer", "--live-viewer",
                                                "0", "--threaded", "--output-dir", os.path.join(root, "cli_out")],
                                               device)
    finally:
        os.chdir(cwd)
    s_c = cli_summary(text)
    run_c = (launches_c, VIEWER_CLI_FRAMES + s_c.get("retracked", 0))
    cli_snaps = sorted(os.listdir(os.path.join(work, "viewer_out")))
    cli_shapes = set()
    for name in cli_snaps:
        with open(os.path.join(work, "viewer_out", name), "rb") as f:
            cli_shapes.add(png.decode(f.read()).shape)
    threads_after_cli = viewer_threads()
    tmp.cleanup()

    med_a, med_b = float(np.median(ms_a)), float(np.median(ms_b))
    log(f"[viewer] run A (threaded, no viewer): {VIEWER_FRAMES} frames, state {state_a}, {kfs_a} keyframes; "
        f"track_monocular ms median {med_a:.2f}, p95 {np.percentile(ms_a, 95):.2f}; launches {run_a[0]} over "
        f"{run_a[1]} extractions")
    log(f"[viewer] run B (threaded, use_viewer every {VIEWER_EVERY}, live viewer on port {port}): track_monocular "
        f"ms median {med_b:.2f}, p95 {np.percentile(ms_b, 95):.2f} = {med_b / med_a:.3f}x run A's median; "
        f"renders {n_renders}, render errors {n_render_errors}; client answers {dict(answers)}, errors "
        f"{len(poll_errors)} {poll_errors[:3]}; /frame.png {frame_img.shape}, /map.png {map_img.shape}; one "
        f"frame render {render_ms['frame']:.2f} ms, one map render {render_ms['map']:.2f} ms (mean of "
        f"{RENDER_REPEATS}, copy, draw and PNG encode); state {st_b['state']} with {st_b['n_keyframes']} "
        f"keyframes")
    log(f"[viewer] run B menu: POST codes {codes}, localization on {loc_on} then off {loc_off}; after reset "
        f"{emptied[0]} keyframes and {emptied[1]} map points, menu {menu_after_reset}; {VIEWER_REINIT_FRAMES} "
        f"frames later state {state_re} with {kfs_re} keyframes (median {np.median(ms_re):.2f} ms); "
        f"snapshots {snap_names} {sorted(snap_shapes)}; threads up {threads_up}, after shutdown "
        f"{threads_down}, port refused {port_refused}; launches {run_b[0]} over {run_b[1]} extractions")
    log(f"[viewer] run C (CLI --viewer --live-viewer 0 --threaded, {VIEWER_CLI_FRAMES} frames): exit {rc}, "
        f"state {s_c.get('state')}, {s_c.get('keyframes')} keyframes, tracking median "
        f"{s_c.get('median', float('nan')):.6f} s, wall {wall_c:.1f} s; viewer_out {cli_snaps} "
        f"{sorted(cli_shapes)}; viewer threads after {threads_after_cli}; launches {launches_c} over "
        f"{run_c[1]} extractions")
    checks = {
        "run A tracks": state_a == "OK" and kfs_a >= 2,
        "both viewer threads up": threads_up == ["viewer-http", "viewer-render"],
        "the client was answered on every endpoint, without an error": (
            min(answers[p] for p in ("/frame.png", "/map.png", "/state.json")) > 0 and not poll_errors),
        "/frame.png: the image and the bar, not the placeholder": (frame_png != PLACEHOLDER and frame_img.shape
                                                                   == (TUM_H + V.BAR_H, TUM_W, 3)),
        "/map.png: the map canvas": map_img.shape == (V.MAP_H, V.MAP_W, 3),
        "/state.json: OK with >= 2 keyframes": st_b["state"] == "OK" and st_b["n_keyframes"] >= 2,
        "menu POSTs answered": codes == [200, 200, 200],
        "localization toggles on and off": loc_on and loc_off,
        "reset empties the map": emptied == (0, 0),
        "reset restores the menu defaults with follow on": menu_after_reset == dict(MENU_DEFAULTS, follow=True),
        ">= 2 keyframes again after the reset": state_re == "OK" and kfs_re >= 2,
        "snapshots every VIEWER_EVERY frames, on the map canvas": (snap_names == want_snaps
                                                                   and snap_shapes == {(V.MAP_H, V.MAP_W, 3)}),
        "renders made, none failed": n_renders > 0 and n_render_errors == 0,
        "no viewer thread after shutdown": threads_down == [],
        "the port refuses connections after shutdown": port_refused,
        "run C exit code 0": rc == 0 and s_c.get("state") == "OK",
        "run C: viewer_out/map_00010.png on the map canvas": (cli_snaps == ["map_00010.png"]
                                                              and cli_shapes == {(V.MAP_H, V.MAP_W, 3)}),
        "run C: no viewer thread after the CLI": threads_after_cli == [],
    }
    if device == "cuda":
        for name, (launches, n) in (("run A", run_a), ("run B", run_b), ("run C", run_c)):
            for kname in ("fast_nms", "gather_patches"):
                checks[f"{name} {kname} launched once per extraction"] = launches[kname] == n
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"viewer checks failed: {failed}")
    return {"viewer_a": run_a, "viewer": run_b, "viewer_cli": run_c}


def kitti_ba_problem(seed: int = 0, P: int = SHARDED_POSES, M: int = SHARDED_POINTS,
                     per_point: int = SHARDED_VIEWS):
    """A global-BA problem at KITTI map scale, as numpy: P poses along a
    straight path (0.3 m apart), M points each seen by `per_point`
    consecutive poses it lies in front of (ordered along the path), 0.7 px
    noise and 2% gross outliers as `ba_problem`, the first two poses fixed.
    Returns (the solver's arguments, the mask of the observations without
    a gross error)."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 620.0], [0, 500.0, 188.0], [0, 0, 1]], np.float32)
    first = np.sort(rng.integers(0, P - per_point + 1, M))
    mid = 0.3 * (first + (per_point - 1) / 2)
    pts = np.stack([mid + rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(6, 20, M)], -1)
    R = np.repeat(np.eye(3)[None], P, 0)
    t = np.stack([-0.3 * np.arange(P), np.zeros(P), np.zeros(P)], -1)
    op = (first[:, None] + np.arange(per_point)).reshape(-1)
    oj = np.repeat(np.arange(M), per_point)
    Xc = pts[oj] + t[op]
    uv = K[:2, :2].diagonal() * Xc[:, :2] / Xc[:, 2:] + K[:2, 2]
    uv += rng.standard_normal(uv.shape) * 0.7
    bad = rng.random(len(uv)) < 0.02
    uv[bad] += rng.uniform(20, 60, (bad.sum(), 2))
    t0 = t + rng.standard_normal(t.shape) * 0.02
    t0[:2] = t[:2]
    fixed = np.zeros(P, bool)
    fixed[:2] = True
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (K, f32(R), f32(t0), f32(pts + rng.standard_normal(pts.shape) * 0.05), op, oj, f32(uv),
            f32(rng.choice([1.0, 0.69], len(op))), np.ones(len(op), bool), fixed,
            np.ones(M, bool)), ~bad


def sharded_probe(mesh, axis: str):
    """The collectives the port makes, on this rank's tensors, with their
    results: all_reduce SUM on float32 and int32, all_reduce MIN on int64,
    all_gather on float32 and int32 (a refusal raises alike on every rank).
    Also the host clock when the rank got here (after its start-up and
    first mesh), and the ms of one all_reduce SUM (mean of 50) of the
    (P, 6) and (M, 3) float32 sums the CG BA makes, on this rank's device
    and, for gloo, on the host."""
    import torch.distributed as dist

    from ceres_mono_orb_slam2_tpu_torch.parallel.mesh import axis_size, mesh_device

    out = {"ready_at": time.time()}
    dev, group, r = mesh_device(mesh), mesh.get_group(axis), mesh.get_local_rank(axis)
    where = [dev] if dist.get_backend(group) == "nccl" else [dev, torch.device("cpu")]
    for name, shape in (("(P, 6)", (SHARDED_POSES, 6)), ("(M, 3)", (SHARDED_POINTS, 3))):
        for d in where:
            x = torch.ones(shape, device=d)
            dist.all_reduce(x, group=group)
            ms = timed(lambda: [dist.all_reduce(x, group=group) for _ in range(50)])[1] / 50
            out[f"all_reduce ms {name} {d.type}"] = round(ms, 3)
    for dtype, op in ((torch.float32, "SUM"), (torch.int32, "SUM"), (torch.int64, "MIN")):
        x = torch.full((4,), r + 1, dtype=dtype, device=dev)
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
        out[f"all_reduce {op} {str(dtype)[6:]}"] = x.tolist()[0]
    for dtype in (torch.float32, torch.int32):
        parts = [torch.zeros(2, dtype=dtype, device=dev) for _ in range(axis_size(mesh, axis))]
        dist.all_gather(parts, torch.full((2,), r, dtype=dtype, device=dev), group=group)
        out[f"all_gather {str(dtype)[6:]}"] = [p[0].item() for p in parts]
    return out


def sharded_step_rank(mesh, cfg, images, state, repeats: int):
    """This rank's part of the dp x mp step on the full inputs, between a
    reset and a read of the launch counts: a first step (its result), then
    `repeats` timed steps. Returns (the full StepResult, the counts, the ms
    of each timed step)."""
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as ms

    k.reset_launch_counts()
    res, ms_steps = ms.step_over_mesh(mesh, cfg, *images.shape[1:], images, state, repeats)
    return res, dict(k.launch_counts), ms_steps


def phase_sharded(cfg):
    """The multi-device half of `parallel/` on 4 ranks: sharded CG BA at
    KITTI map scale (twice), the sharded essential graph on a 1000-pose
    ring and the dp x mp step, each against the single-process solve on the
    same card."""
    from ceres_mono_orb_slam2_tpu_torch.ops import optim, sim3opt
    from ceres_mono_orb_slam2_tpu_torch.parallel import mesh as pmesh
    from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as ms
    from ceres_mono_orb_slam2_tpu_torch.parallel import sharded_ba as sba
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    n = SHARDED_RANKS
    backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    where = "one card each" if backend == "nccl" else f"cuda:0 ({torch.cuda.get_device_name(0)})"
    log(f"[sharded] transport: {backend}, {n} ranks on {where}")
    on = lambda a: torch.as_tensor(np.asarray(a), device="cuda")  # noqa: E731

    # single-process solves on this card, the references
    ba, clean = kitti_ba_problem(P=SHARDED_POSES, M=SHARDED_POINTS, per_point=SHARDED_VIEWS)
    dev_ba = [on(a) for a in ba]

    def huber(R, t, points, mask=ba[8]):  # the Huber cost of these poses and points over `mask`
        return float(optim.bundle_adjustment_cg(*dev_ba[:1], on(R), on(t), on(points), *dev_ba[4:8],
                                                on(mask), *dev_ba[9:], iters=0).cost)

    cost0, clean0 = huber(*ba[1:4]), huber(*ba[1:4], clean)
    single_ba, ms_ba1 = timed(lambda: optim.bundle_adjustment_cg(*dev_ba, iters=20, cg_iters=50))
    # the same solve as the loop closer's CG global BA runs it: each LM
    # iteration a replay of one captured program (the first call captures)
    cg_step = graphs.CapturedFunction(optim.cg_lm_iteration, "cuda", name="gba_lm_cg", owner="mapper")
    replay_ba = lambda: on_mapper_stream(  # noqa: E731
        lambda: optim.bundle_adjustment_cg(*dev_ba, iters=20, step=cg_step))
    (first_ba, ms_first_ba), (rep_ba, ms_rep_ba) = timed(replay_ba), timed(replay_ba)
    same_rep_ba = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(single_ba, first_ba, rep_ba))
    (Rt, tt), (R0, t0, s0, ei, ej, Rm, tm, sm, fixed) = drifted_ring(SHARDED_RING, seed=2)
    f32 = lambda *a: tuple(np.asarray(x, np.float32) for x in a)  # noqa: E731
    ring = f32(R0, t0, s0) + (ei, ej) + f32(Rm, tm, sm) + (np.ones(len(ei), bool), fixed)
    dev_ring = [on(a) for a in ring]
    eg_cost0 = float(sim3opt.optimize_essential_graph(*dev_ring, gn_iters=0).cost)
    single_eg, ms_eg1 = timed(lambda: sim3opt.optimize_essential_graph(*dev_ring))
    images, state = ms.synthetic_stream_state(cfg, N_STREAMS, MAP_POINTS, seed=0, h=H, w=W,
                                              device="cuda")
    images = np.clip(images + 0.5, 0.0, 255.0).astype(np.uint8)
    step = ms.make_multistream_step(cfg, H, W, device="cuda")
    single_step = step(images, state)
    ms_step1 = float(np.median([timed(lambda: step(images, state))[1] for _ in range(5)]))
    torch.cuda.empty_cache()

    obs, dpmp, repeats = ((n,), ("obs",)), ((2, n // 2), ("dp", "mp")), 5
    host_state = ms.StreamState(*(a.cpu().numpy() for a in state))
    calls = [(sharded_probe, *obs, ("obs",), {}),
             (sba.bundle_adjustment_cg_sharded, *obs, ("obs",) + ba, dict(iters=20, cg_iters=50)),
             (sba.bundle_adjustment_cg_sharded, *obs, ("obs",) + ba, dict(iters=20, cg_iters=50)),
             (sba.optimize_essential_graph_sharded, *obs, ("obs",) + ring, {}),
             (sharded_step_rank, *dpmp, (cfg, images, host_state, repeats), {})]
    t0, t0_wall = time.perf_counter(), time.time()
    # 2 CPU threads a rank: 4 ranks share the host's cores with gloo's own threads
    ranks = pmesh.spawn(pmesh.run_calls, n, backend=backend, device="cuda", args=(calls,),
                        timeout_s=SHARDED_TIMEOUT_S, num_threads=2)
    spawn_s = time.perf_counter() - t0
    (probe, _), (ba1, s_ba1), (ba2, s_ba2), (eg, s_eg), ((res, _, ms_steps), _) = ranks[0]
    # the solves' results and the step's (its launch counts and times are each rank's own)
    same_ranks = all(_same([c[0] for c in r[1:4]] + [r[4][0][0]],
                           [c[0] for c in ranks[0][1:4]] + [res]) for r in ranks[1:])
    calls_s = sum(sec for _, sec in ranks[0])
    ready_s = max(r[0][0].pop("ready_at") for r in ranks) - t0_wall
    log(f"[sharded] {n} ranks in {spawn_s:.1f} s: the last ready {ready_s:.1f} s after the start "
        f"(processes, imports, CUDA, process group, first mesh), {spawn_s - ready_s - calls_s:.1f} s "
        f"in later meshes, results and exit; collectives on cuda tensors: {probe}; every rank "
        f"returns the same bits: {same_ranks}")

    # CG BA at KITTI map scale
    P, M, O = ba[1].shape[0], ba[3].shape[0], ba[4].shape[0]
    twice = _same(ba1, ba2)
    c1, c_single = float(ba1.cost), float(single_ba.cost)
    clean1 = huber(ba1.R, ba1.t, ba1.points, clean)
    n_inl, n_inl1 = int(ba1.inlier_obs.sum()), int(single_ba.inlier_obs.sum())
    d_R = float(np.abs(ba1.R - single_ba.R.cpu().numpy()).max())
    d_t = float(np.abs(ba1.t - single_ba.t.cpu().numpy()).max())
    d_p = float(np.abs(ba1.points - single_ba.points.cpu().numpy()).max())
    log(f"[sharded] bundle_adjustment_cg_sharded P={P} M={M} O={O} over {n} ranks, 20 LM x 50 CG: "
        f"Huber cost {cost0:.1f} -> {c1:.3f} (single process {c_single:.3f}, relative "
        f"{abs(c1 / c_single - 1):.2e}), over the observations without a gross error {clean0:.1f} -> "
        f"{clean1:.3f}, inliers {n_inl} (single {n_inl1}); max |dR| {d_R:.2e}, "
        f"|dt| {d_t:.2e}, |dpoint| {d_p:.2e}; {s_ba1 * 1e3:.1f} / {s_ba2 * 1e3:.1f} ms (single "
        f"process {ms_ba1:.1f} ms); two runs bit-identical: {twice}")
    log(f"[sharded] the single-process solve with its LM iterations replayed (optim.cg_lm_iteration): "
        f"{ms_rep_ba:.1f} ms against {ms_ba1:.1f} eager (first call, capturing: {ms_first_ba:.1f} ms), "
        f"equal to the eager solve to the bit: {same_rep_ba}; pool MB {round(cg_step.pool_bytes() / 1e6, 1)}")
    # the essential graph
    centre = lambda R, t, s: -np.einsum("pji,pj->pi", R, t / s[:, None])  # noqa: E731
    c_true, c_0 = centre(Rt, tt, np.ones(len(tt))), centre(*(a.astype(np.float64) for a in ring[:3]))
    c_1 = centre(*(a.astype(np.float64) for a in (eg.R, eg.t, eg.s)))
    span = lambda c: float(np.linalg.norm(c[-1] - c[0]) - np.linalg.norm(c_true[-1] - c_true[0]))  # noqa: E731
    gap0, gap1 = span(c_0), span(c_1)
    err0, err1 = float(np.abs(c_0 - c_true).max()), float(np.abs(c_1 - c_true).max())
    e_R, e_t, e_s = (float(np.abs(a - b.cpu().numpy()).max()) for a, b in
                     ((eg.R, single_eg.R), (eg.t, single_eg.t), (eg.s, single_eg.s)))
    log(f"[sharded] optimize_essential_graph_sharded ring of {SHARDED_RING} poses over {n} ranks, "
        f"30 GN x 100 PCG: cost {eg_cost0:.4e} -> {float(eg.cost):.4e}, loop gap error {gap0:.4f} -> "
        f"{gap1:.4f}, max centre error {err0:.4f} -> {err1:.4f} (radius 5); against the single "
        f"process: max |dR| {e_R:.2e}, |dt| {e_t:.2e}, |ds| {e_s:.2e}; {s_eg * 1e3:.1f} ms "
        f"(single process {ms_eg1:.1f} ms)")
    # the dp x mp step
    err_R = float(np.abs(res.Rcw - single_step.Rcw.cpu().numpy()).max())
    err_t = float(np.abs(res.tcw - single_step.tcw.cpu().numpy()).max())
    n_m, n_i = res.n_matches.tolist(), res.n_inliers.tolist()
    n_m1, n_i1 = single_step.n_matches.tolist(), single_step.n_inliers.tolist()
    per_rank = [r[4][0][1] for r in ranks]
    summed = {name: sum(c[name] for c in per_rank) for name in per_rank[0]}
    ms_step = float(np.median(ms_steps))
    log(f"[sharded] shard_step_over_mesh (dp, mp) = {dpmp[0]}, S={N_STREAMS} at {W}x{H}, "
        f"{cfg.orb.n_features} features, {MAP_POINTS} map points a stream: matches {n_m} (single "
        f"process {n_m1}), inliers {n_i} (single {n_i1}); max |R - R1| {err_R:.2e}, |t - t1| "
        f"{err_t:.2e}; kernel launches of {1 + repeats} steps per rank {per_rank}; step "
        f"{ms_step:.2f} ms (median of {repeats}: {[round(m, 1) for m in ms_steps]}; single "
        f"process S={N_STREAMS} {ms_step1:.2f} ms)")
    checks = {
        "all_reduce SUM on float32 and int32, MIN on int64, all_gather on float32 and int32":
            [probe[f"all_reduce {o}"] for o in ("SUM float32", "SUM int32", "MIN int64")]
            == [n * (n + 1) / 2, n * (n + 1) / 2, 1]
            and probe["all_gather float32"] == probe["all_gather int32"] == list(range(n)),
        "every rank returns the same bits": same_ranks,
        "two sharded BA runs bit-identical": twice,
        "the replayed single-process CG BA equals the eager one to the bit": same_rep_ba,
        # the JAX test's problem has no gross errors; here the 2% of them hold the
        # whole cost near 0.4x its start, so its bar holds on the other 98%
        "BA Huber cost below 0.5x the initial, and below 0.1x over the observations "
        "without a gross error": c1 < 0.5 * cost0 and clean1 < 0.1 * clean0,
        "BA cost within 1e-5 relative of the single process": abs(c1 / c_single - 1) <= 1e-5,
        "BA inlier counts within 0.1%": abs(n_inl - n_inl1) <= 1e-3 * n_inl1,
        "BA poses R 5e-4, t 5e-3 of the single process (the JAX test's)": d_R <= 5e-4 and d_t <= 5e-3,
        "essential graph R 5e-4, t 5e-3, s 1e-3 of the single process":
            e_R <= 5e-4 and e_t <= 5e-3 and e_s <= 1e-3,
        "the ring closes (cost / 100, loop gap / 10) and its centres move towards the truth":
            float(eg.cost) < 1e-2 * eg_cost0 and abs(gap1) < 0.1 * abs(gap0) and err1 < err0,
        "step counts equal to the single process": n_m == n_m1 and n_i == n_i1,
        "step R within 1e-5 and t within 1e-4": err_R < 1e-5 and err_t < 1e-4,
        "every stream matches and solves": min(n_m) > 100 and min(n_i) > 100,
        "one launch of each kernel per rank and step":
            all(c == {"fast_nms": 1 + repeats, "gather_patches": 1 + repeats} for c in per_rank),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sharded checks failed: {failed}")
    return {"sharded": (summed, n * (1 + repeats))}


def _same(a, b) -> bool:
    """Equal bits, field by field, of two results of `mesh.to_host`."""
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def record_phases(tracker) -> list:
    """Every device phase of `tracker` from now on, in order: (kind,
    th_local, FusedOut, features, packed control buffer, the LM iterations
    each round of its two pose solves ran)."""
    seen = []
    dispatch, chained = tracker._fused_dispatch, tracker._dispatch_chained

    def fused(args):
        out, feats, ctl, lblock = dispatch(args)
        seen.append(("fused", float(args[9]), out, feats, ctl, tracker._fused_step.pose_iters.clone()))
        return out, feats, ctl, lblock

    def chain(image, p):
        out, feats, copy = chained(image, p)
        seen.append(("chained", 1.0, out, feats, copy[0], tracker._fused_step.pose_iters.clone()))
        return out, feats, copy

    tracker._fused_dispatch, tracker._dispatch_chained = fused, chain
    return seen


def record_solvers(slam) -> dict:
    """Every non-fused frame's features, BoW word ids, RANSAC result and
    unfused pose solve (its `PoseOptResult`, `iters` last) of `slam` from
    now on, as host arrays in call order."""
    seen = {"features": [], "words": [], "ransac": [], "pose": []}
    tr, db = slam.tracker, slam.keyframe_db
    build, transform, stages, solve = tr.build_frame, db.transform, tr._ransac_stages, tr._solve_pose

    def solve_pose(*a):
        res = solve(*a)
        seen["pose"].append(tuple(x.cpu().numpy() for x in res))
        return res

    def build_frame(image, timestamp):
        f = build(image, timestamp)
        seen["features"].append(tuple(np.array(getattr(f, n)) for n in
                                      ("kp_und", "kp_octave", "kp_angle", "desc", "kp_valid")))
        return f

    def word_ids(desc, valid):
        out = transform(desc, valid)
        seen["words"].append(out[0].cpu().numpy())
        return out

    def ransac_stages():
        st = stages()

        def refit(*a):
            res = st.refit(*a)
            seen["ransac"].append(tuple(x.cpu().numpy() for x in res))
            return res

        return st._replace(refit=refit)

    tr.build_frame, db.transform, tr._ransac_stages = build_frame, word_ids, ransac_stages
    tr._solve_pose = solve_pose
    return seen


def first_difference(a: list, b: list):
    """Where two recorded device-phase lists first differ in a bit, or None."""
    if len(a) != len(b):
        return f"{len(a)} against {len(b)} device phases"
    for i, (x, y) in enumerate(zip(a, b)):
        if x[:2] != y[:2]:
            return f"device phase {i}: {x[:2]} against {y[:2]}"
        named = lambda r: ([(f"out.{n}", t) for n, t in zip(r[2]._fields, r[2])]  # noqa: E731
                           + [(f"feats.{n}", t) for n, t in zip(r[3]._fields, r[3])] + [("ctl", r[4])]
                           + [("pose_iters", r[5])])
        for (name, u), (_, v) in zip(named(x), named(y)):
            if u.dtype != v.dtype or u.shape != v.shape or not torch.equal(u.cpu(), v.cpu()):
                return f"device phase {i} ({x[0]}): {name}"
    return None


def mapper_programs(slam) -> list:
    """The mapper's `CapturedFunction`s: local mapping's, then loop
    closing's."""
    return slam.local_mapper.captured() + (slam.loop_closer.captured() if slam.loop_closer else [])


def program_summaries(slam) -> list:
    """(name, captures, replays, kept, dropped, shared pool MB) of each of
    the mapper's captured programs; every replay ran on the mapper stream,
    since a call off its owner's stream raises (`[graphs]` checks that)."""
    return [(d["name"], d["captures"], d["replays"], d["kept"], d["dropped"], round(d["pool_mb"], 1))
            for d in (f.summary() for f in mapper_programs(slam))]


def mapper_stream_name() -> str:
    """The mapper stream of the card, as the reports name it."""
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    s = graphs.owner_stream("cuda", "mapper")
    return f"{graphs.stream_name(s)} stream ({hex(s.cuda_stream)})"


def record_passes(local_mapper) -> list:
    """After every mapping pass of `local_mapper` from now on: each
    keyframe's pose and each map point's position, by id."""
    seen, process = [], local_mapper._process

    def run(kf):
        process(kf)
        m = local_mapper.map
        seen.append(({k: (f.Rcw.copy(), f.tcw.copy()) for k, f in m.keyframes.items()},
                     {i: np.array(mp.pos) for i, mp in m.map_points.items()}))

    local_mapper._process = run
    return seen


def first_map_difference(a: list, b: list):
    """Where two `record_passes` lists first differ in a bit, or None."""
    if len(a) != len(b):
        return f"{len(a)} against {len(b)} mapping passes"
    for i, ((kfa, mpa), (kfb, mpb)) in enumerate(zip(a, b)):
        if kfa.keys() != kfb.keys() or mpa.keys() != mpb.keys():
            return f"pass {i}: keyframe or map point ids"
        for k in kfa:
            if not all(np.array_equal(x, y) for x, y in zip(kfa[k], kfb[k])):
                return f"pass {i}: keyframe {k}"
        for j in mpa:
            if not np.array_equal(mpa[j], mpb[j]):
                return f"pass {i}: map point {j}"
    return None


def first_pose_difference(a: list, b: list):
    if len(a) != len(b):
        return f"{len(a)} against {len(b)} poses"
    for i, (x, y) in enumerate(zip(a, b)):
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            return f"pose {i}"
    return None


def graph_pair(cfg, **kw) -> list:
    """[(system, its recorded device phases)] for a MonoSLAM that replays
    its programs and one that runs op by op (graphs=False)."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM

    pair = []
    for graphs in (True, False):
        slam = MonoSLAM(cfg, device="cuda", graphs=graphs, **kw)
        pair.append((slam, record_phases(slam.tracker)))
    return pair


def program_captures(slam) -> dict:
    """Captures so far of each of the tracker's and the loop closer's
    programs, by name."""
    progs = slam.tracker.captured() + (slam.loop_closer.captured() if slam.loop_closer else [])
    return {f.name: f.n_captures for f in progs}


def recaptured(slam, after_prewarm: dict) -> list:
    """The programs that prewarm captured and that captured again since (a
    live frame that met a key prewarm missed)."""
    now = program_captures(slam)
    return [name for name, n in after_prewarm.items() if n and now[name] != n]


def first_fused_ms(slam, timestamps, frame_ms) -> float:
    """The ms of the first frame that `slam`'s tracker fused, from the host
    ms of each frame in `timestamps`' order."""
    ts = next(st["timestamp"] for st in slam.tracker.frame_stats if st["method"] == "fused")
    return frame_ms[[float(t) for t in timestamps].index(float(ts))]


def lockstep(pair, frames, images, timestamps):
    """Each frame through both systems in turn: per system its poses and the
    host ms of each `track_monocular` call (ending in a synchronisation)."""
    poses, frame_ms = [[] for _ in pair], [[] for _ in pair]
    for i in frames:
        for j, (slam, _) in enumerate(pair):
            torch.cuda.synchronize()
            t = time.perf_counter()
            poses[j].append(slam.track_monocular(images[i], float(timestamps[i])))
            torch.cuda.synchronize()
            frame_ms[j].append((time.perf_counter() - t) * 1e3)
    return poses, frame_ms


def iter_stats(iters) -> dict:
    """Mean and max over calls of the LM iterations each round of a pose
    solve ran: `iters` (calls, ..., rounds) of `PoseOptResult.iters`."""
    a = np.asarray(iters, dtype=np.float64).reshape(-1, np.shape(iters)[-1])
    return {"mean": [round(float(x), 2) for x in a.mean(0)], "max": [int(x) for x in a.max(0)],
            "calls": len(a)}


def api_launches(fn):
    """(fn()'s result, the host API calls that launch or copy by name, the
    device kernels by name) of one call under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    api, dev = collections.Counter(), collections.Counter()
    for name, on_device in trace_events(prof):
        if on_device:
            dev[name] += 1
        elif name.startswith("cu") and ("Launch" in name or "Memcpy" in name):
            api[name] += 1
    return out, api, dev


def eager_mapper(slam):
    """`slam` with its local mapping and loop closing op by op (their
    graphs=False), its tracker still replaying: a pair of it and the system
    as made compares the mapper's programs alone, without the ~1 s an eager
    tracker spends a frame (the other pairs hold the tracker's)."""
    from ceres_mono_orb_slam2_tpu_torch.models.localmapping import LocalMapping

    lm = LocalMapping(slam.config, slam.map, loop_closer=slam.loop_closer, device="cuda", graphs=False)
    slam.local_mapper = slam.tracker.local_mapper = slam.loop_closer.local_mapper = lm
    lc = slam.loop_closer
    lc._sim3_step, lc._eg_step, lc._gba_steps = None, None, {}  # its graphs=False
    return slam


def graphs_loop_pair(checks: dict):
    """The closed geometric circle serial through a MonoSLAM with graphs and
    one whose mapper runs op by op (`eager_mapper`) in turn: each closure's
    essential graph (R, t, s), the keyframe poses after the frame of each
    closure and every frame's pose equal to the bit."""
    from ceres_mono_orb_slam2_tpu_torch.ops import sim3opt
    from ceres_mono_orb_slam2_tpu_torch.utils.geosim import frame_image

    systems = [loop_system()[0], eager_mapper(loop_system()[0])]
    eg, closures, poses, frame_ms, current = ([], []), ([], []), ([], []), ([], []), [0]
    solve = sim3opt.optimize_essential_graph

    def recorded(*a, **kw):
        res = solve(*a, **kw)
        eg[current[0]].append(tuple(x.cpu().numpy() for x in (res.R, res.t, res.s)))
        return res

    sim3opt.optimize_essential_graph = recorded
    try:
        for i in range(LOOP_FRAMES):
            for j, slam in enumerate(systems):
                current[0] = j
                T, ms = timed(lambda: slam.track_monocular(frame_image(i, TUM_H, TUM_W), i / 30.0))
                poses[j].append(T)
                frame_ms[j].append(ms)
                if slam.map_changed():
                    closures[j].append((i, {k: (f.Rcw.copy(), f.tcw.copy())
                                            for k, f in slam.map.keyframes.items()}))
    finally:
        sim3opt.optimize_essential_graph = solve
    for slam in systems:
        slam.shutdown()
    same_eg = len(eg[0]) == len(eg[1]) and all(_same(a, b) for a, b in zip(*eg))
    same_closures = [i for i, _ in closures[0]] == [i for i, _ in closures[1]] and all(
        a.keys() == b.keys() and all(np.array_equal(x, y) for k in a for x, y in zip(a[k], b[k]))
        for (_, a), (_, b) in zip(*closures))
    diff = first_pose_difference(*poses)
    stages, stages_e = ([(round(st["essential_graph_ms"], 1), round(st["essential_graph_solve_ms"], 1), st["edges"],
                          round(st.get("gba_ms", float("nan")), 1))
                         for st in slam.loop_closer.loop_stats] for slam in systems)
    log(f"[graphs] geo-circle-{LOOP_FRAMES} serial: {len(eg[0])} / {len(eg[1])} essential graphs, R, t, s "
        f"equal to the bit: {same_eg}; closures at frames {[i for i, _ in closures[0]]}, keyframe poses "
        f"after each equal to the bit: {same_closures}; every frame's pose: {diff is None}"
        f"{'' if diff is None else ' (' + diff + ')'}; essential graph ms, its device solve ms, edges, global "
        f"BA ms: graphs "
        f"{stages}, eager mapper "
        f"{stages_e}; frame of the closure ms graphs {max(frame_ms[0]):.1f}, eager mapper "
        f"{max(frame_ms[1]):.1f}; "
        f"the mapper's programs {program_summaries(systems[0])}")
    checks["geo-circle serial: essential graph and post-closure poses equal to the bit"] = (
        same_eg and same_closures and diff is None and len(eg[0]) >= 1 and len(closures[0]) >= 1)


def graphs_mapper_solvers(cfg, checks: dict):
    """The last two one-card programs the JAX package jits, replayed against
    op by op: the batched local BA (`make_multistream_local_ba`, batches A,
    B, A again, C, D and E of S=8 windows at [multistream]'s shape: a
    program per key, the shapes and the index blocks' power-of-two widths,
    so a batch whose widened widths are new captures its own, and A's
    second solve replays; beside them the widths before the widening, which
    would key a program each) and the loop closer's Sim(3) refinement
    (`LoopClosing.refine_sim3`, two problems of other match counts padded
    to the keypoint capacity, the second replaying), each equal to the bit,
    with the ms of both."""
    from ceres_mono_orb_slam2_tpu_torch.models.loopclosing import LoopClosing
    from ceres_mono_orb_slam2_tpu_torch.models.map import Map
    from ceres_mono_orb_slam2_tpu_torch.ops import lie
    from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as ms
    from ceres_mono_orb_slam2_tpu_torch.utils.config import SlamConfig

    solvers = [ms.make_multistream_local_ba(device="cuda", graphs=g) for g in (True, False)]
    ba, widths = [], []  # per solve: (equal to the bit, ms replayed or capturing, ms op by op, programs)
    for first in (0, 1, 0, 2, 3, 4):
        _, batch = ba_batch(range(first * N_STREAMS, (first + 1) * N_STREAMS))
        (rg, ms_g), (re_, ms_e) = (timed(lambda f=f: f(*batch)) for f in solvers)
        ba.append((same_bits(rg, re_), round(ms_g, 1), round(ms_e, 1), stream_ba_programs(solvers[0])))
        widths.append(index_widths(batch))
    widened = [tuple(1 << (w - 1).bit_length() for w in ws) for ws in widths]
    # the default camera (fx = fy = 500, cx = 320, cy = 240) of `sim3_matches`
    closers = [LoopClosing(SlamConfig(), Map(), None, device="cuda", graphs=g) for g in (True, False)]
    rows = cfg.orb.n_features  # a spiral keyframe's keypoint capacity
    start = tuple(x.cuda() for x in lie.sim3_exp(torch.tensor(SIM3_XI) + torch.tensor(
        [0.03, -0.02, 0.04, 0.01, 0.01, -0.01, 0.05])))
    sim3 = []  # per problem: (equal to the bit, ms replayed or capturing, ms op by op, captures, replays)
    for seed, n in ((1, 300), (2, 200)):
        arrays = tuple(a.astype(np.float32) for a in sim3_matches(seed, n)[0]) + (
            np.ones(n, np.float32), np.ones(n, np.float32))
        (og, ms_g), (oe, ms_e) = (timed(lambda lc=lc: on_mapper_stream(
            lambda: lc.refine_sim3(arrays, *start, rows=rows))) for lc in closers)
        d = closers[0]._sim3_step.summary()
        sim3.append((same_bits(og, oe), round(ms_g, 2), round(ms_e, 2), int(og.n_inliers), d["captures"],
                     d["replays"]))
    log(f"[graphs] batched local BA, S={N_STREAMS} x (P=16, M=2048, O=8192), batches A, B, A, C, D, E (equal to "
        f"the bit, ms replayed or capturing, ms op by op, programs: captures, replays, kept): {ba}")
    log(f"[graphs] batched local BA index widths (by pose, by point, by pair) of A, B, A, C, D, E: {widths}, "
        f"widened {widened}; distinct keys: {len(set(widths))} unwidened (the captures of a run without the "
        f"widening), {len(set(widened))} widened")
    log(f"[graphs] Sim(3) refinement padded to {rows} rows, 300 then 200 matches (equal to the bit, ms "
        f"replayed or capturing, ms op by op, inliers, captures, replays): {sim3}")
    captures = [[p[1] for p in b[3]] for b in ba]
    checks["batched local BA: replay equal to op by op to the bit, A's second solve replayed"] = (
        all(b[0] for b in ba) and captures[2] == captures[1] and len(captures[2]) == 2
        and captures[-1] == [len(set(widened))] * 2)
    checks["Sim(3) refinement: replay equal to op by op to the bit, one program, 60% of the matches inliers"] = (
        all(r[0] for r in sim3) and sim3[1][4:] == (1, 29) and min(r[3] for r in sim3) >= 120)


def graphs_streams(checks: dict):
    """The two streams' rules on the card. A `CapturedFunction` called off
    its owner's stream raises (the mapper's on the default stream, the
    tracker's on the mapper stream) and on its own stream replays equal to
    eager; `graphs.fetch` gives the bits of `.cpu().numpy()` for each dtype
    the stages read back, as a dense tensor, a 0-d one, an empty one, a
    transposed view and a strided slice; a tensor the default stream is
    still writing, handed over with `share_with` and read on the mapper
    stream behind `wait_for`, reads as written, and its memory, freed on
    the default stream while the mapper stream still reads it, is not
    handed out again before that read is done."""
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs

    dev = torch.device("cuda")
    mapper = graphs.owner_stream(dev, "mapper")
    guard = {}
    for owner, wrong in (("mapper", torch.cuda.default_stream(dev)), ("tracker", mapper)):
        fn = graphs.CapturedFunction(lambda x: torch.tanh(x) * 3 + 1, dev, name=f"probe_{owner}", owner=owner)
        x = torch.linspace(-2.0, 2.0, 4096, device=dev)
        with torch.cuda.stream(wrong):
            try:
                fn(x)
                raised = False
            except RuntimeError:
                raised = True
        with graphs.on_owner_stream(dev, owner):
            outs = [fn(x) for _ in range(3)]
            want = torch.tanh(x) * 3 + 1
            same = all(torch.equal(o, want) for o in outs)
            torch.cuda.current_stream().synchronize()
        guard[owner] = (raised, fn.n_captures, fn.n_replays, same)
    checks["a call off its owner's stream raises; on it, replays equal to eager"] = all(
        raised and cap == 1 and rep == 2 and same for raised, cap, rep, same in guard.values())

    g = torch.Generator(device=dev).manual_seed(5)
    wrong_fetch = []
    for dtype in (torch.float32, torch.int64, torch.int32, torch.uint8, torch.bool):
        base = (torch.randn((257, 33), device=dev, generator=g) * 1e3).to(dtype)
        cases = (base, base[7, 3], base[:0], base.t(), base[1::3, ::2])
        for i, (a, t) in enumerate(zip(graphs.fetch(*cases), cases)):
            want = t.cpu().numpy()
            if a.dtype != want.dtype or a.shape != want.shape or not np.array_equal(a, want):
                wrong_fetch.append((str(dtype), i))
    checks["graphs.fetch gives the bits of .cpu().numpy()"] = not wrong_fetch

    # the default stream busy for a while, then a tensor it writes last
    # handed to the mapper stream, read there, and freed on the default
    # stream while the mapper stream, busy too, has not read it yet
    w = torch.randn((2048, 2048), device=dev, generator=g)
    for _ in range(40):
        w = torch.tanh(w @ w * 1e-3)
    z = w[:, :64] * 2 - 1
    want_z = z.clone()
    ready = graphs.share_with("mapper", [z])
    with graphs.on_owner_stream(dev, "mapper"):
        graphs.wait_for(ready)
        v = torch.randn((2048, 2048), device=dev, generator=g)
        for _ in range(40):
            v = torch.tanh(v @ v * 1e-3)
        r = z * 3
    del z
    junk = torch.full((2048, 64), float("nan"), device=dev)  # may take z's block if it were free
    with graphs.on_owner_stream(dev, "mapper"):
        got_r, = graphs.fetch(r)
    want_r = (want_z * 3).cpu().numpy()
    checks["a tensor handed over reads as written, its memory kept while the mapper stream reads it"] = (
        np.array_equal(got_r, want_r) and bool(torch.isnan(junk).all()))
    log(f"[graphs] streams: the mapper stream {mapper_stream_name()}; (raised off its stream, captures, "
        f"replays, equal to eager) by owner {guard}; fetch cases unlike .cpu().numpy(): {wrong_fetch}; a "
        f"handed-over tensor read on the mapper stream as written: {np.array_equal(got_r, want_r)}")


def graphs_held_start(seq, cfg, checks: dict) -> int:
    """The spiral's frame 0 shown HELD_FRAMES times, then its next frames
    until the map initialises and one frame more, through a MonoSLAM with
    graphs and one with graphs=False in turn: every initialization
    attempt's match indices and `InitResult` fields, the initial map's
    keyframe poses and map points after its global BA, every fused frame's
    device phase and every pose equal to the bit. Reports the attempts, the
    ms of one attempt (eager, replayed, the first call that captures) and
    of all of them, the initial global BA's ms, the host API launches of
    one attempt both ways, and the initializer's programs. Returns the
    extractions made."""
    from ceres_mono_orb_slam2_tpu_torch.models import optimization

    pair = graph_pair(cfg)
    attempts, attempt_ms, gba_ms, after_ba, first_pair = ([], []), ([], []), ([], []), ([], []), [None, None]
    current = [0]
    for j, (slam, _) in enumerate(pair):
        attempt = slam.tracker._two_view_attempt

        def recorded(ref, f, attempt=attempt, j=j):
            out, ms = timed(lambda: attempt(ref, f))
            attempts[j].append(None if out is None else [out[0], *out[1]])
            attempt_ms[j].append(ms)
            first_pair[j] = first_pair[j] or (attempt, ref, f)
            return out

        slam.tracker._two_view_attempt = recorded
    gba = optimization.global_bundle_adjustment

    def recorded_gba(m, *a, **kw):
        out, ms = timed(lambda: gba(m, *a, **kw))
        gba_ms[current[0]].append(ms)
        after_ba[current[0]].append([x for k in m.all_keyframes() for x in (k.Rcw.copy(), k.tcw.copy())]
                                    + [np.array(mp.pos) for mp in m.all_map_points()])
        return out

    optimization.global_bundle_adjustment = recorded_gba
    poses, frames, k = ([], []), [], 0
    try:
        while k < HELD_FRAMES + HELD_MAX_FRAMES:
            i = 0 if k < HELD_FRAMES else k - HELD_FRAMES + 1
            frames.append(i)
            for j, (slam, _) in enumerate(pair):
                current[0] = j
                poses[j].append(slam.track_monocular(seq.images[i], k / 10.0))
            k += 1
            if all(len(p) >= 2 and p[-2] is not None for p in poses):  # the frame after the initial map
                break
    finally:
        optimization.global_bundle_adjustment = gba
    launches = []
    for attempt, ref, f in first_pair:  # one more attempt of each, under the profiler
        _, api, _ = api_launches(lambda: attempt(ref, f))
        launches.append((sum(n for name, n in api.items() if "Launch" in name), dict(api.most_common(4))))
    same_attempts = len(attempts[0]) == len(attempts[1]) and all(
        (a is None) == (b is None) and (a is None or same_bits(a, b)) for a, b in zip(*attempts))
    same_map = len(after_ba[0]) == len(after_ba[1]) == 1 and same_bits(after_ba[0][0], after_ba[1][0])
    diff = first_difference(pair[0][1], pair[1][1]) or first_pose_difference(*poses)
    init_at = next((n for n, T in enumerate(poses[0]) if T is not None), None)
    names = ["init_match", *(f"two_view_{n}" for n in ("fit", "score", "motions", "check")), "init_gba_lm_robust"]
    progs = {p["name"]: p for p in pair[0][0].tracker.programs() if p["name"] in names}
    rows = [(n, p["captures"], p["replays"], round(p["input_mb"], 2), round(p["pool_mb"], 1))
            for n, p in progs.items()]
    g_ms, e_ms = attempt_ms
    log(f"[graphs] held start: the spiral's frame 0 {HELD_FRAMES} times, then frames "
        f"{sorted(set(frames) - {0})}: {len(g_ms)} / {len(e_ms)} attempts "
        f"{['<100 matches' if a is None else 'ok' if bool(a[1]) else 'failed' for a in attempts[0]]}, the "
        f"map initialised at showing {init_at}; every attempt's matches and InitResult equal to the bit: "
        f"{same_attempts}; the initial map after its global BA: {same_map}; device phases and poses: "
        f"{diff is None}"
        f"{'' if diff is None else ' (' + diff + ')'}")
    log(f"[graphs] held start: ms of one attempt eager {np.median(e_ms[1:]):.2f} (first {e_ms[0]:.2f}), "
        f"replayed {np.median(g_ms[1:]):.2f}, first call {g_ms[0]:.2f}; all {len(g_ms)} attempts graphs "
        f"{sum(g_ms):.2f} against eager {sum(e_ms):.2f} ms; the initial global BA graphs "
        f"{gba_ms[0][0] if gba_ms[0] else float('nan'):.2f} against eager "
        f"{gba_ms[1][0] if gba_ms[1] else float('nan'):.2f} ms; host API launches of one attempt graphs "
        f"{launches[0][0]} ({launches[0][1]}), eager {launches[1][0]} ({launches[1][1]}); programs (name, "
        f"captures, replays, input MB, pool MB) {rows}")
    checks["held start: every attempt, the initial map and every pose equal to the bit"] = (
        same_attempts and same_map and diff is None)
    checks["held start: the held frames fail, a moving frame initialises"] = (
        init_at is not None and init_at >= HELD_FRAMES and len(g_ms) >= HELD_FRAMES
        and all(a is not None and not bool(a[1]) for a in attempts[0][:HELD_FRAMES - 1]))
    checks["held start: one capture of each initializer program, the rest replays"] = (
        set(progs) == set(names) and all(p["captures"] == 1 for p in progs.values())
        and progs["init_gba_lm_robust"]["replays"] == 19
        and progs["init_match"]["replays"] == len(g_ms))
    for slam, _ in pair:
        slam.shutdown()
    return 2 * len(frames)


def phase_graphs(seq, cfg):
    """Replay against eager in one process, each frame through a MonoSLAM
    that replays its programs and one with graphs=False in turn: every
    device phase's FusedOut fields, features and control buffer and every
    pose equal to the bit on the spiral serial and pipelined, on the
    geometric strafe pipelined (it chains), on [reloc]'s frames up to and
    after the blackout and on a blinded tracker's relocalization (the
    captured pose solve) and its wide-radius fused frame; one S=8 batched
    step; the host API launches of one fused frame from torch.profiler
    against the replay-counted kernel launches; each program's memory. The
    mapper's programs against eager: every keyframe pose and map point after
    each mapping pass of the serial spiral, and the closed geometric circle's
    essential graphs and post-closure poses against its mapper op by op
    (`graphs_loop_pair`)."""
    from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
    from ceres_mono_orb_slam2_tpu_torch.models.tracking import State
    from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels as k
    from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as ms
    from ceres_mono_orb_slam2_tpu_torch.utils import graphs as graphs_mod
    from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
        GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)

    # inputs first: [reloc]'s vocabulary and the synthetic stream state extract too
    rcfg, rseq, voc, images = reloc_setup()
    images8, state = ms.synthetic_stream_state(cfg, N_STREAMS, MAP_POINTS, seed=0, h=H, w=W, device="cuda")
    images8 = torch.from_numpy(np.clip(images8 + 0.5, 0.0, 255.0).astype(np.uint8)).cuda()
    k.reset_launch_counts()
    n_extract, checks = 0, {}
    graphs_streams(checks)
    mb = lambda progs: [(p["name"], max(p["shapes"], key=np.prod), round(p["pool_mb"], 1),  # noqa: E731
                         round(p["body_pool_mb"], 1), round(p["input_mb"], 2), p["captures"], p["replays"])
                        for p in progs]

    # the spiral, serial: frame times side by side, then one fused frame of
    # each system under the profiler (the tracker only, mapping after it);
    # beside them a third system, prewarmed (`MonoSLAM.prewarm`), which
    # must make every decision of the first to the bit and capture none of
    # its prewarmed programs again
    pair = graph_pair(cfg)
    warm = MonoSLAM(cfg, device="cuda")
    warm_phases = warm.prewarm(H, W)
    warm_captures = program_captures(warm)
    trio = pair + [(warm, record_phases(warm.tracker))]
    passes = [record_passes(slam.local_mapper) for slam, _ in trio]
    poses, frame_ms = lockstep(trio, range(GRAPH_FRAMES), seq.images, seq.timestamps)
    n_extract += 3 * GRAPH_FRAMES
    warm_diff = (first_difference(trio[2][1], trio[0][1]) or first_pose_difference(poses[2], poses[0])
                 or first_map_difference(passes[2], passes[0]))
    warm_again = recaptured(warm, warm_captures)
    first_fused = [first_fused_ms(slam, seq.timestamps, fms) for (slam, _), fms in zip(trio, frame_ms)]
    log(f"[graphs] spiral serial, prewarmed system: prewarm phases (s since its start) "
        f"{ {k: round(v, 3) for k, v in warm_phases.items()} }; device phases, poses and every keyframe pose "
        f"and map point after each mapping pass equal to the unprewarmed graphs system's to the bit: "
        f"{warm_diff is None}{'' if warm_diff is None else ' (' + warm_diff + ')'}; programs captured "
        f"again after prewarm {warm_again}; first fused frame ms prewarmed {first_fused[2]:.2f}, "
        f"unprewarmed graphs {first_fused[0]:.2f}, eager {first_fused[1]:.2f}; median frame ms (frames "
        f"10+) prewarmed {float(np.median(frame_ms[2][10:])):.2f}")
    checks["spiral serial: the prewarmed system equal to the unprewarmed one to the bit"] = (
        warm_diff is None and len(trio[2][1]) >= 10 and len(passes[2]) >= 3)
    checks["spiral serial: no prewarmed program captured again; the first fused frame a replay"] = (
        not warm_again and warm.tracker._frontend[1].n_captures == 1
        and warm.tracker._frontend[1].n_replays == len(trio[2][1]))
    del warm, trio
    poses, frame_ms, passes = poses[:2], frame_ms[:2], passes[:2]
    profiles = []
    for slam, _ in pair:
        before = dict(k.launch_counts)
        i = GRAPH_FRAMES
        _, api, dev = api_launches(lambda: slam.tracker.grab_image(seq.images[i], float(seq.timestamps[i])))
        slam._map_after_frame()
        counted = {name: k.launch_counts[name] - before[name] for name in before}
        on_card = {name: sum(n for ev, n in dev.items() if f"{name}_kernel" in ev) for name in before}
        stats = slam.tracker.frame_stats
        profiles.append((api, counted, on_card, stats[-1]["method"] if stats else None, sum(dev.values())))
    n_extract += 2
    torch.cuda.synchronize()
    diff = first_difference(pair[0][1], pair[1][1]) or first_pose_difference(*poses)
    map_diff = first_map_difference(*passes)
    med = [float(np.median(m[10:])) for m in frame_ms]
    launches_api = [sum(n for name, n in api.items() if "Launch" in name) for api, *_ in profiles]
    (g_api, g_counted, g_card, g_method, g_dev), (e_api, e_counted, e_card, e_method, e_dev) = profiles
    log(f"[graphs] spiral serial, {GRAPH_FRAMES} frames: {len(pair[0][1])} fused frames, replay against eager "
        f"to the bit: {diff is None}{'' if diff is None else ' (' + diff + ')'}; median frame ms (frames 10+) "
        f"graphs {med[0]:.2f}, eager {med[1]:.2f} ({med[1] / med[0]:.2f}x); programs (name, largest input, "
        f"pool MB, body pool MB, input MB, captures, replays) {mb(pair[0][0].tracker.programs())}")
    fused_iters = [[r[5].cpu().numpy() for r in phases if r[0] == "fused"] for _, phases in pair]
    log(f"[graphs] spiral serial: LM iterations a round (4 rounds of up to 25) of the fused frames' pose "
        f"solves, graphs / eager: solve 1 {iter_stats([x[0] for x in fused_iters[0]])} / "
        f"{iter_stats([x[0] for x in fused_iters[1]])}, solve 2 {iter_stats([x[1] for x in fused_iters[0]])} / "
        f"{iter_stats([x[1] for x in fused_iters[1]])}; IF nodes captured in the process so far "
        f"{graphs_mod.if_nodes}")
    stage_means = [{st: round(float(np.mean([p[st] for p in slam.local_mapper.pass_ms if st in p] or [0.0])), 2)
                    for st in ("triangulate", "fuse", "lba")} for slam, _ in pair]
    log(f"[graphs] spiral serial: {len(passes[0])} mapping passes, every keyframe pose and map point after "
        f"each pass equal to the bit: {map_diff is None}{'' if map_diff is None else ' (' + map_diff + ')'}; "
        f"mean stage ms graphs {stage_means[0]}, eager {stage_means[1]}; "
        f"the mapper's programs (captures, replays on the mapper stream, kept, dropped, shared pool MB) "
        f"{program_summaries(pair[0][0])}; local mapping programs (name, largest input, pool MB, input MB, "
        f"captures, replays) {mb(pair[0][0].local_mapper.programs())}")
    log(f"[graphs] one fused frame under torch.profiler ({g_method} / {e_method}): host API launches graphs "
        f"{launches_api[0]} ({dict(g_api.most_common(6))}), eager {launches_api[1]} "
        f"({dict(e_api.most_common(6))}); kernels counted through the replay {g_counted}, on the card "
        f"{g_card}; eager counted {e_counted}, on the card {e_card}; device kernels and copies of the "
        f"frame graphs {g_dev}, eager {e_dev} ({g_dev / max(e_dev, 1):.3f})")
    checks["spiral serial: replay equal to eager to the bit"] = diff is None and len(pair[0][1]) >= 10
    checks["spiral serial: keyframes and map points after every mapping pass equal to the bit"] = (
        map_diff is None and len(passes[0]) >= 3)
    checks["the profiled frames are fused"] = g_method == e_method == "fused"
    checks["a fused frame is one graph launch"] = sum(n for name, n in g_api.items() if "GraphLaunch" in name) == 1
    # the pose solves' iterations after convergence are IF nodes skipped
    checks["the replayed fused frame runs fewer device kernels than the eager one"] = g_dev < e_dev
    checks["the fused frames' pose solves exit before 25 iterations a round"] = (
        len(fused_iters[0]) >= 10 and float(np.mean(fused_iters[0])) < 25)
    checks["replay-counted kernel launches equal the card's, one each"] = (
        g_counted == g_card == e_counted == e_card == {"fast_nms": 1, "gather_patches": 1})
    del pair

    # a held start: the spiral's frame 0 again and again, then its next
    # frames until the map initialises (an attempt a frame)
    n_extract += graphs_held_start(seq, cfg, checks)

    # the spiral, pipelined at full rate (unthreaded)
    pair = graph_pair(cfg, pipelined=True)
    poses, _ = lockstep(pair, range(GRAPH_FRAMES), seq.images, seq.timestamps)
    for slam, _ in pair:
        slam.shutdown()
    torch.cuda.synchronize()
    trs = [slam.tracker for slam, _ in pair]
    n_extract += 2 * GRAPH_FRAMES + sum(tr.n_retracked_frames for tr in trs)
    trajs = [slam.get_frame_trajectory() for slam, _ in pair]
    diff = (first_difference(pair[0][1], pair[1][1]) or first_pose_difference(*poses)
            or first_pose_difference(list(trajs[0][1]), list(trajs[1][1])))
    log(f"[graphs] spiral pipelined, {GRAPH_FRAMES} frames: {len(pair[0][1])} device phases, chained "
        f"{trs[0].n_chained_frames} / {trs[1].n_chained_frames}, re-tracked {trs[0].n_retracked_frames}; replay "
        f"against eager to the bit (phases, poses, drained trajectory): {diff is None}"
        f"{'' if diff is None else ' (' + diff + ')'}")
    checks["spiral pipelined: replay equal to eager to the bit"] = diff is None
    del pair

    # the geometric strafe, pipelined: it chains at full rate
    gcfg = slam_config(TUM_H, TUM_W)
    Rcw, tcw = make_geo_trajectory(GRAPH_GEO_FRAMES, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    pair = graph_pair(gcfg, pipelined=True)
    for slam, _ in pair:
        slam.tracker.extractor = GeoExtractor(world, gcfg.camera.K, Rcw, tcw, gcfg.orb.n_features, TUM_H,
                                              TUM_W, px_noise=0.3, bit_noise=2, seed=5, device="cuda")
    frames = [frame_image(i, TUM_H, TUM_W) for i in range(GRAPH_GEO_FRAMES)]
    poses, _ = lockstep(pair, range(GRAPH_GEO_FRAMES), frames, np.arange(GRAPH_GEO_FRAMES) / 30.0)
    for slam, _ in pair:
        slam.shutdown()
    torch.cuda.synchronize()
    trs = [slam.tracker for slam, _ in pair]
    diff = first_difference(pair[0][1], pair[1][1]) or first_pose_difference(*poses)
    log(f"[graphs] geometric strafe pipelined, {GRAPH_GEO_FRAMES} frames: chained {trs[0].n_chained_frames} / "
        f"{trs[1].n_chained_frames}; replay against eager to the bit: {diff is None}"
        f"{'' if diff is None else ' (' + diff + ')'}")
    checks["geometric strafe pipelined: chains, replay equal to eager to the bit"] = (
        diff is None and trs[0].n_chained_frames > 0)
    del pair

    # [reloc]'s frames to GRAPH_RELOC_FRAMES, then both trackers blinded:
    # a relocalization through the captured pose solve and the fused frame
    # after it at the widened radius (th_local 5.0)
    pair = graph_pair(rcfg, vocabulary=voc)
    solvers = [record_solvers(slam) for slam, _ in pair]
    poses, _ = lockstep(pair, range(GRAPH_RELOC_FRAMES), images, rseq.timestamps)
    for slam, _ in pair:
        slam.tracker.state, slam.tracker.velocity = State.LOST, None
    more, _ = lockstep(pair, (GRAPH_RELOC_FRAMES, GRAPH_RELOC_FRAMES + 1), images, rseq.timestamps)
    for slam, _ in pair:
        slam.shutdown()
    torch.cuda.synchronize()
    n_extract += 2 * (GRAPH_RELOC_FRAMES + 2)
    diff = first_difference(pair[0][1], pair[1][1]) or first_pose_difference(
        poses[0] + more[0], poses[1] + more[1])
    tr = pair[0][0].tracker
    methods = [(st["frame_id"], st["method"], st["ok"]) for st in tr.frame_stats if st["frame_id"] >= 43]
    wide = [th for _, th, *_ in pair[0][1] if th != 1.0]
    same_solvers = {k: _same(solvers[0][k], solvers[1][k]) for k in solvers[0]}
    counts = {k: len(v) for k, v in solvers[0].items()}
    pose_iters = [iter_stats([r[-1] for r in s["pose"]]) for s in solvers]
    log(f"[graphs] [reloc]'s frames 0-{GRAPH_RELOC_FRAMES - 1}, then blinded at {GRAPH_RELOC_FRAMES}: methods "
        f"{methods}; fused frames at th_local 5.0: {len(wide)}; replay against eager to the bit: "
        f"{diff is None}{'' if diff is None else ' (' + diff + ')'}; non-fused frames' features, BoW word "
        f"ids, RANSAC results, unfused pose solves ({counts}) equal to the bit: {same_solvers}; the unfused "
        f"pose solves' LM iterations a round, graphs / eager: {pose_iters[0]} / {pose_iters[1]}; programs "
        f"{mb(tr.programs())}")
    checks["[reloc] frames and the blinded relocalization: replay equal to eager to the bit"] = diff is None
    checks["[reloc] non-fused features, BoW word ids, RANSAC results and pose solves equal to the bit"] = (
        all(same_solvers.values()) and min(counts.values()) >= 1)
    last2 = [(st["method"], st["ok"]) for st in tr.frame_stats[-2:]]
    checks["the blinded tracker relocalizes, then fuses at th_local 5.0"] = (
        last2 == [("reloc", True), ("fused", True)] and pair[0][1][-1][1] == 5.0)
    del pair

    # one S=8 batched step
    steps = [ms.make_multistream_step(cfg, H, W, device="cuda", graphs=g) for g in (True, False)]
    first, replayed = steps[0](images8, state), steps[0](images8, state)
    step_iters = [steps[0].pose_iters.tolist()]
    eager = steps[1](images8, state)
    step_iters.append(steps[1].pose_iters.tolist())
    step_ms = [float(np.median([timed(lambda: st(images8, state))[1] for _ in range(5)])) for st in steps]
    n_extract += 3 + 10
    same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(replayed, eager, first))
    log(f"[graphs] make_multistream_step S={N_STREAMS}: replay equal to eager and to the first (eager) call "
        f"to the bit: {same}; step ms graphs {step_ms[0]:.2f}, eager {step_ms[1]:.2f}; LM iterations a "
        f"round of its pose solve, graphs / eager {step_iters[0]} / {step_iters[1]}; programs "
        f"{mb(steps[0].programs())}")
    checks["S=8 batched step: replay equal to eager to the bit"] = same and step_iters[0] == step_iters[1]

    # the batched local BA and the Sim(3) refinement
    graphs_mapper_solvers(cfg, checks)

    # geo-circle-72 serial through both systems: the essential graph of each
    # closure (its GN iterations replayed against eager), then the poses
    graphs_loop_pair(checks)

    launches = dict(k.launch_counts)
    log(f"[graphs] launches {launches} over {n_extract} extractions")
    for name in ("fast_nms", "gather_patches"):
        checks[f"{name} launched once per extraction, counted through replays"] = launches[name] == n_extract
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"graphs checks failed: {failed}")
    return launches, n_extract


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="", help="comma-separated later phases to run after the build "
                    "and the spiral (graphs, threaded, pipelined, bow, solvers, reloc, loop, multistream, "
                    "multisystem, cli, viewer, sharded); default all")
    only = [name for name in ap.parse_args().only.split(",") if name]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvidia_smi()}")
    phase_build()
    cfg = slam_config()
    seq = render_sequence()
    rows = phase_kernels(seq, cfg)
    phase_ba()
    spiral_launches, spiral_poses, spiral = phase_slam(seq, cfg)
    paths = {"spiral": (spiral_launches, N_FRAMES)}
    for name, phase in (("graphs", lambda: phase_graphs(seq, cfg)),
                        ("threaded", lambda: phase_concurrent(seq, cfg, spiral, pipelined=False)),
                        ("pipelined", lambda: phase_concurrent(seq, cfg, spiral, pipelined=True)),
                        ("bow", lambda: phase_bow(seq, cfg)), ("solvers", lambda: phase_solvers(seq, cfg)),
                        ("reloc", phase_reloc), ("loop", phase_loop),
                        ("multistream", lambda: phase_multistream(cfg)),
                        ("multisystem", lambda: phase_multisystem(seq, cfg, spiral_poses, spiral)),
                        ("cli", phase_cli), ("viewer", phase_viewer),
                        ("sharded", lambda: phase_sharded(cfg))):
        if only and name not in only:
            continue
        path, ms = timed(phase)
        log(f"[{name}] phase took {ms / 1e3:.1f} s")
        if isinstance(path, dict):  # several paths of one phase
            paths.update(path)
        elif path is not None:  # (launches, extractions) of a path that extracts from pixels
            paths[name] = path
    log(f"[total] {time.perf_counter() - t_script:.1f} s")
    log(nvidia_smi())
    n_extractions = sum(n for _, n in paths.values())
    for r in rows:  # launches summed over every path that extracts from pixels
        r["launches"] = sum(counts[r["name"]] for counts, _ in paths.values())
        r["launches_per_extraction"] = r["launches"] / n_extractions
        r["launches_by_path"] = {name: counts[r["name"]] for name, (counts, _) in paths.items()}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
