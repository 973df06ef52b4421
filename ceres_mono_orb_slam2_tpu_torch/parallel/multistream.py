"""Batched multi-stream tracking step and batched local bundle adjustment.

Port of `ceres_mono_orb_slam2_tpu/parallel/multistream.py`: S concurrent
SLAM streams on one card, a leading stream axis through the whole per-frame
device pipeline (extract -> frustum + scale prediction -> projection match
-> pose LM). Where the JAX package vmaps a one-stream function, the ops here
take the stream axis themselves (`ops/matcher.py`, `ops/frustum.py`,
`ops/optim.py`), so S streams cost the launches of one: one FAST+NMS launch,
one patch-gather launch, one Hamming product, one LM loop in which every
stream keeps its own damping and freezes on its own convergence.

`shard_step_over_mesh` runs the same step over a ("dp", "mp") mesh of ranks
(parallel/mesh.py): streams over `dp`, the map-point axis over `mp`. Where
XLA partitions the JAX step by itself, the collectives here are explicit.
The one coupling across map points is the duplicate-keypoint resolution of
the projection search, an argmin combine over `mp`
(`resolve_duplicate_targets_sharded`); the pose solve then runs alike on
the `mp` ranks, and the results are gathered over `dp`.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ceres_mono_orb_slam2_tpu_torch.models.fused_track import _scatter_rows
from ceres_mono_orb_slam2_tpu_torch.ops import frustum, matcher, optim
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.parallel.mesh import (
    axis_size, block, gather_blocks, mesh_device, synchronize)
from ceres_mono_orb_slam2_tpu_torch.utils import graphs as graphs_mod
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

NO_CLAIM = torch.iinfo(torch.int64).max  # the combine key of a point without a match


class StreamState(NamedTuple):
    """Per-stream tracking state (leading axis = streams)."""

    Rcw: torch.Tensor  # (S, 3, 3)
    tcw: torch.Tensor  # (S, 3)
    map_pos: torch.Tensor  # (S, M, 3)
    map_normal: torch.Tensor  # (S, M, 3)
    map_min_dist: torch.Tensor  # (S, M)
    map_max_dist: torch.Tensor  # (S, M)
    map_bits: torch.Tensor  # (S, M, 256) +-1 descriptor bits
    map_valid: torch.Tensor  # (S, M)


class StepResult(NamedTuple):
    Rcw: torch.Tensor  # (S, 3, 3)
    tcw: torch.Tensor  # (S, 3)
    n_inliers: torch.Tensor  # (S,)
    n_matches: torch.Tensor  # (S,)


def make_multistream_step(config, h: int, w: int, device=DEFAULT_DEVICE, graphs: bool = True):
    """Build the per-frame device step for a batch of streams: ORB
    extraction, frustum + scale prediction, local-map projection search
    (th=3) and the 4-round trimmed LM pose solve, all with a leading stream
    axis. Returns step(images (S, h, w), state: StreamState) -> StepResult.
    With `graphs` (the default) the step is a captured program per S
    (`utils/graphs.py`): images and state are staged into its buffers;
    `step.programs()` reports the programs. `graphs=False` runs it op by
    op. `step.pose_iters` (4,) int32, on the device: the LM iterations each
    round of the last step's pose solve ran (`PoseOptResult.iters`)."""
    device = resolve_device(device)
    step = _make_step(config, h, w, device, mesh=None)
    if not graphs:
        return step
    program = graphs_mod.CapturedFunction(step, device, name="multistream_step")

    def captured(images, state: StreamState) -> StepResult:
        if not torch.is_tensor(images):  # extract()'s 8-bit entry, on the host
            images = np.asarray(images)
            if images.dtype != np.uint8:
                images = np.clip(images + 0.5, 0.0, 255.0).astype(np.uint8)
            images = torch.from_numpy(np.ascontiguousarray(images))
        state = StreamState(*(a if torch.is_tensor(a) else torch.as_tensor(np.ascontiguousarray(a))
                              for a in state))
        return StepResult(*program(images, state))

    captured.programs = program.report
    captured.pose_iters = step.pose_iters
    return captured


def _make_step(config, h: int, w: int, device, mesh):
    """The step of `make_multistream_step` (mesh None) or, on a ("dp", "mp")
    mesh, of `shard_step_over_mesh`."""
    extractor = ORBExtractor(config.orb, device=device)
    K = torch.as_tensor(np.asarray(config.camera.K, np.float32), device=device)
    scales = torch.as_tensor(np.asarray(config.orb.scale_factors, np.float32), device=device)
    inv_sigma2 = torch.as_tensor(np.asarray(config.orb.inv_level_sigma2, np.float32), device=device)
    bounds = torch.tensor([0, w, 0, h], dtype=torch.float32, device=device)
    log_scale = float(np.log(config.orb.scale_factor))
    n_levels = config.orb.n_levels
    pose_iters = torch.zeros(4, dtype=torch.int32, device=device)

    @torch.no_grad()
    def step(images, state: StreamState) -> StepResult:
        feats = extractor.extract(images)  # one batch over the streams
        n_kp = feats.xy.shape[-2]
        uv, level, viewcos, visible = frustum.frustum_and_scale(
            state.Rcw, state.tcw, K, bounds, state.map_pos, state.map_normal,
            state.map_min_dist, state.map_max_dist, state.map_valid, log_scale, n_levels)
        idx, hd, mvalid = matcher.search_by_projection_points_local(
            feats.xy, feats.octave, matcher.unpack_bits_pm1(feats.desc), feats.valid,
            torch.ones_like(feats.valid), uv, level, viewcos, state.map_bits, visible,
            scales, th=3.0)
        if mesh is None:
            mvalid = matcher.resolve_duplicate_targets(idx, hd, mvalid, n_kp)
        else:
            mvalid = resolve_duplicate_targets_sharded(idx, hd, mvalid, n_kp, mesh, "mp")
        # matched map-point positions into keypoint slots; unmatched points
        # go to a dummy slot, so they cannot overwrite a match
        safe_idx = torch.where(mvalid, idx, n_kp)
        pos_kp = _scatter_rows(n_kp, safe_idx, state.map_pos, 0.0)
        ok = _scatter_rows(n_kp, safe_idx, mvalid, False)
        n_matches = mvalid.to(torch.int32).sum(-1)
        if mesh is not None:  # every keypoint slot has one writer over mp: exact sums
            mp_sum = optim.group_sum(mesh.get_group("mp"))
            pos_kp, n_matches = mp_sum(pos_kp), mp_sum(n_matches)
            ok = mp_sum(ok.to(torch.int32)) > 0
        # the live tracker's solver settings: 4 trimming rounds of 25
        # iterations, each stream frozen at its own convergence
        res = optim.pose_optimization(K, state.Rcw, state.tcw, pos_kp, feats.xy,
                                      inv_sigma2[feats.octave], ok)
        pose_iters.copy_(res.iters)
        out = StepResult(Rcw=res.R, tcw=res.t, n_inliers=res.n_inliers, n_matches=n_matches)
        if mesh is not None:
            out = StepResult(*(gather_blocks(x, mesh, "dp") for x in out))
        return out

    step.pose_iters = pose_iters
    return step


def resolve_duplicate_targets_sharded(best_idx, best_val, valid, n_targets: int, mesh, axis: str):
    """`matcher.resolve_duplicate_targets` with the queries split in
    contiguous blocks over `mesh[axis]`, this rank holding its block: for
    every target, the query with the smallest distance keeps it, the lowest
    global query index on ties. Each rank packs (distance, global index)
    into one int64 key, takes the least key per target over its queries,
    and one all_reduce MIN over the axis gives every rank the winners.
    Returns this rank's filtered `valid`, equal to the block of the
    unsharded result."""
    n_queries = best_idx.shape[-1] * axis_size(mesh, axis)
    first = best_idx.shape[-1] * mesh.get_local_rank(axis)
    qidx = first + torch.arange(best_idx.shape[-1], device=best_idx.device)
    key = torch.where(valid, best_val.long() * n_queries + qidx, NO_CLAIM)
    per_target = torch.full(best_idx.shape[:-1] + (n_targets,), NO_CLAIM, dtype=torch.int64,
                            device=key.device)
    per_target = per_target.scatter_reduce(-1, best_idx, key, "amin")
    dist.all_reduce(per_target, op=dist.ReduceOp.MIN, group=mesh.get_group(axis))
    return valid & (per_target.gather(-1, best_idx) == key)


def resolve_duplicate_targets_over_mesh(mesh, axis: str, best_idx, best_val, valid,
                                        n_targets: int):
    """`resolve_duplicate_targets_sharded` on the full (..., Q) arrays,
    given to every rank: this rank's block in, the full filtered mask out."""
    dev = mesh_device(mesh)
    local = [block(torch.as_tensor(a, device=dev), mesh, axis, dim=-1)
             for a in (best_idx, best_val, valid)]
    won = resolve_duplicate_targets_sharded(*local, n_targets, mesh, axis)
    return gather_blocks(won, mesh, axis, dim=won.dim() - 1)


def shard_step_over_mesh(config, h: int, w: int, mesh, device=None):
    """Multi-device variant of `make_multistream_step` on a mesh with axes
    ("dp", "mp"): streams over `dp`, the map-point axis over `mp`, images
    replicated over `mp`. Returns (step, shard_images, shard_state):
    `shard_images(images (S, h, w))` and `shard_state(state)` take the full
    inputs and return this rank's block (the JAX package's shardings);
    `step(images_block, state_block)` returns the full StepResult of all
    S streams on every rank. Each rank extracts its `dp` streams, so both
    kernels launch once per rank and step. `device` defaults to the mesh's."""
    device = mesh_device(mesh) if device is None else resolve_device(device)
    step = _make_step(config, h, w, device, mesh)

    def over_dp(a):
        return block(torch.as_tensor(a, device=device), mesh, "dp")

    def shard_images(images):
        return over_dp(images).contiguous()

    def shard_state(state: StreamState) -> StreamState:
        per_stream = ("Rcw", "tcw")
        return StreamState(**{
            name: (over_dp(a) if name in per_stream else block(over_dp(a), mesh, "mp", dim=1))
            .contiguous() for name, a in state._asdict().items()})

    return step, shard_images, shard_state


def step_over_mesh(mesh, config, h: int, w: int, images, state: StreamState,
                   repeats: int = 0) -> tuple:
    """`shard_step_over_mesh` on the full inputs, given to every rank (as the
    JAX package's sharded step takes its global arrays): the inputs sharded
    once, then 1 + `repeats` steps on them. Returns (the full StepResult of
    the first step on every rank, the ms of each repeated step on the host's
    clock, each ending in a device synchronisation)."""
    step, shard_images, shard_state = shard_step_over_mesh(config, h, w, mesh)
    images, state = shard_images(images), shard_state(state)
    out, ms = step(images, state), []
    for _ in range(repeats):
        synchronize(images.device)
        t0 = time.perf_counter()
        step(images, state)
        synchronize(images.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def synthetic_stream_state(config, n_streams: int, n_map_points: int, seed: int = 0,
                           h: int = 480, w: int = 640, device=DEFAULT_DEVICE) -> tuple:
    """Geometrically consistent stream states and images for measurements:
    each stream's map back-projects the extractor's own keypoints on that
    stream's image to plausible depths, so the projection search really
    matches and the LM solve does real work. The images and depths draw
    from the same numpy generator in the same order as the JAX package's
    function. Returns (images (S, h, w) float32 numpy, StreamState on
    `device`)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    fx, fy = config.camera.fx, config.camera.fy
    cx, cy = config.camera.cx, config.camera.cy
    # blobby images so that FAST fires
    images = np.full((n_streams, h, w), 40.0, np.float32)
    for s in range(n_streams):
        for _ in range((h * w) // 900):
            y = rng.integers(0, h - 10)
            x = rng.integers(0, w - 10)
            images[s, y: y + rng.integers(3, 10), x: x + rng.integers(3, 10)] = rng.uniform(90, 250)
        images[s] += rng.standard_normal((h, w)).astype(np.float32) * 2

    feats = ORBExtractor(config.orb, device=device).extract(images)
    kxy = feats.xy.cpu().numpy()
    kdesc = feats.desc.cpu().numpy()
    kvalid = feats.valid.cpu().numpy()

    M = n_map_points
    pos = np.zeros((n_streams, M, 3), np.float32)
    desc = np.zeros((n_streams, M, 32), np.uint8)
    valid = np.zeros((n_streams, M), bool)
    for s in range(n_streams):
        vi = np.nonzero(kvalid[s])[0]
        take = vi[: min(len(vi), M)]
        z = rng.uniform(4.0, 9.0, len(take)).astype(np.float32)
        pos[s, : len(take), 0] = (kxy[s, take, 0] - cx) / fx * z
        pos[s, : len(take), 1] = (kxy[s, take, 1] - cy) / fy * z
        pos[s, : len(take), 2] = z
        desc[s, : len(take)] = kdesc[s, take]
        valid[s, : len(take)] = True
    # viewing normal = direction camera -> point (UpdateNormalAndDepth)
    normal = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-6)
    dists = np.maximum(np.linalg.norm(pos, axis=-1), 1.0)
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    state = StreamState(
        Rcw=dev(np.tile(np.eye(3, dtype=np.float32), (n_streams, 1, 1))),
        tcw=torch.zeros((n_streams, 3), dtype=torch.float32, device=device),
        map_pos=dev(pos), map_normal=dev(normal),
        map_min_dist=dev((dists * 0.5).astype(np.float32)),
        map_max_dist=dev((dists * 2.0).astype(np.float32)),
        map_bits=matcher.unpack_u8(desc, device=device), map_valid=dev(valid))
    return images, state


def make_multistream_local_ba(iters_huber: int = 5, iters_trimmed: int = 10,
                              device=DEFAULT_DEVICE, graphs=None):
    """Batched local bundle adjustment: S independent streams' local-BA
    problems of one shape (P poses, M points, O observations, padded by
    their masks) solved together by `optim.bundle_adjustment_streams` on
    `device`.

    Returns fn(K, R (S,P,3,3), t, points (S,M,3), obs_pose (S,O), obs_point,
    obs_uv, obs_w, obs_valid, fixed (S,P), point_valid (S,M)) -> BAResult
    with a leading stream axis on every field.

    With graphs (by default where the device is CUDA; the JAX package's
    jitted solve) each LM iteration of both passes replays a captured
    program (`optim.lm_iteration_streams_robust` / `_trimmed`, owner
    "mapper", one per key: the shapes and the index blocks' power-of-two
    widths); `graphs=False` runs them op by op, and graphs=True on the CPU
    stages them without capture (`utils/graphs.py`). The problem (its three
    host reads) is built on the caller's stream; on CUDA the solve runs on
    the mapper stream, which waits for the inputs alone, and the caller's
    stream waits for the results alone (`graphs.share_with`). `fn.captured()`
    lists the `CapturedFunction`s."""
    device = resolve_device(device)
    on = (device.type == "cuda") if graphs is None else graphs
    steps = {f"{kind}_step": graphs_mod.CapturedFunction(
        fn, device, name=f"stream_lba_lm_{kind}", owner="mapper", max_programs=4)
        for kind, fn in (("robust", optim.lm_iteration_streams_robust),
                         ("trimmed", optim.lm_iteration_streams_trimmed))} if on else {}

    def solve(K, R, t, points, obs_pose, obs_point, obs_uv, obs_w, obs_valid, fixed, point_valid
              ) -> optim.BAResult:
        K, R, t, points, obs_pose, obs_point, obs_uv, obs_w, obs_valid, fixed, point_valid = (
            torch.as_tensor(a, device=device) for a in (K, R, t, points, obs_pose, obs_point, obs_uv,
                                                         obs_w, obs_valid, fixed, point_valid))
        prob = optim.ba_streams_problem(K, obs_pose, obs_point, obs_uv, obs_w, fixed, point_valid)
        caller = torch.cuda.current_stream(device) if device.type == "cuda" else None
        inputs = graphs_mod.share_with("mapper", (R, t, points, obs_valid) + tuple(prob))
        with graphs_mod.on_owner_stream(device, "mapper"):
            graphs_mod.wait_for(inputs)
            res = optim.solve_ba_streams(prob, R, t, points, obs_valid, iters_huber, iters_trimmed, **steps)
            results = graphs_mod.share_with(caller, res)
        graphs_mod.wait_for(results)
        return res

    solve.captured = lambda: list(steps.values())
    return solve
