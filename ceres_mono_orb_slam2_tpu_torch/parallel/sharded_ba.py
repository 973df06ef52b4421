"""Global bundle adjustment and the essential graph sharded over a device mesh.

Port of `ceres_mono_orb_slam2_tpu/parallel/sharded_ba.py`. The CG solver's
heavy work is observation-wise (Jacobian blocks, Schur matvecs and robust
costs are gathers, small products and segment sums over the O axis), so it
data-parallelizes by giving each rank a contiguous block of the
observations, keeping poses and points replicated, and turning every O-axis
sum into a local segment sum and an all_reduce over the mesh axis
(`ops/optim.bundle_adjustment_cg`'s `group`). Each LM / CG step then moves
two (P, 6) + (M, 3) sums between the ranks. The essential graph shards its
edge axis the same way (`ops/sim3opt.optimize_essential_graph`'s `group`).

Every rank calls these functions with the full arrays (the JAX package's
global arrays) and gets the same result back: poses, points, scales and
cost replicated, the inlier mask gathered to all O observations. The
reference's only BA parallelism is Ceres `options.num_threads = 4`
(CeresOptimizer.cc:516).
"""

from __future__ import annotations

import torch

from ceres_mono_orb_slam2_tpu_torch.ops import optim, sim3opt
from ceres_mono_orb_slam2_tpu_torch.parallel.mesh import (
    axis_size, block, gather_blocks, mesh_device)


def _on(device, dtype=None):
    return lambda a: torch.as_tensor(a, dtype=dtype, device=device)


def bundle_adjustment_cg_sharded(
    mesh,
    axis: str,
    K, R, t, points,
    obs_pose, obs_point, obs_uv, obs_inv_sigma2, obs_valid,
    fixed_pose, point_valid,
    iters: int = 20,
    cg_iters: int = 50,
    robust: bool = True,
) -> optim.BAResult:
    """Run bundle_adjustment_cg with the observation axis split over
    `mesh[axis]`, each rank solving with its contiguous block of the
    observations. The observation count must be divisible by the axis size
    (pad `obs_valid` with False rows). Returns the same BAResult as the
    single-process solver on every rank: R, t, points and cost replicated,
    `inlier_obs` the full (O,) mask."""
    n = axis_size(mesh, axis)
    O = obs_pose.shape[0]
    if O % n != 0:
        raise ValueError(f"observation count {O} not divisible by mesh axis {n}")
    dev = mesh_device(mesh)
    f32, idx, mask = _on(dev, torch.float32), _on(dev, torch.int64), _on(dev, torch.bool)
    obs = [block(x, mesh, axis) for x in (idx(obs_pose), idx(obs_point), f32(obs_uv),
                                           f32(obs_inv_sigma2), mask(obs_valid))]
    res = optim.bundle_adjustment_cg(
        f32(K), f32(R), f32(t), f32(points), *obs, mask(fixed_pose), mask(point_valid),
        iters=iters, cg_iters=cg_iters, robust=robust, group=mesh.get_group(axis))
    return res._replace(inlier_obs=gather_blocks(res.inlier_obs, mesh, axis))


def optimize_essential_graph_sharded(
    mesh,
    axis: str,
    R, t, s,
    edge_i, edge_j, Rm, tm, sm, edge_valid, fixed,
    gn_iters: int = 30,
    cg_iters: int = 100,
) -> sim3opt.EssentialGraphResult:
    """Run optimize_essential_graph with the EDGE axis split over
    `mesh[axis]` (reference analogue: CeresOptimizer::OptimizeEssentialGraph,
    CeresOptimizer.cc:737-957, which Ceres solves single-threaded). The
    (P, 7) Sim(3) vertex state is replicated; each GN / PCG step sums the
    per-edge terms over the ranks. The edge count must be divisible by the
    axis size (pad `edge_valid` with False rows)."""
    n = axis_size(mesh, axis)
    E = edge_i.shape[0]
    if E % n != 0:
        raise ValueError(f"edge count {E} not divisible by mesh axis {n}")
    dev = mesh_device(mesh)
    f32, idx, mask = _on(dev, torch.float32), _on(dev, torch.int64), _on(dev, torch.bool)
    edges = [block(x, mesh, axis) for x in (idx(edge_i), idx(edge_j), f32(Rm), f32(tm), f32(sm),
                                             mask(edge_valid))]
    return sim3opt.optimize_essential_graph(
        f32(R), f32(t), f32(s), *edges, mask(fixed), gn_iters=gn_iters, cg_iters=cg_iters,
        group=mesh.get_group(axis))
