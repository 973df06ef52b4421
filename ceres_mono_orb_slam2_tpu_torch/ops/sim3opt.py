"""Sim(3) optimizers: two-view Sim(3) refinement and the essential graph.

Port of `ceres_mono_orb_slam2_tpu/ops/sim3opt.py`, the equivalents of the
reference's loop-closing optimizers:
- OptimizeSim3 (analytic Sim3ErrorTerm): 7-dof LM on the relative Sim(3)
  between two loop keyframes with both projection directions and
  Huber(sqrt(10)).
- OptimizeEssentialGraph (BCH-approximate Jacobians): pose graph over all
  keyframes as Sim(3) elements, residual log(S_ji S_i S_j^-1). The normal
  equations are solved matrix-free by block-Jacobi preconditioned conjugate
  gradients; every H v product is two gathers and two segment sums over the
  edge list.

Both run a fixed number of iterations with accept/reject as `torch.where`
masks: no host read inside a solve. Edge-to-vertex reductions use
`ops/optim.SegmentSum`, built once per problem, so two solves of the same
problem give the same bits on every device.

Tangent order everywhere: (upsilon(3), omega(3), sigma), see ops/lie.py.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch

from ceres_mono_orb_slam2_tpu_torch.ops import lie
from ceres_mono_orb_slam2_tpu_torch.ops.optim import (
    SegmentSum, _proj_jacobian, _project, group_sum, huber_cost, huber_weight, pcg, segment_sum)


class Sim3Result(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor  # (N,) chi2 pass in both directions
    n_inliers: torch.Tensor


class Sim3Problem(NamedTuple):
    """What stays fixed through a Sim(3) refinement: the matches. Tensors
    only, so that one LM iteration is a function of tensors
    (`sim3_lm_iteration`, captured by `LoopClosing` at one row count)."""
    K1: torch.Tensor
    K2: torch.Tensor
    X1: torch.Tensor  # (N, 3)
    X2: torch.Tensor  # (N, 3)
    uv1: torch.Tensor  # (N, 2)
    uv2: torch.Tensor  # (N, 2)
    inv_sigma1: torch.Tensor  # (N,)
    inv_sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool


class Sim3State(NamedTuple):
    """The carry of the refinement's LM loop."""
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


def _sim3_residuals(prob: Sim3Problem, R, t, s):
    q1 = s * (prob.X2 @ R.T) + t  # S12 X2 in camera 1
    Ri, ti, si = lie.sim3_inverse(R, t, s)
    q2 = si * (prob.X1 @ Ri.T) + ti  # S12^-1 X1 in camera 2
    return prob.uv1 - _project(prob.K1, q1), prob.uv2 - _project(prob.K2, q2), q1, q2


def _sim3_cost(prob: Sim3Problem, R, t, s, delta: float):
    r1, r2, _, _ = _sim3_residuals(prob, R, t, s)
    c = (huber_cost(prob.inv_sigma1 * (r1 * r1).sum(-1), delta)
         + huber_cost(prob.inv_sigma2 * (r2 * r2).sum(-1), delta))
    return torch.where(prob.valid, c, torch.zeros_like(c)).sum()


def sim3_lm_iteration(state: Sim3State, prob: Sim3Problem, delta: float = math.sqrt(10.0)) -> Sim3State:
    """One LM iteration of `optimize_sim3` (tensors in and out: the function
    `LoopClosing` captures, at the default Huber width sqrt(10))."""
    R, t, s, lam, cost = state
    X1, inv_sigma1, inv_sigma2, valid = prob.X1, prob.inv_sigma1, prob.inv_sigma2, prob.valid
    dt, dev = X1.dtype, X1.device
    eye3 = torch.eye(3, dtype=dt, device=dev).expand(X1.shape[:-1] + (3, 3))
    eye7 = torch.eye(7, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    r1, r2, q1, q2 = _sim3_residuals(prob, R, t, s)
    s1 = inv_sigma1 * (r1 * r1).sum(-1)
    s2 = inv_sigma2 * (r2 * r2).sum(-1)
    w1 = torch.where(valid, inv_sigma1 * huber_weight(s1, delta), zero)
    w2 = torch.where(valid, inv_sigma2 * huber_weight(s2, delta), zero)
    # direction 1: q1 = exp(d) S12 X2 => dq1/dd = [I | -hat(q1) | q1]
    D1 = torch.cat([eye3, -lie.hat(q1), q1[..., None]], dim=-1)  # (N, 3, 7)
    J1 = -(_proj_jacobian(prob.K1, q1) @ D1)  # (N, 2, 7), dr1/dd
    # direction 2: q2 = (exp(d) S12)^-1 X1 = S12^-1 exp(-d) X1
    # => dq2/dd = -s^-1 R^T [I | -hat(X1) | X1], dr2/dd = +Jp2 s^-1 R^T D2
    D2 = torch.cat([eye3, -lie.hat(X1), X1[..., None]], dim=-1)
    J2 = _proj_jacobian(prob.K2, q2) @ ((1.0 / s) * R.T @ D2)
    H = (torch.einsum("nik,n,nil->kl", J1, w1, J1)
         + torch.einsum("nik,n,nil->kl", J2, w2, J2))
    g = -(torch.einsum("nik,n,ni->k", J1, w1, r1) + torch.einsum("nik,n,ni->k", J2, w2, r2))
    Hd = H + lam * torch.diag_embed(torch.diagonal(H)) + 1e-8 * eye7
    # solve_ex: the bits of solve without its host check of `info`
    dx = torch.linalg.solve_ex(Hd, g)[0]
    # clamp the scale increment (Sim3Parameterization guards the scale
    # from collapsing)
    dx = torch.cat([dx[:6], dx[6:].clamp(-2.0, 2.0)])
    dR, dtv, ds = lie.sim3_exp(dx)
    R_new, t_new, s_new = lie.sim3_compose(dR, dtv, ds, R, t, s)
    new_cost = _sim3_cost(prob, R_new, t_new, s_new, delta)
    accept = new_cost < cost
    return Sim3State(R=torch.where(accept, R_new, R), t=torch.where(accept, t_new, t),
                     s=torch.where(accept, s_new, s),
                     lam=torch.where(accept, (lam * 0.33).clamp_min(1e-7), (lam * 4.0).clamp_max(1e5)),
                     cost=torch.where(accept, new_cost, cost))


def optimize_sim3(
    K1,
    K2,
    X1,  # (N, 3) matched points in the camera-1 frame
    X2,  # (N, 3) matched points in the camera-2 frame
    uv1,  # (N, 2) observed pixels in image 1 (matching X2 via S12)
    uv2,  # (N, 2) observed pixels in image 2 (matching X1 via S12^-1)
    inv_sigma1,  # (N,)
    inv_sigma2,  # (N,)
    valid,  # (N,)
    R0,
    t0,
    s0,
    max_iters: int = 15,
    chi2_th: float = 10.0,
    step=None,
) -> Sim3Result:
    """Refine S12 (the camera-2 to camera-1 similarity) from matched
    camera-frame points.

    Residuals (Sim3ErrorTerm, both directions):
      r1 = uv1 - proj(K1, S12 X2),  r2 = uv2 - proj(K2, S12^-1 X1)
    Huber(sqrt(chi2_th)); LM on the 7-dof left increment.

    Its set-up (the start projected onto SO(3), the first cost), `max_iters`
    calls of `step(state, problem)` (by default `sim3_lm_iteration` at
    `chi2_th`'s Huber width; `LoopClosing` passes its captured program,
    whose width is the default's, so a step passed with another `chi2_th`
    raises) and its finish (the inlier test).
    """
    if step is not None and chi2_th != 10.0:
        raise ValueError(f"optimize_sim3: a step passed with chi2_th {chi2_th}; its Huber width is sqrt(10)")
    delta = math.sqrt(chi2_th)
    prob = Sim3Problem(K1, K2, X1, X2, uv1, uv2, inv_sigma1, inv_sigma2, valid)
    step = step or partial(sim3_lm_iteration, delta=delta)
    s = torch.as_tensor(s0, dtype=X1.dtype, device=X1.device)
    R = lie.so3_project(R0)
    state = Sim3State(R, t0, s, torch.tensor(1e-3, dtype=X1.dtype, device=X1.device),
                      _sim3_cost(prob, R, t0, s, delta))
    for _ in range(max_iters):
        state = step(state, prob)
    R, t, s = lie.so3_project(state.R), state.t, state.s
    r1, r2, _, _ = _sim3_residuals(prob, R, t, s)
    c1 = inv_sigma1 * (r1 * r1).sum(-1)
    c2 = inv_sigma2 * (r2 * r2).sum(-1)
    inliers = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
    return Sim3Result(R=R, t=t, s=s, inliers=inliers, n_inliers=inliers.sum(dtype=torch.int32))


class EssentialGraphResult(NamedTuple):
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3)
    s: torch.Tensor  # (P,)
    cost: torch.Tensor


def _edge_residuals(R, t, s, ei, ej, Rm, tm, sm):
    """r_e = log(S_ji S_i S_j^-1) for each edge (measurement S_ji)."""
    Rji_i, tji_i, sji_i = lie.sim3_compose(Rm, tm, sm, R[ei], t[ei], s[ei])
    Rjinv, tjinv, sjinv = lie.sim3_inverse(R[ej], t[ej], s[ej])
    return lie.sim3_log(*lie.sim3_compose(Rji_i, tji_i, sji_i, Rjinv, tjinv, sjinv))  # (E, 7)


class EGProblem(NamedTuple):
    """What stays fixed through an essential-graph solve: the edges, their
    measurements and adjoints, the weights, the free-vertex mask and the
    edge-to-vertex segment-sum index. Tensors only, so that one GN
    iteration is a function of tensors (`gn_iteration`, captured per shape
    by `LoopClosing`)."""
    ei: torch.Tensor  # (E,) int64
    ej: torch.Tensor
    Rm: torch.Tensor  # (E, 3, 3) measured S_ji
    tm: torch.Tensor
    sm: torch.Tensor
    Adj_m: torch.Tensor  # (E, 7, 7)
    ew: torch.Tensor  # (E,) edge weight (validity as 0 / 1)
    free: torch.Tensor  # (P, 1) 1 where the vertex moves
    to_vertex: torch.Tensor  # SegmentSum index over [i-ends, j-ends]


class EGState(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


def _eg_cost(prob: EGProblem, R, t, s, allsum):
    r = _edge_residuals(R, t, s, prob.ei, prob.ej, prob.Rm, prob.tm, prob.sm)
    return allsum((prob.ew * (r * r).sum(-1)).sum())


def _gn_iteration(state: EGState, prob: EGProblem, cg_iters: int, allsum) -> EGState:
    """One damped Gauss-Newton iteration of `optimize_essential_graph`, its
    `cg_iters` PCG iterations included."""
    R, t, s, lam, cost = state
    ei, ej, ew, free = prob.ei, prob.ej, prob.ew, prob.free
    eye7 = torch.eye(7, dtype=R.dtype, device=R.device)

    def to_vertex(v):
        return allsum(segment_sum(prob.to_vertex, v))

    r = _edge_residuals(R, t, s, ei, ej, prob.Rm, prob.tm, prob.sm)  # (E, 7)
    Ji = (lie.sim3_right_jacobian_inv_approx(-r) @ prob.Adj_m) * ew[:, None, None]  # (E, 7, 7)
    Jj = -lie.sim3_right_jacobian_inv_approx(r) * ew[:, None, None]
    # gradient b = -J^T r, summed onto the vertices
    b = to_vertex(torch.cat([-torch.einsum("eki,ek->ei", Ji, r),
                             -torch.einsum("eki,ek->ei", Jj, r)])) * free
    # block diagonal of H: the Jacobi preconditioner and the damping
    Hdiag = to_vertex(torch.cat([torch.einsum("eki,ekl->eil", Ji, Ji),
                                 torch.einsum("eki,ekl->eil", Jj, Jj)]))
    Hdamp = lam * (Hdiag * eye7)
    # inv_ex: the bits of inv without its host check of `info`
    Minv = torch.linalg.inv_ex(Hdiag + Hdamp + 1e-6 * eye7)[0]

    def Hv(x):  # damped Gauss-Newton matvec, matrix-free over the edges
        yi = torch.einsum("ekl,el->ek", Ji, x[ei]) + torch.einsum("ekl,el->ek", Jj, x[ej])
        out = to_vertex(torch.cat([torch.einsum("eki,ek->ei", Ji, yi),
                                   torch.einsum("eki,ek->ei", Jj, yi)]))
        return (out + torch.einsum("pij,pj->pi", Hdamp, x) + 1e-6 * x) * free

    dx = pcg(Hv, lambda v: torch.einsum("pij,pj->pi", Minv, v), b, cg_iters) * free
    dR, dtv, ds = lie.sim3_exp(dx)
    R_new = dR @ R
    t_new = ds[:, None] * (dR @ t[..., None])[..., 0] + dtv
    s_new = ds * s
    new_cost = _eg_cost(prob, R_new, t_new, s_new, allsum)
    accept = new_cost < cost
    return EGState(R=torch.where(accept, R_new, R), t=torch.where(accept, t_new, t),
                   s=torch.where(accept, s_new, s),
                   lam=torch.where(accept, (lam * 0.33).clamp_min(1e-6), (lam * 4.0).clamp_max(1e4)),
                   cost=torch.where(accept, new_cost, cost))


def gn_iteration(state: EGState, prob: EGProblem, cg_iters: int = 100) -> EGState:
    """One GN iteration of the single-process essential graph (tensors in
    and out; `LoopClosing` captures it per (P, E) with `cg_iters` bound)."""
    return _gn_iteration(state, prob, cg_iters, group_sum(None))


def optimize_essential_graph(
    R,  # (P, 3, 3) initial Sim(3) rotations (world -> camera, s R | t form)
    t,  # (P, 3)
    s,  # (P,)
    edge_i,  # (E,) integer
    edge_j,  # (E,) integer
    Rm,  # (E, 3, 3) measured S_ji
    tm,  # (E, 3)
    sm,  # (E,)
    edge_valid,  # (E,) bool
    fixed,  # (P,) bool: at least the loop keyframe
    gn_iters: int = 30,
    cg_iters: int = 100,
    group=None,
    step=None,
) -> EssentialGraphResult:
    """Sim(3) pose-graph optimization, matrix-free PCG Gauss-Newton.

    Jacobians use the reference's BCH approximation
    (Jr^-1 ~ I + ad/2 + ad^2/12), with left increments S <- exp(d) S:
      dr/ddelta_i =  Jl^-1(r) Adj(S_ji),   dr/ddelta_j = -Jr^-1(r)

    With a torch.distributed `group` (the JAX package's `axis_name`), each
    rank holds a block of the edges: every edge-axis sum (the cost, b, the
    block diagonal of H, the H v matvec) is this rank's segment sum
    followed by an all_reduce over the group, and the (P, 7) vertex state
    stays replicated (parallel/sharded_ba.optimize_essential_graph_sharded).

    `step(state, problem)` runs one GN iteration (by default
    `_gn_iteration` with `cg_iters` and the group's sum; `LoopClosing`
    passes its captured `gn_iteration` without a group).
    """
    P = R.shape[0]
    dev, dt = R.device, R.dtype
    ei, ej = edge_i.long(), edge_j.long()
    allsum = group_sum(group)
    # every edge lands on its two vertices: one segment sum over [i-ends, j-ends]
    prob = EGProblem(ei, ej, Rm, tm, sm, lie.sim3_adjoint(Rm, tm, sm), edge_valid.to(dt),
                     (~fixed).to(dt)[:, None], SegmentSum(torch.cat([ei, ej]), P).index)
    step = step or partial(_gn_iteration, cg_iters=cg_iters, allsum=allsum)
    state = EGState(R, t, s, torch.tensor(1e-4, dtype=dt, device=dev),
                    _eg_cost(prob, R, t, s, allsum))
    for _ in range(gn_iters):
        state = step(state, prob)
    return EssentialGraphResult(R=lie.so3_project(state.R), t=state.t, s=state.s, cost=state.cost)
