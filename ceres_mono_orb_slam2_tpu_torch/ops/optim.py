"""Levenberg-Marquardt optimizers, the Ceres Solver replacement.

Port of `ceres_mono_orb_slam2_tpu/ops/optim.py`: motion-only pose
optimization, bundle adjustment with a dense point-block Schur complement
(`bundle_adjustment`, local windows; `bundle_adjustment_streams`, S such
problems of one shape at once) and with the point block eliminated
implicitly and the pose system solved by conjugate gradients
(`bundle_adjustment_cg`, any map size).
Residuals and analytic Jacobians are batched over observations; the normal
equations assemble with deterministic segment sums (`SegmentSum`), not the
one-hot matmuls the TPU needed, whose (O, M) operand is 1 GB at the default
BA budgets.

Conventions: poses are world->camera (Tcw) as (R, t); updates are
left-multiplicative se3 increments T <- exp(dx) * T.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch

from ceres_mono_orb_slam2_tpu_torch.ops import lie
from ceres_mono_orb_slam2_tpu_torch.utils import graphs

CHI2_MONO = 5.991  # 2-dof 95% chi-square gate


def huber_weight(s, delta):
    """IRLS weight rho'(s) for Ceres HuberLoss(delta); s = squared norm."""
    return torch.where(s <= delta * delta, torch.ones_like(s), delta / torch.sqrt(s.clamp_min(1e-12)))


def huber_cost(s, delta):
    d2 = delta * delta
    return torch.where(s <= d2, s, 2.0 * delta * torch.sqrt(s.clamp_min(1e-12)) - d2)


def _safe_inv_z(z):
    return 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)


def _proj_jacobian(K, Xc):
    """d(pixel)/d(camera point): (..., 2, 3)."""
    fx, fy = K[0, 0], K[1, 1]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = _safe_inv_z(z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row1 = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj / det[..., None, None]


def _solve6_spd(H, g):
    """Solve H x = g for SPD 6x6 via a 2x2-block Schur on 3x3 blocks."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, 3:]
    g1 = g[..., :3]
    g2 = g[..., 3:]
    Bt = B.transpose(-1, -2)
    Ainv = _inv3x3(A)
    Sinv = _inv3x3(C - Bt @ Ainv @ B)
    y1 = (Ainv @ g1[..., None])[..., 0]
    x2 = (Sinv @ (g2 - (Bt @ y1[..., None])[..., 0])[..., None])[..., 0]
    x1 = (Ainv @ (g1 - (B @ x2[..., None])[..., 0])[..., None])[..., 0]
    return torch.cat([x1, x2], dim=-1)


def _project(K, Xc):
    zi = _safe_inv_z(Xc[..., 2])
    u = K[0, 0] * Xc[..., 0] * zi + K[0, 2]
    v = K[1, 1] * Xc[..., 1] * zi + K[1, 2]
    return torch.stack([u, v], dim=-1)


def _pose_jacobian(Jp, Xc):
    """d(residual)/d(left se3 increment) with residual = obs - proj:
    -(Jp @ [I | -hat(Xc)])."""
    return -torch.cat([Jp, -Jp @ lie.hat(Xc)], dim=-1)


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # (..., N) bool: valid obs passing the chi2 gate
    n_inliers: torch.Tensor  # (...) int32
    cost: torch.Tensor
    iters: torch.Tensor  # (rounds,) int32: LM iterations each round ran


def pose_optimization(K, R0, t0, pts3d, uv, inv_sigma2, valid, max_iters: int = 25,
                      chi2_th: float = CHI2_MONO, rounds: int = 4) -> PoseOptResult:
    """Motion-only BA of one frame (PoseOptimization): minimise
    sum huber(w * ||uv - proj(R X + t)||^2) over the 6-dof pose in `rounds`
    LM blocks, re-classifying inliers at chi2_th between blocks (the
    ORB-SLAM2 4-round trimming).

    Each block is the JAX package's while_loop: up to `max_iters`
    iterations with a `done` mask that freezes the state once the loop
    would have exited (an accepted step that barely moved the cost, or a
    rejection with damping past 1). Each iteration runs under
    `graphs.run_if((~done).any())`: in a captured program the iterations
    after every problem is done are skipped on the device; run eagerly, all
    `max_iters` run and the mask keeps their results, with no host
    synchronisation per iteration. The loop state is written in place, so
    a skipped iteration leaves it as it was. `iters[k]` counts the
    iterations block k ran (the while_loop's counter), the same either way.

    R0 (..., 3, 3), t0 (..., 3), pts3d (..., N, 3), uv (..., N, 2), inv_sigma2
    and valid (..., N): the leading axes (none, or one entry per stream) are
    independent problems, each with its own damping, cost and `done`, so a
    stream that has converged stays frozen while the others go on, and the
    block runs until every stream is done (the vmapped while_loop). K is
    shared. The result's fields but `iters` carry the same leading axes.
    """
    delta = math.sqrt(chi2_th)
    dev, dt = R0.device, R0.dtype
    lead = R0.shape[:-2]
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(R, t):
        Xc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
        return uv - _project(K, Xc), Xc, Xc[..., 2] <= 0.05

    def cost_fn(R, t, active):
        r, _, behind = residuals(R, t)
        s = inv_sigma2 * (r * r).sum(-1)
        s = torch.where(behind, torch.full_like(s, 1e6), s)
        return torch.where(active, huber_cost(s, delta), torch.zeros_like(s)).sum(-1)

    def iteration(R, t, cost, lam, done, active):
        """One LM iteration, written into R, t, cost, lam and done."""
        r, Xc, behind = residuals(R, t)
        s = inv_sigma2 * (r * r).sum(-1)
        w = inv_sigma2 * huber_weight(s, delta)
        w = torch.where(active & ~behind, w, torch.zeros_like(w))
        Jr = _pose_jacobian(_proj_jacobian(K, Xc), Xc)  # (..., N, 2, 6)
        wJ = w[..., None, None] * Jr
        H = torch.einsum("...nik,...nil->...kl", wJ, Jr)
        g = -torch.einsum("...nik,...ni->...k", wJ, r)
        Hd = (H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
              + 1e-8 * eye6)
        dR, dtv = lie.se3_exp(_solve6_spd(Hd, g))
        R_new = dR @ R
        t_new = lie.matvec(dR, t) + dtv
        new_cost = cost_fn(R_new, t_new, active)
        accept = new_cost < cost
        stop = (accept & (cost - new_cost <= 1e-6 * cost)) | (~accept & (lam >= 1.0))
        take = accept & ~done
        torch.where(take[..., None, None], R_new, R, out=R)
        torch.where(take[..., None], t_new, t, out=t)
        torch.where(take, new_cost, cost, out=cost)
        torch.where(done, lam, torch.where(accept, (lam * 0.25).clamp_min(1e-8),
                                           (lam * 4.0).clamp_max(1e5)), out=lam)
        done |= stop

    # project the initial rotation onto SO(3): the motion-model prediction
    # composes previous solutions and accumulates determinant drift
    R, t = lie.so3_project(R0), t0.clone()
    active = valid
    cost = None
    iters = torch.zeros(max(rounds, 1), dtype=torch.int32, device=dev)
    for k in range(max(rounds, 1)):
        # the block's loop state, written in place by its iterations
        cost = cost_fn(R, t, active)
        lam = torch.full(lead, 1e-4, dtype=dt, device=dev)
        done = torch.zeros(lead, dtype=torch.bool, device=dev)
        for _ in range(max_iters):
            running = (~done).any()
            with graphs.run_if(running):
                iters[k].add_(running)
                iteration(R, t, cost, lam, done, active)
        R = lie.so3_project(R)
        # re-classify: outliers leave, returners re-enter
        r, Xc, behind = residuals(R, t)
        chi2 = inv_sigma2 * (r * r).sum(-1)
        active = valid & ~behind & (chi2 <= chi2_th)
    return PoseOptResult(R=R, t=t, inliers=active,
                         n_inliers=active.to(torch.int32).sum(-1), cost=cost, iters=iters)


def group_sum(group):
    """x -> x summed over the ranks of a torch.distributed `group`, in place
    (callers pass fresh results; a strided view is made contiguous first,
    as NCCL requires); the identity without a group."""
    if group is None:
        return lambda x: x
    import torch.distributed as dist

    def allsum(x):
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    return allsum


def segment_sum(index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Rows of `values` summed per segment through a `SegmentSum.index`
    block: a gather into (n, width, ...) then a sum along the width, in an
    order that depends only on the shapes."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[index].sum(1)


class SegmentSum:
    """Deterministic segment sums over a fixed set of observations.

    `SegmentSum(keys, n)(v)` equals `zeros(n, ...).index_add_(0, keys, v)`
    up to summation order, but uses no float atomics, so the same inputs
    give the same bits on every run: each segment's contributions are
    gathered, in observation order, into a zero-padded (n, width) block and
    summed along it, a reduction whose order depends only on the shapes.
    The index block is built once per problem; `width` is the largest
    segment (one host read of it), so build it outside a captured program
    and pass `index` in (`segment_sum`).
    """

    def __init__(self, keys: torch.Tensor, n_segments: int):
        keys = keys.long()
        n_obs = keys.shape[0]
        counts = torch.bincount(keys, minlength=n_segments)
        width = max(int(counts.max()) if n_segments else 0, 1)
        order = torch.sort(keys, stable=True).indices
        sorted_keys = keys[order]
        rank = torch.arange(n_obs, device=keys.device) - (torch.cumsum(counts, 0) - counts)[sorted_keys]
        # entries past a segment's count point at an appended zero row
        self.index = torch.full((n_segments, width), n_obs, dtype=torch.long, device=keys.device)
        self.index[sorted_keys, rank] = order

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        return segment_sum(self.index, values)


def assemble_normal_equations(by_pose, by_point, by_pair, A, B, r, w, P: int, M: int):
    """BA normal-equation blocks from per-observation Jacobians A (O, 2, 6)
    (pose), B (O, 2, 3) (point), residuals r (O, 2) and weights w (O,):
    Hpp (P, 6, 6), bp (P, 6), Hll (M, 3, 3), bl (M, 3) and the pose-point
    cross blocks U (M, P, 6, 3), summed per pose, per point and per
    (point, pose) pair by the three segment sums (`SegmentSum`s or
    `segment_sum` over their index blocks)."""
    wA = w[:, None, None] * A
    wB = w[:, None, None] * B
    Hpp = by_pose(torch.einsum("oik,oil->okl", wA, A))
    bp = by_pose(-torch.einsum("oik,oi->ok", wA, r))
    Hll = by_point(torch.einsum("oik,oil->okl", wB, B))
    bl = by_point(-torch.einsum("oik,oi->ok", wB, r))
    U = by_pair(torch.einsum("oik,oil->okl", wA, B)).reshape(M, P, 6, 3)
    return Hpp, bp, Hll, bl, U


class BAResult(NamedTuple):
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3)
    points: torch.Tensor  # (M, 3)
    inlier_obs: torch.Tensor  # (O,) bool
    cost: torch.Tensor


class BAProblem(NamedTuple):
    """What stays fixed through a dense-Schur bundle adjustment: the
    observations, the gauge and the three segment-sum index blocks. Tensors
    only, so that one LM iteration is a function of tensors (`lm_iteration_*`,
    captured per shape by `utils/graphs.py`)."""
    K: torch.Tensor  # (3, 3)
    obs_pose: torch.Tensor  # (O,) int64
    obs_point: torch.Tensor  # (O,) int64
    obs_uv: torch.Tensor  # (O, 2)
    obs_inv_sigma2: torch.Tensor  # (O,)
    point_valid: torch.Tensor  # (M,) bool
    free6: torch.Tensor  # (6P,) bool: the pose parameters that move
    by_pose: torch.Tensor  # SegmentSum index blocks: per pose, per point,
    by_point: torch.Tensor  # per (point, pose) pair
    by_pair: torch.Tensor


class LMState(NamedTuple):
    """The carry of one LM pass (the JAX package's scan carry): poses,
    points, damping, cost, and `done`, which freezes the rest once an
    accepted step has converged."""
    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    done: torch.Tensor


def ba_problem(K, obs_pose, obs_point, obs_uv, obs_inv_sigma2, fixed_pose, point_valid) -> BAProblem:
    """The `BAProblem` of P = len(fixed_pose) poses and M = len(point_valid)
    points (three host reads: the segment widths)."""
    P, M = fixed_pose.shape[0], point_valid.shape[0]
    op, oj = obs_pose.long(), obs_point.long()
    return BAProblem(K, op, oj, obs_uv, obs_inv_sigma2, point_valid,
                     (~fixed_pose).repeat_interleave(6), SegmentSum(op, P).index,
                     SegmentSum(oj, M).index, SegmentSum(oj * P + op, M * P).index)


def _ba_chi2(prob: BAProblem, Rp, tp, pts):
    op, oj = prob.obs_pose, prob.obs_point
    Xc = (Rp[op] @ pts[oj][..., None])[..., 0] + tp[op]
    r = prob.obs_uv - _project(prob.K, Xc)
    s = prob.obs_inv_sigma2 * (r * r).sum(-1)
    return torch.where(Xc[..., 2] <= 1e-6, torch.full_like(s, 1e6), s), r, Xc


def _ba_cost(prob: BAProblem, Rp, tp, pts, mask, robust: bool, delta: float):
    s, _, _ = _ba_chi2(prob, Rp, tp, pts)
    c = huber_cost(s, delta) if robust else s
    return torch.where(mask, c, torch.zeros_like(c)).sum()


def _lm_iteration(state: LMState, mask, prob: BAProblem, robust: bool, delta: float) -> LMState:
    """One LM iteration of `bundle_adjustment`'s dense Schur solve. A state
    that is `done` stays as it is; an accepted step that lowers the cost by
    at most 1e-6 of it (the Ceres function tolerance) sets `done`."""
    Rp, tp, pts, lam, cost, done = state
    P, M = Rp.shape[0], pts.shape[0]
    dt = Rp.dtype
    eye3 = torch.eye(3, dtype=dt, device=Rp.device)
    eye6 = torch.eye(6, dtype=dt, device=Rp.device)
    free6 = prob.free6
    s, r, Xc = _ba_chi2(prob, Rp, tp, pts)
    w = prob.obs_inv_sigma2 * (huber_weight(s, delta) if robust else 1.0)
    w = torch.where(mask & (Xc[..., 2] > 1e-6), w, torch.zeros_like(w))
    Jp = _proj_jacobian(prob.K, Xc)  # (O, 2, 3)
    A = _pose_jacobian(Jp, Xc)  # (O, 2, 6)
    B = -(Jp @ Rp[prob.obs_pose])  # (O, 2, 3): dr/dX = -Jp R
    Hpp, bp, Hll, bl, U = assemble_normal_equations(
        partial(segment_sum, prob.by_pose), partial(segment_sum, prob.by_point),
        partial(segment_sum, prob.by_pair), A, B, r, w, P, M)
    U3 = U.reshape(M, P * 6, 3)

    Hll_d = Hll + lam * (Hll * eye3) + 1e-6 * eye3
    Hpp_d = Hpp + lam * (Hpp * eye6) + 1e-6 * eye6
    Hll_inv = torch.where(prob.point_valid[:, None, None], _inv3x3(Hll_d),
                          torch.zeros_like(Hll_d))
    T3 = torch.einsum("mak,mkl->mal", U3, Hll_inv)  # U Hll^-1
    # Schur complement S = blockdiag(Hpp_d) - sum_m U_m Hll_m^-1 U_m^T
    S = -torch.einsum("mak,mbk->ab", T3, U3)
    S = S + torch.block_diag(*Hpp_d)
    rhs = bp.reshape(P * 6) - torch.einsum("mak,mk->a", T3, bl)
    # gauge: zero rows/cols of fixed poses, identity diagonal
    S = torch.where(free6[:, None] & free6[None, :], S, torch.zeros_like(S))
    S = S + torch.diag(torch.where(free6, 0.0, 1.0).to(dt))
    rhs = torch.where(free6, rhs, torch.zeros_like(rhs))
    L, info = torch.linalg.cholesky_ex(S)
    dp = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    # a failed factorisation rejects the step (NaN cost), as in XLA
    dp = torch.where(info == 0, dp, torch.full_like(dp, float("nan"))).reshape(P, 6)

    dl = torch.einsum("mkl,ml->mk", Hll_inv,
                      bl - torch.einsum("mak,a->mk", U3, dp.reshape(P * 6)))
    dl = torch.where(prob.point_valid[:, None], dl, torch.zeros_like(dl))
    dRp, dtp = lie.se3_exp(dp)
    R_new = dRp @ Rp
    t_new = (dRp @ tp[..., None])[..., 0] + dtp
    pts_new = pts + dl
    new_cost = _ba_cost(prob, R_new, t_new, pts_new, mask, robust, delta)
    accept = new_cost < cost
    converged = accept & (cost - new_cost <= 1e-6 * cost)
    take = accept & ~done
    return LMState(R=torch.where(take, R_new, Rp), t=torch.where(take, t_new, tp),
                   points=torch.where(take, pts_new, pts),
                   lam=torch.where(done, lam, torch.where(accept, (lam * 0.33).clamp_min(1e-7),
                                                          (lam * 5.0).clamp_max(1e6))),
                   cost=torch.where(take, new_cost, cost), done=done | converged)


def lm_iteration_robust(state: LMState, mask, prob: BAProblem) -> LMState:
    """`bundle_adjustment`'s LM iteration of its Huber pass (tensors in and
    out: the function `LocalMapping` captures per shape)."""
    return _lm_iteration(state, mask, prob, True, math.sqrt(CHI2_MONO))


def lm_iteration_trimmed(state: LMState, mask, prob: BAProblem) -> LMState:
    """`bundle_adjustment`'s LM iteration of its trimmed quadratic pass."""
    return _lm_iteration(state, mask, prob, False, math.sqrt(CHI2_MONO))


def bundle_adjustment(K, R, t, points, obs_pose, obs_point, obs_uv, obs_inv_sigma2,
                      obs_valid, fixed_pose, point_valid, iters_huber: int = 5,
                      iters_trimmed: int = 10, chi2_th: float = CHI2_MONO,
                      robust_step=None, trimmed_step=None) -> BAResult:
    """Bundle adjustment with dense point-block Schur elimination
    (LocalBundleAdjustment's two passes): pass 1 Huber-robust, outliers
    (chi2 > 5.991) dropped, pass 2 trimmed quadratic. The normal equations,
    pose-point cross blocks U (M, P, 6, 3) included, are deterministic
    segment sums (`assemble_normal_equations`), and the reduced 6P x 6P
    system is solved by Cholesky.

    iters_huber=0 with iters_trimmed>0 over all-valid observations is a plain
    global BA. Each pass runs its fixed count of LM iterations (the JAX
    package's scan) and freezes its state at the Ceres function-tolerance
    convergence test (relative cost decrease <= 1e-6 on an accepted step):
    the bits of a pass that exits there, with no host read inside a solve.

    `robust_step` / `trimmed_step` run one iteration of each pass
    (`lm_iteration_robust` / `lm_iteration_trimmed` of `chi2_th`'s Huber
    width by default; `LocalMapping` passes their captured programs).
    """
    delta = math.sqrt(chi2_th)
    robust_step = robust_step or partial(_lm_iteration, robust=True, delta=delta)
    trimmed_step = trimmed_step or partial(_lm_iteration, robust=False, delta=delta)
    prob = ba_problem(K, obs_pose, obs_point, obs_uv, obs_inv_sigma2, fixed_pose, point_valid)

    def run_pass(Rp, tp, pts, mask, robust, step, n_iters):
        cost = _ba_cost(prob, Rp, tp, pts, mask, robust, delta)
        state = LMState(Rp, tp, pts, torch.tensor(1e-4, dtype=R.dtype, device=R.device), cost,
                        torch.zeros((), dtype=torch.bool, device=R.device))
        for _ in range(n_iters):
            state = step(state, mask, prob)
        return state.R, state.t, state.points, state.cost

    # pass 1: robust, rotations projected to SO(3) at entry and exit (BA
    # output feeds keyframe poses and triangulation)
    R1, t1, pts1, _ = run_pass(lie.so3_project(R), t, points, obs_valid, True, robust_step,
                               iters_huber)
    R1 = lie.so3_project(R1)
    s, _, Xc = _ba_chi2(prob, R1, t1, pts1)
    keep = obs_valid & (s <= chi2_th) & (Xc[..., 2] > 1e-6)
    # pass 2: quadratic on the survivors
    R2, t2, pts2, cost = run_pass(R1, t1, pts1, keep, False, trimmed_step, iters_trimmed)
    R2 = lie.so3_project(R2)
    s_final, _, Xc2 = _ba_chi2(prob, R2, t2, pts2)
    inlier_obs = obs_valid & (s_final <= chi2_th) & (Xc2[..., 2] > 1e-6)
    return BAResult(R=R2, t=t2, points=pts2, inlier_obs=inlier_obs, cost=cost)


class BAStreamsProblem(BAProblem):
    """A `BAProblem` of S windows of one shape (P poses, M points, O
    observations each) solved as one: pose and point indices offset per
    stream (s * P + p, s * M + m), so that one set of segment sums assembles
    all S normal equations, and the observations flattened to (S * O, ...).
    `free6` is (S, 6P). Each index block's width is padded to a power of two
    (`pow2_width`), so that windows of one shape share a program key as
    their jitted JAX solve shares one compilation."""
    __slots__ = ()


def pow2_width(index: torch.Tensor, n_obs: int) -> torch.Tensor:
    """A `SegmentSum.index` block widened to the next power of two with
    entries that point at the zero row."""
    n, width = index.shape
    return torch.cat([index, index.new_full((n, (1 << (width - 1).bit_length()) - width), n_obs)], 1)


def ba_streams_problem(K, obs_pose, obs_point, obs_uv, obs_inv_sigma2, fixed_pose,
                       point_valid) -> BAStreamsProblem:
    """The `BAStreamsProblem` of fixed_pose (S, P), point_valid (S, M) and
    observations (S, O, ...) (three host reads: the segment widths)."""
    S, P = fixed_pose.shape
    M, O = point_valid.shape[1], obs_pose.shape[1]
    stream = torch.arange(S, device=obs_pose.device)[:, None]
    op = (obs_pose.long() + stream * P).reshape(-1)
    oj = (obs_point.long() + stream * M).reshape(-1)
    pair = oj * P + obs_pose.long().reshape(-1)
    return BAStreamsProblem(
        K, op, oj, obs_uv.reshape(S * O, 2), obs_inv_sigma2.reshape(S * O), point_valid.reshape(S * M),
        (~fixed_pose).repeat_interleave(6, dim=1), pow2_width(SegmentSum(op, S * P).index, S * O),
        pow2_width(SegmentSum(oj, S * M).index, S * O), pow2_width(SegmentSum(pair, S * M * P).index, S * O))


def _ba_streams_cost(prob: BAStreamsProblem, Rp, tp, pts, mask, robust: bool, delta: float):
    """(S,) costs."""
    s, _, _ = _ba_chi2(prob, Rp, tp, pts)
    c = huber_cost(s, delta) if robust else s
    return torch.where(mask, c, torch.zeros_like(c)).reshape(prob.free6.shape[0], -1).sum(-1)


def _lm_iteration_streams(state: LMState, mask, prob: BAStreamsProblem, robust: bool,
                          delta: float) -> LMState:
    """`_lm_iteration` of S windows at once: R (S * P, 3, 3), t (S * P, 3),
    points (S * M, 3), mask (S * O,); lam, cost and done (S,), so a stream
    that is done stays as it is while the others iterate.

    The iteration runs under `graphs.run_if((~done).any())`, writing a copy
    of the state in place: in a captured program it is skipped on the device
    once every stream is done (the JAX scan's later iterations, which leave
    a done state as it is); eagerly it always runs, with the same bits."""
    out = LMState(*(x.clone() for x in state))
    with graphs.run_if((~state.done).any()):
        for dst, src in zip(out, _lm_streams_update(state, mask, prob, robust, delta)):
            dst.copy_(src)
    return out


def _lm_streams_update(state: LMState, mask, prob: BAStreamsProblem, robust: bool,
                       delta: float) -> LMState:
    """The state after one LM iteration of `_lm_iteration_streams`."""
    Rp, tp, pts, lam, cost, done = state
    free6 = prob.free6
    S, P = free6.shape[0], free6.shape[1] // 6
    M = pts.shape[0] // S
    dev, dt = Rp.device, Rp.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    pose_ar = torch.arange(P, device=dev)

    def per_pose(x):  # (S,) -> (S * P, 1, 1)
        return x[:, None].expand(S, P).reshape(S * P, 1, 1)

    def per_point(x):  # (S,) -> (S * M, 1, 1)
        return x[:, None].expand(S, M).reshape(S * M, 1, 1)

    s, r, Xc = _ba_chi2(prob, Rp, tp, pts)
    w = prob.obs_inv_sigma2 * (huber_weight(s, delta) if robust else 1.0)
    w = torch.where(mask & (Xc[..., 2] > 1e-6), w, torch.zeros_like(w))
    Jp = _proj_jacobian(prob.K, Xc)
    A = _pose_jacobian(Jp, Xc)
    B = -(Jp @ Rp[prob.obs_pose])
    Hpp, bp, Hll, bl, U = assemble_normal_equations(
        partial(segment_sum, prob.by_pose), partial(segment_sum, prob.by_point),
        partial(segment_sum, prob.by_pair), A, B, r, w, P, S * M)
    U3 = U.reshape(S, M, P * 6, 3)
    Hll_d = Hll + per_point(lam) * (Hll * eye3) + 1e-6 * eye3
    Hpp_d = Hpp + per_pose(lam) * (Hpp * eye6) + 1e-6 * eye6
    Hll_inv = torch.where(prob.point_valid[:, None, None], _inv3x3(Hll_d),
                          torch.zeros_like(Hll_d)).reshape(S, M, 3, 3)
    bl = bl.reshape(S, M, 3)
    T3 = torch.einsum("smak,smkl->smal", U3, Hll_inv)
    # per stream: S = blockdiag(Hpp_d) - sum_m U_m Hll_m^-1 U_m^T
    Sm = -torch.einsum("smak,smbk->sab", T3, U3).reshape(S, P, 6, P, 6)
    Sm[:, pose_ar, :, pose_ar, :] += Hpp_d.reshape(S, P, 6, 6).transpose(0, 1)
    Sm = Sm.reshape(S, P * 6, P * 6)
    rhs = bp.reshape(S, P * 6) - torch.einsum("smak,smk->sa", T3, bl)
    # gauge: zero rows/cols of fixed poses, identity diagonal
    Sm = torch.where(free6[:, :, None] & free6[:, None, :], Sm, torch.zeros_like(Sm))
    Sm = Sm + torch.diag_embed(torch.where(free6, 0.0, 1.0).to(dt))
    rhs = torch.where(free6, rhs, torch.zeros_like(rhs))
    L, info = torch.linalg.cholesky_ex(Sm)
    # the factor's two triangular solves (cuBLAS), not cholesky_solve, whose
    # batched CUDA form goes through MAGMA
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    dp = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    # a failed factorisation rejects that stream's step (NaN cost)
    dp = torch.where((info == 0)[:, None], dp, torch.full_like(dp, float("nan")))
    dl = torch.einsum("smkl,sml->smk", Hll_inv, bl - torch.einsum("smak,sa->smk", U3, dp))
    dl = torch.where(prob.point_valid[:, None], dl.reshape(S * M, 3), torch.zeros_like(pts))
    dRp, dtp = lie.se3_exp(dp.reshape(S * P, 6))
    R_new = dRp @ Rp
    t_new = (dRp @ tp[..., None])[..., 0] + dtp
    pts_new = pts + dl
    new_cost = _ba_streams_cost(prob, R_new, t_new, pts_new, mask, robust, delta)
    accept = new_cost < cost
    converged = accept & (cost - new_cost <= 1e-6 * cost)
    take = accept & ~done
    return LMState(R=torch.where(per_pose(take), R_new, Rp), t=torch.where(per_pose(take)[:, 0], t_new, tp),
                   points=torch.where(per_point(take)[:, 0], pts_new, pts),
                   lam=torch.where(done, lam, torch.where(accept, (lam * 0.33).clamp_min(1e-7),
                                                          (lam * 5.0).clamp_max(1e6))),
                   cost=torch.where(take, new_cost, cost), done=done | converged)


def lm_iteration_streams_robust(state: LMState, mask, prob: BAStreamsProblem,
                                delta: float = math.sqrt(CHI2_MONO)) -> LMState:
    """`bundle_adjustment_streams`' LM iteration of its Huber pass (tensors
    in and out: the function `make_multistream_local_ba` captures)."""
    return _lm_iteration_streams(state, mask, prob, True, delta)


def lm_iteration_streams_trimmed(state: LMState, mask, prob: BAStreamsProblem,
                                 delta: float = math.sqrt(CHI2_MONO)) -> LMState:
    """`bundle_adjustment_streams`' LM iteration of its trimmed quadratic pass."""
    return _lm_iteration_streams(state, mask, prob, False, delta)


def bundle_adjustment_streams(K, R, t, points, obs_pose, obs_point, obs_uv, obs_inv_sigma2,
                              obs_valid, fixed_pose, point_valid, iters_huber: int = 5,
                              iters_trimmed: int = 10, chi2_th: float = CHI2_MONO,
                              robust_step=None, trimmed_step=None) -> BAResult:
    """`bundle_adjustment` of S independent problems of one shape in one set
    of launches: R (S, P, 3, 3), t (S, P, 3), points (S, M, 3), observations
    (S, O, ...), fixed_pose (S, P), point_valid (S, M); every field of the
    result carries the stream axis, `cost` is (S,).

    One `BAStreamsProblem` holds all S windows, so one set of segment sums
    assembles all S normal equations; the S reduced 6P x 6P systems go
    through one batched Cholesky. Damping, cost, accept or reject and
    convergence are (S,) vectors: a stream that has converged keeps its
    state while the others iterate, so each stream takes the steps its own
    solve would take. Each pass runs its fixed count of iterations, with no
    host read inside the solve (`solve_ba_streams`)."""
    prob = ba_streams_problem(K, obs_pose, obs_point, obs_uv, obs_inv_sigma2, fixed_pose, point_valid)
    return solve_ba_streams(prob, R, t, points, obs_valid, iters_huber, iters_trimmed, chi2_th,
                            robust_step, trimmed_step)


def solve_ba_streams(prob: BAStreamsProblem, R, t, points, obs_valid, iters_huber: int = 5,
                     iters_trimmed: int = 10, chi2_th: float = CHI2_MONO, robust_step=None,
                     trimmed_step=None) -> BAResult:
    """The two passes of `bundle_adjustment_streams` over a built problem.
    `robust_step` / `trimmed_step` run one iteration of each pass
    (`lm_iteration_streams_robust` / `_trimmed` at `chi2_th`'s Huber width
    by default; `make_multistream_local_ba` passes their captured programs,
    whose width is the default's, so a step passed with another `chi2_th`
    raises)."""
    if chi2_th != CHI2_MONO and (robust_step or trimmed_step):
        raise ValueError(f"solve_ba_streams: steps passed with chi2_th {chi2_th}; their Huber width is "
                         f"sqrt({CHI2_MONO})")
    S, P = R.shape[:2]
    M, O = points.shape[1], obs_valid.shape[1]
    delta = math.sqrt(chi2_th)
    robust_step = robust_step or partial(lm_iteration_streams_robust, delta=delta)
    trimmed_step = trimmed_step or partial(lm_iteration_streams_trimmed, delta=delta)

    def run_pass(Rp, tp, pts, mask, robust, step, n_iters):
        cost = _ba_streams_cost(prob, Rp, tp, pts, mask, robust, delta)
        state = LMState(Rp, tp, pts, torch.full((S,), 1e-4, dtype=R.dtype, device=R.device), cost,
                        torch.zeros((S,), dtype=torch.bool, device=R.device))
        for _ in range(n_iters):
            state = step(state, mask, prob)
        return state.R, state.t, state.points, state.cost

    valid = obs_valid.reshape(S * O)
    R1, t1, pts1, _ = run_pass(lie.so3_project(R.reshape(S * P, 3, 3)), t.reshape(S * P, 3),
                               points.reshape(S * M, 3), valid, True, robust_step, iters_huber)
    R1 = lie.so3_project(R1)
    s, _, Xc = _ba_chi2(prob, R1, t1, pts1)
    keep = valid & (s <= chi2_th) & (Xc[..., 2] > 1e-6)
    R2, t2, pts2, cost = run_pass(R1, t1, pts1, keep, False, trimmed_step, iters_trimmed)
    R2 = lie.so3_project(R2)
    s_final, _, Xc2 = _ba_chi2(prob, R2, t2, pts2)
    inlier_obs = valid & (s_final <= chi2_th) & (Xc2[..., 2] > 1e-6)
    return BAResult(R=R2.reshape(S, P, 3, 3), t=t2.reshape(S, P, 3), points=pts2.reshape(S, M, 3),
                    inlier_obs=inlier_obs.reshape(S, O), cost=cost)


def pcg(matvec, precond, b, iters: int):
    """`iters` steps of preconditioned conjugate gradients on matvec(x) = b
    from x = 0, with guarded denominators and no convergence test: a fixed
    count keeps the host out of the loop."""
    x = torch.zeros_like(b)
    rr = b
    p = precond(b)
    rz = (rr * p).sum()
    tiny = torch.full_like(rz, 1e-20)
    for _ in range(iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp.abs() < 1e-20, tiny, pAp)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = precond(rr)
        rz_new = (rr * z).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-20, tiny, rz)
        p = z + beta * p
        rz = rz_new
    return x


class CGProblem(NamedTuple):
    """What stays fixed through a `bundle_adjustment_cg` solve: the
    observations, the gauge and the per-pose and per-point segment-sum
    index blocks (no pair block: the Schur products run observation-wise).
    Tensors only, so that one LM iteration is a function of tensors
    (`cg_lm_iteration`, captured per shape by `utils/graphs.py`)."""
    K: torch.Tensor  # (3, 3)
    obs_pose: torch.Tensor  # (O,) int64
    obs_point: torch.Tensor  # (O,) int64
    obs_uv: torch.Tensor  # (O, 2)
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor  # (O,) bool
    point_valid: torch.Tensor  # (M,) bool
    free6: torch.Tensor  # (P, 1) bool: the poses that move
    by_pose: torch.Tensor  # SegmentSum index blocks: per pose, per point
    by_point: torch.Tensor
    eye3: torch.Tensor  # the damping's identities
    eye6: torch.Tensor


class CGState(NamedTuple):
    """The carry of `bundle_adjustment_cg`'s LM loop."""
    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor


def cg_problem(K, obs_pose, obs_point, obs_uv, obs_inv_sigma2, obs_valid, fixed_pose,
               point_valid) -> CGProblem:
    """The `CGProblem` of P = len(fixed_pose) poses and M = len(point_valid)
    points (two host reads: the segment widths)."""
    op, oj = obs_pose.long(), obs_point.long()
    eye = torch.eye(6, dtype=obs_uv.dtype, device=obs_uv.device)
    return CGProblem(K, op, oj, obs_uv, obs_inv_sigma2, obs_valid, point_valid,
                     (~fixed_pose)[:, None], SegmentSum(op, fixed_pose.shape[0]).index,
                     SegmentSum(oj, point_valid.shape[0]).index, eye[:3, :3].contiguous(), eye)


def _cg_chi2(prob: CGProblem, Rp, tp, pts):
    op, oj = prob.obs_pose, prob.obs_point
    Xc = (Rp[op] @ pts[oj][..., None])[..., 0] + tp[op]
    r = prob.obs_uv - _project(prob.K, Xc)
    s = prob.obs_inv_sigma2 * (r * r).sum(-1)
    return torch.where(Xc[..., 2] <= 1e-6, torch.full_like(s, 1e6), s), r, Xc


def _cg_cost(prob: CGProblem, Rp, tp, pts, robust: bool, delta: float, allsum):
    s, _, _ = _cg_chi2(prob, Rp, tp, pts)
    c = huber_cost(s, delta) if robust else s
    return allsum(torch.where(prob.obs_valid, c, torch.zeros_like(c)).sum())


def _cg_iteration(state: CGState, prob: CGProblem, robust: bool, delta: float, cg_iters: int,
                  allsum) -> CGState:
    """One LM iteration of `bundle_adjustment_cg`, its `cg_iters` PCG
    iterations included."""
    Rp, tp, pts, lam, cost = state
    op, oj, free6, eye3, eye6 = prob.obs_pose, prob.obs_point, prob.free6, prob.eye3, prob.eye6

    def by_pose(v):
        return allsum(segment_sum(prob.by_pose, v))

    def by_point(v):
        return allsum(segment_sum(prob.by_point, v))

    s, r, Xc = _cg_chi2(prob, Rp, tp, pts)
    w = prob.obs_inv_sigma2 * (huber_weight(s, delta) if robust else 1.0)
    w = torch.where(prob.obs_valid & (Xc[..., 2] > 1e-6), w, torch.zeros_like(w))
    Jp = _proj_jacobian(prob.K, Xc)  # (O, 2, 3)
    A = _pose_jacobian(Jp, Xc)  # (O, 2, 6)
    B = -(Jp @ Rp[op])  # (O, 2, 3)
    wA = w[:, None, None] * A
    wB = w[:, None, None] * B
    Hpp = by_pose(torch.einsum("oik,oil->okl", wA, A))
    Hll = by_point(torch.einsum("oik,oil->okl", wB, B))
    bp = by_pose(-torch.einsum("oik,oi->ok", wA, r))
    bl = by_point(-torch.einsum("oik,oi->ok", wB, r))
    Hll_d = Hll + lam * (Hll * eye3) + 1e-6 * eye3
    Hpp_d = Hpp + lam * (Hpp * eye6) + 1e-6 * eye6
    Hll_inv = torch.where(prob.point_valid[:, None, None], _inv3x3(Hll_d),
                          torch.zeros_like(Hll_d))

    def WT_v(v):  # (P, 6) -> (M, 3): sum_o B^T w A v[p_o]
        u = torch.einsum("oik,ok->oi", wA, v[op])  # (O, 2)
        return by_point(torch.einsum("oik,oi->ok", B, u))

    def W_x(x):  # (M, 3) -> (P, 6)
        u = torch.einsum("oik,ok->oi", wB, x[oj])
        return by_pose(torch.einsum("oik,oi->ok", A, u))

    def S_v(v):  # implicit Schur matvec; fixed poses pinned to identity
        v0 = torch.where(free6, v, torch.zeros_like(v))
        out = torch.einsum("pij,pj->pi", Hpp_d, v0) - W_x(
            torch.einsum("mij,mj->mi", Hll_inv, WT_v(v0)))
        return torch.where(free6, out, v)

    def precond(x):  # block-Jacobi: a 6x6 solve per pose
        return torch.where(free6, _solve6_spd(Hpp_d, x), x)

    rhs = bp - W_x(torch.einsum("mij,mj->mi", Hll_inv, bl))
    rhs = torch.where(free6, rhs, torch.zeros_like(rhs))
    dp = pcg(S_v, precond, rhs, cg_iters)
    dp = torch.where(free6, dp, torch.zeros_like(dp))
    dl = torch.einsum("mij,mj->mi", Hll_inv, bl - WT_v(dp))
    dl = torch.where(prob.point_valid[:, None], dl, torch.zeros_like(dl))

    dRp, dtp = lie.se3_exp(dp)
    R_new = lie.so3_project(dRp @ Rp)
    t_new = (dRp @ tp[..., None])[..., 0] + dtp
    pts_new = pts + dl
    new_cost = _cg_cost(prob, R_new, t_new, pts_new, robust, delta, allsum)
    accept = new_cost < cost
    return CGState(R=torch.where(accept, R_new, Rp), t=torch.where(accept, t_new, tp),
                   points=torch.where(accept, pts_new, pts),
                   lam=torch.where(accept, (lam * 0.33).clamp_min(1e-7), (lam * 5.0).clamp_max(1e6)),
                   cost=torch.where(accept, new_cost, cost))


CG_ITERS = 50  # PCG iterations of an LM iteration of the global and the local BA


def cg_lm_iteration(state: CGState, prob: CGProblem) -> CGState:
    """One LM iteration of the single-process, Huber-robust
    `bundle_adjustment_cg` with `CG_ITERS` PCG iterations (tensors in and
    out: the function `LoopClosing` and `LocalMapping` capture per shape)."""
    return _cg_iteration(state, prob, True, math.sqrt(CHI2_MONO), CG_ITERS, group_sum(None))


def bundle_adjustment_cg(K, R, t, points, obs_pose, obs_point, obs_uv, obs_inv_sigma2,
                         obs_valid, fixed_pose, point_valid, iters: int = 20,
                         cg_iters: int = CG_ITERS, chi2_th: float = CHI2_MONO,
                         robust: bool = True, group=None, step=None) -> BAResult:
    """Bundle adjustment at any map size: LM with the point block eliminated
    implicitly. `bundle_adjustment` materializes the (M, P, 6, 3) pose-point
    cross tensor, which suits local windows and is O(M P) memory for global
    maps. Here every Schur product S v runs observation-wise (two gathers
    and two segment sums over the O axis) and the reduced pose system is
    solved by block-Jacobi preconditioned CG: memory O(P + M + O). Stands in
    for the reference's BundleAdjustment at global scale, which relies on
    Ceres' sparse Schur.

    A fixed `iters` x `cg_iters` loop with accept/reject as `torch.where`
    masks: no host read inside the solve. The per-pose and per-point sums use
    `SegmentSum` index blocks built once per call (`cg_problem`), so two
    calls give the same bits.

    With a torch.distributed `group` (the JAX package's `axis_name`), each
    rank holds a block of the observations: every O-axis sum (the cost;
    Hpp, Hll, bp, bl; the Schur matvec halves) is this rank's segment sum
    followed by an all_reduce over the group, and poses and points stay
    replicated (parallel/sharded_ba.bundle_adjustment_cg_sharded).

    `step(state, problem)` runs one LM iteration (by default `_cg_iteration`
    of `robust`, `chi2_th`, `cg_iters` and the group's sum; `LoopClosing`
    and `LocalMapping` pass a captured `cg_lm_iteration` without a group)."""
    delta = math.sqrt(chi2_th)
    allsum = group_sum(group)
    prob = cg_problem(K, obs_pose, obs_point, obs_uv, obs_inv_sigma2, obs_valid, fixed_pose,
                      point_valid)
    step = step or partial(_cg_iteration, robust=robust, delta=delta, cg_iters=cg_iters,
                           allsum=allsum)
    state = CGState(R, t, points, torch.tensor(1e-4, dtype=R.dtype, device=R.device),
                    _cg_cost(prob, R, t, points, robust, delta, allsum))
    for _ in range(iters):
        state = step(state, prob)
    R2 = lie.so3_project(state.R)
    s_final, _, Xc2 = _cg_chi2(prob, R2, state.t, state.points)
    inlier_obs = obs_valid & (s_final <= chi2_th) & (Xc2[..., 2] > 1e-6)
    return BAResult(R=R2, t=state.t, points=state.points, inlier_obs=inlier_obs, cost=state.cost)
