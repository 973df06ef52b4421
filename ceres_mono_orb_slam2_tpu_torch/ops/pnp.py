"""Absolute-pose (PnP) RANSAC for relocalization.

Port of `ceres_mono_orb_slam2_tpu/ops/pnp.py`, the equivalent of the
reference PnPsolver (EPnP inside RANSAC, chi2 gate 5.991 * sigma2(octave)).
Hypotheses come from a minimal 3-point solver (P3P depths by Newton
iteration from four scale seeds, then Kabsch) or a 6-point DLT; all
hypotheses of all candidates are scored as one batch, and the best one is
re-fitted on its inliers by a weighted DLT. Callers polish the result with
`optim.pose_optimization`, as Tracking does.

The RANSAC draws are an argument: `noise` holds one uniform number per
(hypothesis, point), and a hypothesis' minimal set is the `min_set` largest
entries of its row among the valid points.

The solve is four device stages (`RansacStages`) around three
linear-algebra calls (the Kabsch SVD, the re-fit's eigensolver and its
SVD), whose CUDA versions read back to the host (`svd` copies into
pageable host memory, `eigh` checks its `info`) and so cannot run inside a
captured program: `Tracking` captures each stage (`utils/graphs.py`) and
calls the three between the replays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

P3P_SEEDS = (0.5, 1.0, 2.0, 4.0)
P3P_NEWTON_STEPS = 20
CHI2_TH = 5.991  # the reference's 2-dof gate, scaled by the octave's sigma2
MIN_INLIERS = 10
_seeds = {}  # (device, dtype) -> P3P_SEEDS as a tensor, made outside any capture


def _p3p_seeds(like: torch.Tensor) -> torch.Tensor:
    """P3P_SEEDS on `like`'s device, uploaded once (a capture cannot copy
    from pageable host memory)."""
    key = (like.device, like.dtype)
    if key not in _seeds:
        _seeds[key] = torch.tensor(P3P_SEEDS, dtype=like.dtype, device=like.device)
    return _seeds[key]


def _dlt_system(pts3d, uv_norm, weights, per_problem: bool = False):
    """The normal matrix A^T A (..., 12, 12) of the weighted DLT for
    P = [R|t] (`_dlt_pose` up to its eigensolver). `per_problem`: one
    product for each problem of the leading axes, not one batched product:
    cuBLAS picks its kernel by the batch count, so a batch of one and a
    padded batch would give a problem different bits."""
    X, Y, Z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    o = torch.ones_like(X)
    u, v = uv_norm[..., 0], uv_norm[..., 1]
    z = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1 * weights[..., None], r2 * weights[..., None]], dim=-2)  # (..., 2M, 12)
    if per_problem:
        return torch.stack([a.T @ a for a in A.reshape((-1,) + A.shape[-2:])]).reshape(
            A.shape[:-2] + (12, 12))
    return A.transpose(-1, -2) @ A


def _dlt_projection(vecs, pts3d, weights):
    """P (..., 3, 4) from the eigenvectors of `_dlt_system`'s matrix, its
    sign fixed by cheirality, and its left 3x3 block M."""
    p = vecs[..., :, 0]  # null vector, sign arbitrary: fixed by cheirality below
    P = p.reshape(p.shape[:-1] + (3, 4))
    M = P[..., :, :3]
    # sign: the majority of the used points must have positive depth
    zc = torch.einsum("...ij,...mj->...mi", M, pts3d)[..., 2] + P[..., 2, 3][..., None]
    pos = torch.where(weights > 0, torch.sign(zc), torch.zeros_like(zc)).sum(-1)
    P = P * torch.where(pos >= 0, 1.0, -1.0)[..., None, None]
    return P, P[..., :, :3]


def _dlt_from_svd(P, U, S, Vt):
    """R, t from P and the SVD of its block M: Procrustes, the nearest
    scaled rotation; scale = geometric mean of the singular values."""
    flip = torch.where(torch.linalg.det(U @ Vt) < 0, -1.0, 1.0)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * flip[..., None, None]], dim=-1)
    S = torch.cat([S[..., :2], S[..., 2:] * flip[..., None]], dim=-1)
    R = U @ Vt
    scale = torch.exp(torch.log(S.clamp_min(1e-12)).mean(-1))
    t = P[..., :, 3] / scale.clamp_min(1e-12)[..., None]
    return R, t


def _dlt_pose(pts3d, uv_norm, weights):
    """Weighted DLT for P = [R|t] from normalized image points.

    pts3d: (..., M, 3); uv_norm: (..., M, 2) K^-1-normalized observations;
    weights: (..., M) row weights (0 disables a correspondence).
    Returns R (..., 3, 3), t (..., 3) with cam = R @ X + t; sign fixed by
    cheirality, scale by Procrustes.
    """
    _, vecs = torch.linalg.eigh(_dlt_system(pts3d, uv_norm, weights))
    P, M = _dlt_projection(vecs, pts3d, weights)
    return _dlt_from_svd(P, *torch.linalg.svd(M))


def _p3p_system(pts3d, bearings, sets):
    """`_p3p_pose` up to its SVD: (H (..., S * NH, 3, 3) of each Kabsch
    alignment, the camera and world centroids muc, muw (..., S * NH, 3))."""
    lead = sets.shape[:-2]
    NH = sets.shape[-2]
    idx = sets.reshape(lead + (NH * 3, 1)).expand(lead + (NH * 3, 3))
    Xw = torch.gather(pts3d, -2, idx).reshape(lead + (NH, 3, 3))
    x = torch.gather(bearings, -2, idx).reshape(lead + (NH, 3, 3))
    c12 = (x[..., 0, :] * x[..., 1, :]).sum(-1)
    c13 = (x[..., 0, :] * x[..., 2, :]).sum(-1)
    c23 = (x[..., 1, :] * x[..., 2, :]).sum(-1)
    D12 = ((Xw[..., 0, :] - Xw[..., 1, :]) ** 2).sum(-1)
    D13 = ((Xw[..., 0, :] - Xw[..., 2, :]) ** 2).sum(-1)
    D23 = ((Xw[..., 1, :] - Xw[..., 2, :]) ** 2).sum(-1)
    scale0 = torch.sqrt((D12 + D13 + D23).clamp_min(1e-12) / 3.0)

    seeds = _p3p_seeds(pts3d)
    S = len(P3P_SEEDS)
    # (..., S, NH) depths, all three starting at seed * scale
    d0 = d1 = d2 = seeds[:, None] * scale0[..., None, :]
    c12, c13, c23, D12, D13, D23 = (a[..., None, :] for a in (c12, c13, c23, D12, D13, D23))
    zero = torch.zeros_like(d0)
    for _ in range(P3P_NEWTON_STEPS):
        f0 = d0 ** 2 + d1 ** 2 - 2 * d0 * d1 * c12 - D12
        f1 = d0 ** 2 + d2 ** 2 - 2 * d0 * d2 * c13 - D13
        f2 = d1 ** 2 + d2 ** 2 - 2 * d1 * d2 * c23 - D23
        a, b_, c_ = 2 * d0 - 2 * d1 * c12, 2 * d1 - 2 * d0 * c12, zero
        e, f_, g = 2 * d0 - 2 * d2 * c13, zero, 2 * d2 - 2 * d0 * c13
        h, i_, j_ = zero, 2 * d1 - 2 * d2 * c23, 2 * d2 - 2 * d1 * c23
        det = a * (f_ * j_ - g * i_) - b_ * (e * j_ - g * h) + c_ * (e * i_ - f_ * h)
        det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
        # Newton step through the adjugate inverse
        s0 = ((f_ * j_ - g * i_) * f0 + (c_ * i_ - b_ * j_) * f1 + (b_ * g - c_ * f_) * f2) / det
        s1 = ((g * h - e * j_) * f0 + (a * j_ - c_ * h) * f1 + (c_ * e - a * g) * f2) / det
        s2 = ((e * i_ - f_ * h) * f0 + (b_ * h - a * i_) * f1 + (a * f_ - b_ * e) * f2) / det
        d0 = (d0 - s0).clamp_min(1e-6)
        d1 = (d1 - s1).clamp_min(1e-6)
        d2 = (d2 - s2).clamp_min(1e-6)
    d_all = torch.stack([d0, d1, d2], dim=-1).reshape(lead + (S * NH, 3))
    rep = (1,) * len(lead) + (S, 1, 1)
    x_all = x.repeat(rep)
    Xw_all = Xw.repeat(rep)
    Pc = d_all[..., None] * x_all  # (..., S*NH, 3, 3) camera points
    # Kabsch: R, t minimizing |Pc - (R Xw + t)|
    muc = Pc.mean(-2)
    muw = Xw_all.mean(-2)
    H = torch.einsum("...mi,...mj->...ij", Pc - muc[..., None, :], Xw_all - muw[..., None, :])
    # a diverged Newton run leaves non-finite depths: its H is zeroed for the
    # SVD (which rejects non-finite input), and its t stays non-finite, so the
    # hypothesis scores no inlier
    H = torch.where(torch.isfinite(H).all(-1, keepdim=True).all(-2, keepdim=True),
                    H, torch.zeros_like(H))
    return H, muc, muw


def _kabsch_from_svd(U, Vt, muc, muw):
    """R, t of each Kabsch alignment from the SVD of its H."""
    flip = torch.where(torch.linalg.det(U @ Vt) < 0, -1.0, 1.0)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * flip[..., None, None]], dim=-1)
    R = U @ Vt
    t = muc - torch.einsum("...ij,...j->...i", R, muw)
    return R, t


def _p3p_pose(pts3d, bearings, sets):
    """Minimal 3-point absolute pose, batched over hypotheses.

    Solves the P3P depth system d_i^2 + d_j^2 - 2 d_i d_j cos_ij = D_ij^2 by
    Newton iteration (closed-form 3x3 solve per step) from several scale
    seeds that cover the root branches, then extracts (R, t) by Kabsch
    alignment of the back-projected camera points.

    pts3d: (..., N, 3); bearings: (..., N, 3) unit K^-1 rays; sets:
    (..., NH, 3) indices. Returns R (..., S * NH, 3, 3), t (..., S * NH, 3)
    for the S seeds, seed-major.
    """
    H, muc, muw = _p3p_system(pts3d, bearings, sets)
    U, _, Vt = torch.linalg.svd(H)
    return _kabsch_from_svd(U, Vt, muc, muw)


def _take(a, best):
    """a (..., H, *rest), best (...,) indices into H -> (..., *rest)."""
    nd = best.dim()
    idx = best.reshape(best.shape + (1,) * (a.dim() - nd)).expand(best.shape + (1,) + a.shape[nd + 1:])
    return torch.gather(a, nd, idx).squeeze(nd)


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # (..., N)
    n_inliers: torch.Tensor


class BestHypothesis(NamedTuple):
    """The best hypothesis of each problem and the normal matrix of its
    re-fit on its inliers (what the re-fit's eigensolver takes)."""
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    AtA: torch.Tensor


def _normalized(K, uv):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def _score(K, pts3d, uv, inv_sigma2, valid, R, t, chi2_th):
    """Inliers of R (..., H, 3, 3) or (..., 3, 3) against (..., N, 3):
    valid, in front of the camera and inside the octave's chi2 gate."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    hyp = R.dim() == pts3d.dim() + 1
    X = pts3d[..., None, :, :] if hyp else pts3d
    Xc = torch.einsum("...ij,...mj->...mi", R, X) + t[..., None, :]
    zok = Xc[..., 2] > 1e-6
    zs = torch.where(zok, Xc[..., 2], torch.ones_like(Xc[..., 2]))
    u = fx * Xc[..., 0] / zs + cx
    v = fy * Xc[..., 1] / zs + cy
    ou, ov, w_, ok = (a[..., None, :] if hyp else a
                      for a in (uv[..., 0], uv[..., 1], inv_sigma2, valid))
    chi2 = ((u - ou) ** 2 + (v - ov) ** 2) * w_
    return ok & zok & (chi2 <= chi2_th)


def _best_hypothesis(R, t, K, pts3d, uv, inv_sigma2, valid, chi2_th) -> BestHypothesis:
    inl = _score(K, pts3d, uv, inv_sigma2, valid, R, t, chi2_th)  # (..., H, N)
    counts = inl.sum(-1, dtype=torch.int32)
    best = counts.argmax(-1)  # the first maximum
    inl_b = _take(inl, best)
    # non-minimal re-fit on the best hypothesis' inliers (Refine())
    AtA = _dlt_system(pts3d, _normalized(K, uv), inl_b.to(K.dtype), per_problem=True)
    return BestHypothesis(_take(R, best), _take(t, best), inl_b, _take(counts, best), AtA)


def p3p_stage(noise, K, pts3d, uv, valid):
    """Stage 1, up to the Kabsch SVD: each hypothesis' minimal set (the 3
    largest draws of its row among the valid points) through
    `_p3p_system`, seed-expanded. Returns (H, muc, muw)."""
    noise = torch.where(valid[..., None, :], noise, torch.full_like(noise, -1.0))
    sets = torch.topk(noise, 3, dim=-1).indices  # (..., NH, 3)
    uvn = _normalized(K, uv)
    rays = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    return _p3p_system(pts3d, rays, sets)


def select_stage(U, Vt, muc, muw, K, pts3d, uv, inv_sigma2, valid,
                 chi2_th: float = CHI2_TH) -> BestHypothesis:
    """Stage 2, from the Kabsch SVD to the re-fit's eigensolver: every
    hypothesis scored, the best kept (the first maximum), and the normal
    matrix of the weighted DLT on its inliers."""
    R, t = _kabsch_from_svd(U, Vt, muc, muw)
    return _best_hypothesis(R, t, K, pts3d, uv, inv_sigma2, valid, chi2_th)


def projection_stage(vecs, pts3d, best: BestHypothesis):
    """Stage 3, between the re-fit's eigensolver and its SVD: P and M of
    the DLT on the best hypothesis' inliers (`_dlt_projection`)."""
    return _dlt_projection(vecs, pts3d, best.inliers.to(pts3d.dtype))


def refit_stage(U, S, Vt, P, K, pts3d, uv, inv_sigma2, valid, best: BestHypothesis,
                chi2_th: float = CHI2_TH, min_inliers: int = MIN_INLIERS) -> PnPResult:
    """Stage 4, after the re-fit's SVD: the re-fitted pose, kept where it
    scores at least the best hypothesis' inliers."""
    Rr, tr = _dlt_from_svd(P, U, S, Vt)
    inl_r = _score(K, pts3d, uv, inv_sigma2, valid, Rr, tr, chi2_th)
    # keep whichever is better (the re-fit can rarely degrade)
    better = inl_r.sum(-1, dtype=torch.int32) >= best.n_inliers
    R_out = torch.where(better[..., None, None], Rr, best.R)
    t_out = torch.where(better[..., None], tr, best.t)
    inl_out = torch.where(better[..., None], inl_r, best.inliers)
    n = inl_out.sum(-1, dtype=torch.int32)
    return PnPResult(success=n >= min_inliers, R=R_out, t=t_out, inliers=inl_out, n_inliers=n)


class RansacStages(NamedTuple):
    """The four device stages of the P3P `ransac_pnp` at the default gate
    and inlier minimum: the functions, or programs of them."""
    p3p: object = p3p_stage
    select: object = select_stage
    projection: object = projection_stage
    refit: object = refit_stage


def ransac_pnp(
    noise,  # (..., NH, N) uniform draws
    K,
    pts3d,  # (..., N, 3) world points
    uv,  # (..., N, 2) observed (undistorted) pixels
    inv_sigma2,  # (..., N) per-observation information (1 / sigma^2 of the octave)
    valid,  # (..., N)
    min_set: int = 6,
    chi2_th: float = CHI2_TH,
    min_inliers: int = MIN_INLIERS,
    solver: str = "p3p",
    stages: RansacStages = None,
) -> PnPResult:
    """Batched RANSAC absolute pose and a non-minimal re-fit on the inliers.

    The acceptance logic is the reference's (SetRansacParameters: chi2 5.991
    scaled by the octave's sigma2, a minimum inlier count) with all
    hypotheses evaluated at once. `solver="p3p"` draws 3-point minimal sets,
    `solver="dlt"` keeps 6-point DLT hypotheses. Leading dimensions batch
    independent problems (relocalization candidates).

    `stages` (default: the stage functions at `chi2_th` and `min_inliers`)
    run between the three linear-algebra calls; `Tracking` passes programs
    of them at the default gate.
    """
    stages = stages or RansacStages(select=partial(select_stage, chi2_th=chi2_th),
                                    refit=partial(refit_stage, chi2_th=chi2_th,
                                                  min_inliers=min_inliers))

    if solver == "p3p":
        H, muc, muw = stages.p3p(noise, K, pts3d, uv, valid)
        U, _, Vt = torch.linalg.svd(H)
        best = stages.select(U, Vt, muc, muw, K, pts3d, uv, inv_sigma2, valid)
    else:
        uvn = _normalized(K, uv)
        noise = torch.where(valid[..., None, :], noise, torch.full_like(noise, -1.0))
        sets = torch.topk(noise, min_set, dim=-1).indices  # (..., NH, m)
        w = torch.zeros_like(noise).scatter(-1, sets, 1.0)
        R, t = _dlt_pose(pts3d[..., None, :, :].expand(w.shape + (3,)),
                         uvn[..., None, :, :].expand(w.shape + (2,)), w)
        best = _best_hypothesis(R, t, K, pts3d, uv, inv_sigma2, valid, chi2_th)
    _, vecs = torch.linalg.eigh(best.AtA)
    P, M = stages.projection(vecs, pts3d, best)
    return PnPResult(*stages.refit(*torch.linalg.svd(M), P, K, pts3d, uv, inv_sigma2, valid, best))


def ransac_pnp_multi(noise, K, pts3d, uv, inv_sigma2, valid, **kw) -> PnPResult:
    """RANSAC over a batch of relocalization candidates at once: noise
    (C, NH, N), pts3d (C, N, 3), uv (C, N, 2), inv_sigma2 (C, N), valid
    (C, N). The reference interleaves `iterate(5)` RANSAC rounds across
    candidates so that none monopolizes the compute; here every candidate's
    full hypothesis set runs in one batched call and the caller ranks the
    candidates by inlier count. Every field of the result has a leading
    candidate axis."""
    return ransac_pnp(noise, K, pts3d, uv, inv_sigma2, valid, **kw)
