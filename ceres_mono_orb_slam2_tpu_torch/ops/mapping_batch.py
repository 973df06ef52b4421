"""Whole-neighbourhood device stages of LocalMapping.

Port of `ceres_mono_orb_slam2_tpu/ops/mapping_batch.py`: triangulation of the
current keyframe against its covisible neighbours (CreateNewMapPoints) and
the forward fuse of one map-point block into several target keyframes
(SearchInNeighbors / ORBmatcher::Fuse). Inputs are stacked along a leading
neighbour/target axis B, as in the JAX package, and the ops take that axis
natively where the JAX package vmaps; the TPU-only packed int32
uploads (`pack_tri_host` / `pack_fuse_host`) are not carried over, since the
keyframe payloads already live on the device.
"""

from __future__ import annotations

import torch

from ceres_mono_orb_slam2_tpu_torch.ops import lie, matcher, twoview
from ceres_mono_orb_slam2_tpu_torch.ops.frustum import frustum_and_scale


def _partners(xy2, idx):
    """Each slot's matched keypoint of its neighbour: xy2 (B, N, 2) at idx (B, N)."""
    return xy2.gather(-2, idx[..., None].expand(idx.shape + (2,)))


def triangulation_search(K, invK, R1, t1, xy1, oct1, ang1, desc1, free1,
                         R2, t2, xy2, oct2, ang2, desc2, free2, level_sigma2, scale_factors):
    """The first half of `triangulate_with_neighbors`, up to the eigensolver:
    the epipolar search against all B neighbours at once (the JAX package's
    vmap), and each slot's DLT normal matrix against its matched partner.
    Returns (idx (B, N), valid (B, N), AtA (B, N, 4, 4))."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    B, N = xy2.shape[0], xy1.shape[0]
    O1 = -R1.T @ t1
    P1 = torch.cat([R1, t1[:, None]], 1)
    # F12 = K^-T [t12]x R12 K^-1 per neighbour
    R12 = R1 @ R2.transpose(-1, -2)
    t12 = -lie.matvec(R12, t2) + t1
    F12 = invK.T @ lie.hat(t12) @ R12 @ invK
    C2 = lie.matvec(R2, O1) + t2  # camera 1 centre in each camera 2
    zc = torch.where(C2[:, 2].abs() < 1e-9, torch.full_like(C2[:, 2], 1e-9), C2[:, 2])
    ep2 = torch.stack([fx * C2[:, 0] / zc + cx, fy * C2[:, 1] / zc + cy], -1)

    idx, _, valid = matcher.search_for_triangulation(
        xy1, oct1, ang1, matcher.unpack_bits_pm1(desc1), free1,
        xy2, oct2, ang2, matcher.unpack_bits_pm1(desc2), free2,
        F12, ep2, level_sigma2, scale_factors)

    # triangulate every slot against its matched partner (normalised coords)
    P2 = torch.cat([R2, t2[:, :, None]], -1)
    AtA = twoview.dlt_normal_matrix(P1.expand(B, N, 3, 4), P2[:, None].expand(B, N, 3, 4),
                                    twoview.k_normalised(K, xy1).expand(B, N, 2),
                                    twoview.k_normalised(K, _partners(xy2, idx)))
    return idx, valid, AtA


def triangulation_gates(x, idx, valid, K, R1, t1, xy1, oct1, R2, t2, xy2, oct2,
                        level_sigma2, scale_factors, ratio_factor: float):
    """The second half of `triangulate_with_neighbors`: the points from the
    DLT eigenvectors x (B, N, 4) and the acceptance gates (parallax,
    positive depth, reprojection, scale). Returns (good (B, N), X (B, N, 3)
    world points)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    X = twoview.dlt_point(x)
    xn1 = twoview.k_normalised(K, xy1)
    uv2 = _partners(xy2, idx)
    xn2 = twoview.k_normalised(K, uv2)
    R2T = R2.transpose(-1, -2)
    ray1 = torch.cat([xn1, torch.ones_like(xn1[:, :1])], -1) @ R1
    ray2 = torch.cat([xn2, torch.ones_like(xn2[..., :1])], -1) @ R2
    cos_par = (ray1 * ray2).sum(-1) / (
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1)).clamp_min(1e-12)
    good = valid & (cos_par > 0) & (cos_par < 0.9998)
    good &= ((X @ R1.T + t1)[..., 2] > 0) & ((X @ R2T + t2[:, None])[..., 2] > 0)

    def chi2(RT, t, uv, sigma2):
        Xc = X @ RT + t
        zs = Xc[..., 2].clamp_min(1e-9)
        u = fx * Xc[..., 0] / zs + cx
        v = fy * Xc[..., 1] / zs + cy
        return ((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2) / sigma2

    oct2m = oct2.gather(-1, idx)
    good &= chi2(R1.T, t1, xy1, level_sigma2[oct1]) <= 5.991
    good &= chi2(R2T, t2[:, None], uv2, level_sigma2[oct2m]) <= 5.991
    O1 = -R1.T @ t1
    O2 = -lie.matvec(R2T, t2)
    d1 = torch.linalg.norm(X - O1, dim=-1)
    d2 = torch.linalg.norm(X - O2[:, None], dim=-1)
    rd = d2 / d1.clamp_min(1e-12)
    ro = scale_factors[oct1] / scale_factors[oct2m]
    good &= (rd * ratio_factor > ro) & (rd < ro * ratio_factor)
    good &= (d1 > 1e-9) & (d2 > 1e-9)
    return good, X


def triangulate_with_neighbors(K, invK, R1, t1, xy1, oct1, ang1, desc1, free1,
                               R2, t2, xy2, oct2, ang2, desc2, free2,
                               level_sigma2, scale_factors, ratio_factor: float):
    """Epipolar search + triangulation + acceptance gates of the current
    keyframe (xy1 ... free1: (N, ...); free = unassociated and valid)
    against B neighbours (R2 (B,3,3), t2 (B,3), xy2 ... free2: (B, N, ...)),
    with the neighbour axis native (no loop over neighbours).
    Returns per-neighbour (idx (B,N), good (B,N), X (B,N,3) world points).

    `triangulation_search`, the batched 4x4 eigensolver
    (`twoview.smallest_eigvecs`, in chunks the card's solver takes) and
    `triangulation_gates`, in that order."""
    idx, valid, AtA = triangulation_search(K, invK, R1, t1, xy1, oct1, ang1, desc1, free1, R2, t2,
                                           xy2, oct2, ang2, desc2, free2, level_sigma2,
                                           scale_factors)
    good, X = triangulation_gates(twoview.smallest_eigvecs(AtA), idx, valid, K, R1, t1, xy1, oct1, R2, t2,
                                  xy2, oct2, level_sigma2, scale_factors, ratio_factor)
    return idx, good, X


def fuse_into_targets(K, R, t, kp_xy, kp_oct, kp_desc, kp_valid, pos, normal, mind, maxd,
                      desc, mvalid, log_scale: float, n_levels: int, scale_factors,
                      inv_level_sigma2, bounds=None, th: float = 3.0):
    """Project one map-point block (pos ... desc: (M, ...)) into B target
    keyframes (R (B,3,3), t (B,3), kp_*: (B, N, ...)) and run the fuse
    search in each, with the target axis native (no loop over targets).
    mvalid (B, M): the point exists and the target does not observe it yet.
    `bounds` is the undistorted image box of the IsInImage gate (None
    disables it). Returns (idx (B,M), valid (B,M)). The reverse fuse into
    the current keyframe is the B = 1 call."""
    if bounds is None:
        bounds = torch.tensor([-1e6, 1e6, -1e6, 1e6], dtype=torch.float32, device=pos.device)
    uv, level, _, visible = frustum_and_scale(R, t, K, bounds, pos, normal, mind, maxd, mvalid,
                                              log_scale, n_levels)
    idx, _, valid = matcher.search_fuse(
        kp_xy, kp_oct, matcher.unpack_bits_pm1(kp_desc), kp_valid, uv, level,
        matcher.unpack_bits_pm1(desc), visible, scale_factors, th=th,
        inv_level_sigma2=inv_level_sigma2)
    return idx, valid
