"""Whole-neighbourhood device stages of LocalMapping.

Port of `ceres_mono_orb_slam2_tpu/ops/mapping_batch.py`: triangulation of the
current keyframe against its covisible neighbours (CreateNewMapPoints) and
the forward fuse of one map-point block into several target keyframes
(SearchInNeighbors / ORBmatcher::Fuse). Inputs are stacked along a leading
neighbour/target axis B, as in the JAX package; the TPU-only packed int32
uploads (`pack_tri_host` / `pack_fuse_host`) are not carried over, since the
keyframe payloads already live on the device.
"""

from __future__ import annotations

import torch

from ceres_mono_orb_slam2_tpu_torch.ops import matcher, twoview
from ceres_mono_orb_slam2_tpu_torch.ops.frustum import frustum_and_scale


def _skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _triangulate_pair(K, invK, R1, t1, O1, P1, xy1, xn1, oct1, ang1, bits1, free1,
                      sigma2_1, sf1, R2b, t2b, xy2b, oct2b, ang2b, desc2b, free2b,
                      level_sigma2, scale_factors, ratio_factor):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # F12 = K^-T [t12]x R12 K^-1
    R12 = R1 @ R2b.T
    t12 = -R12 @ t2b + t1
    F12 = invK.T @ _skew(t12) @ R12 @ invK
    C2 = R2b @ O1 + t2b  # camera 1 centre in camera 2
    zc = torch.where(C2[2].abs() < 1e-9, torch.full_like(C2[2], 1e-9), C2[2])
    ep2 = torch.stack([fx * C2[0] / zc + cx, fy * C2[1] / zc + cy])

    idx, _, valid = matcher.search_for_triangulation(
        xy1, oct1, ang1, bits1, free1,
        xy2b, oct2b, ang2b, matcher.unpack_bits_pm1(desc2b), free2b,
        F12, ep2, level_sigma2, scale_factors)

    # triangulate every slot against its matched partner (normalised coords)
    uv2 = xy2b[idx]
    xn2 = torch.stack([(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], -1)
    P2 = torch.cat([R2b, t2b[:, None]], 1)
    N = xy1.shape[0]
    X = twoview.triangulate_dlt(P1.expand(N, 3, 4), P2.expand(N, 3, 4), xn1, xn2)

    # acceptance gates: parallax, positive depth, reprojection, scale
    ones = torch.ones_like(xn1[:, :1])
    ray1 = torch.cat([xn1, ones], -1) @ R1
    ray2 = torch.cat([xn2, ones], -1) @ R2b
    cos_par = (ray1 * ray2).sum(-1) / (
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1)).clamp_min(1e-12)
    good = valid & (cos_par > 0) & (cos_par < 0.9998)
    good &= ((X @ R1.T + t1)[:, 2] > 0) & ((X @ R2b.T + t2b)[:, 2] > 0)

    def chi2(R, t, uv, sigma2):
        Xc = X @ R.T + t
        zs = Xc[:, 2].clamp_min(1e-9)
        u = fx * Xc[:, 0] / zs + cx
        v = fy * Xc[:, 1] / zs + cy
        return ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / sigma2

    oct2m = oct2b[idx]
    good &= chi2(R1, t1, xy1, sigma2_1) <= 5.991
    good &= chi2(R2b, t2b, uv2, level_sigma2[oct2m]) <= 5.991
    O2b = -R2b.T @ t2b
    d1 = torch.linalg.norm(X - O1, dim=-1)
    d2 = torch.linalg.norm(X - O2b, dim=-1)
    rd = d2 / d1.clamp_min(1e-12)
    ro = sf1 / scale_factors[oct2m]
    good &= (rd * ratio_factor > ro) & (rd < ro * ratio_factor)
    good &= (d1 > 1e-9) & (d2 > 1e-9)
    return idx, good, X


def triangulate_with_neighbors(K, invK, R1, t1, xy1, oct1, ang1, desc1, free1,
                               R2, t2, xy2, oct2, ang2, desc2, free2,
                               level_sigma2, scale_factors, ratio_factor):
    """Epipolar search + triangulation + acceptance gates of the current
    keyframe (xy1 ... free1: (N, ...); free = unassociated and valid)
    against B neighbours (R2 (B,3,3), t2 (B,3), xy2 ... free2: (B, N, ...)).
    Returns per-neighbour (idx (B,N), good (B,N), X (B,N,3) world points)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    bits1 = matcher.unpack_bits_pm1(desc1)
    O1 = -R1.T @ t1
    P1 = torch.cat([R1, t1[:, None]], 1)
    xn1 = torch.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy], -1)
    sigma2_1 = level_sigma2[oct1]
    sf1 = scale_factors[oct1]
    outs = [_triangulate_pair(K, invK, R1, t1, O1, P1, xy1, xn1, oct1, ang1, bits1, free1,
                              sigma2_1, sf1, R2[b], t2[b], xy2[b], oct2[b], ang2[b],
                              desc2[b], free2[b], level_sigma2, scale_factors, ratio_factor)
            for b in range(R2.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def fuse_into_targets(K, R, t, kp_xy, kp_oct, kp_desc, kp_valid, pos, normal, mind, maxd,
                      desc, mvalid, log_scale: float, n_levels: int, scale_factors,
                      inv_level_sigma2, bounds=None, th: float = 3.0):
    """Project one map-point block (pos ... desc: (M, ...)) into B target
    keyframes (R (B,3,3), t (B,3), kp_*: (B, N, ...)) and run the fuse
    search in each. mvalid (B, M): the point exists and the target does not
    observe it yet. `bounds` is the undistorted image box of the
    IsInImage gate (None disables it). Returns (idx (B,M), valid (B,M))."""
    if bounds is None:
        bounds = torch.tensor([-1e6, 1e6, -1e6, 1e6], dtype=torch.float32, device=pos.device)
    pr_bits = matcher.unpack_bits_pm1(desc)
    idxs, valids = [], []
    for b in range(R.shape[0]):
        uv, level, _, visible = frustum_and_scale(R[b], t[b], K, bounds, pos, normal, mind,
                                                  maxd, mvalid[b], log_scale, n_levels)
        idx, _, valid = matcher.search_fuse(
            kp_xy[b], kp_oct[b], matcher.unpack_bits_pm1(kp_desc[b]), kp_valid[b],
            uv, level, pr_bits, visible, scale_factors, th=th,
            inv_level_sigma2=inv_level_sigma2)
        idxs.append(idx)
        valids.append(valid)
    return torch.stack(idxs), torch.stack(valids)
