"""ORB descriptor matching as dense masked Hamming-distance matrices.

Port of `ceres_mono_orb_slam2_tpu/ops/matcher.py`. Descriptors unpack to
{-1, +1} bit vectors and the Hamming distance of every pair is one float32
matrix product, h = (256 - a.b) / 2: exact, since +-1 products and sums of at
most 256 of them are exact in f32 (TF32 is off, see the package __init__).
Spatial windows, level windows, epipolar gates and viewing-angle radii are
boolean masks over that matrix.

Reference constants: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 rotation bins,
the ratio tests of each entry point, the chi2 epipolar gate 3.84*sigma2, the
viewing-cos radius 2.5/4.0.
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 20


def unpack_bits_pm1(desc_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) {-1, +1}, little-endian bit order."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc_u8.shape[:-1] + (256,))
    return bits.to(dtype) * 2 - 1


def unpack_u8(desc, device=None) -> torch.Tensor:
    """(..., 32) uint8 (numpy or tensor) -> (..., 256) {-1, +1} float32."""
    return unpack_bits_pm1(torch.as_tensor(desc, device=device))


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(..., Na, 256) x (..., Nb, 256) {-1, +1} -> (..., Na, Nb) int32."""
    dot = bits_a.float() @ bits_b.float().transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)


_POPCOUNT = {}


def hamming_pairwise(desc_a_u8: torch.Tensor, desc_b_u8: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance of aligned packed descriptors,
    (..., 32) uint8 -> (...,) int32: a 256-entry population-count table
    indexed by a ^ b (PyTorch has no population-count op), exact."""
    dev = desc_a_u8.device
    table = _POPCOUNT.get(dev)
    if table is None:
        byte = torch.arange(256, device=dev)
        table = sum((byte >> i) & 1 for i in range(8)).to(torch.int32)
        _POPCOUNT[dev] = table
    return table[torch.bitwise_xor(desc_a_u8, desc_b_u8).long()].sum(-1, dtype=torch.int32)


def masked_top2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second best over the target axis; argmin returns the
    first minimal index. dist (..., Q, T) int32, mask (..., Q, T) bool."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = d.argmin(-1)
    best_val = torch.gather(d, -1, best_idx[..., None])[..., 0]
    d2 = d.scatter(-1, best_idx[..., None], BIG)
    second_idx = d2.argmin(-1)
    second_val = torch.gather(d2, -1, second_idx[..., None])[..., 0]
    return best_val, best_idx, second_val, second_idx


def resolve_duplicate_targets(best_idx, best_val, valid, n_targets: int):
    """Keep, for every target claimed by several queries, only the query with
    the smallest distance, lowest query index on ties. Returns the filtered
    `valid` mask. All of (..., Q); every leading index is its own problem
    with its own `n_targets` targets."""
    lead = best_idx.shape[:-1]
    key = torch.where(valid, best_val, torch.full_like(best_val, BIG))
    per_target = torch.full(lead + (n_targets,), BIG, dtype=key.dtype, device=key.device)
    per_target = per_target.scatter_reduce(-1, best_idx, key, "amin")
    attains = valid & (key == per_target.gather(-1, best_idx))
    qidx = torch.arange(best_idx.shape[-1], device=best_idx.device).expand(best_idx.shape)
    first_q = torch.full(lead + (n_targets,), 1 << 30, dtype=qidx.dtype, device=qidx.device)
    first_q = first_q.scatter_reduce(
        -1, best_idx, torch.where(attains, qidx, torch.full_like(qidx, 1 << 30)), "amin")
    return attains & (first_q.gather(-1, best_idx) == qidx)


def rotation_consistency_mask(angle_q, angle_t_matched, valid):
    """Keep matches whose rotation offset falls in the 3 most popular of 30
    bins (ComputeThreeMaxima + HISTO_LENGTH filter). Angles in radians, all
    arguments (..., Q) with one histogram per leading index.

    As in the reference: `top_k(counts, 3)` values, 2nd/3rd dropped below 0.1x
    the best, and bin selection by count equality (which can alias bins tied
    with a kept one)."""
    rot = (angle_q - angle_t_matched) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    factor = HISTO_LENGTH / 360.0
    bins = torch.round(rot * factor).to(torch.int64)
    bins = torch.where(bins == HISTO_LENGTH, torch.zeros_like(bins), bins)
    bins = bins.clamp(0, HISTO_LENGTH - 1)
    counts = torch.zeros(bins.shape[:-1] + (HISTO_LENGTH,), dtype=torch.int32, device=bins.device)
    counts = counts.scatter_add(-1, bins, valid.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    keep1 = top3[..., 0:1]
    max1 = keep1.float()
    neg = torch.full_like(keep1, -1)
    keep2 = torch.where(top3[..., 1:2].float() > 0.1 * max1, top3[..., 1:2], neg)
    keep3 = torch.where(top3[..., 2:3].float() > 0.1 * max1, top3[..., 2:3], neg)
    c = counts.gather(-1, bins)
    bin_ok = (c == keep1) | (c == keep2) | (c == keep3)
    return valid & bin_ok & (c > 0)


def radius_by_viewing_cos(view_cos):
    """RadiusByViewingCos: 2.5 near-frontal, else 4.0."""
    return torch.where(view_cos > 0.998, 2.5, 4.0)


def _window(pr_uv, kp_xy, r):
    """|du|, |dv| and the box test of queries pr_uv (..., Q, 2) with radii r
    (..., Q) against targets kp_xy (..., T, 2): each (..., Q, T)."""
    du = (pr_uv[..., 0:1] - kp_xy[..., None, :, 0]).abs()
    dv = (pr_uv[..., 1:2] - kp_xy[..., None, :, 1]).abs()
    return du, dv, (du <= r[..., None]) & (dv <= r[..., None])


# --------------------------------------------------------------------------
# Search entry points: SoA tensors + validity masks in, (match_idx,
# match_dist, match_valid) per query row out.
# --------------------------------------------------------------------------


def search_by_projection_points(kp_xy, kp_octave, kp_bits, kp_valid, kp_free,
                                pr_uv, pr_level, pr_viewcos, pr_bits, pr_valid,
                                scale_factors, th: float = 1.0, ratio: float = 0.8):
    """TrackLocalMap search (SearchByProjection overload #1): each candidate
    local map point to the best frame keypoint in a viewing-cos radius and
    level window [l-1, l]; the ratio test applies only on equal levels.
    Keypoint arguments are (..., N, ...) and point arguments (..., M, ...)
    with the same leading axes (none, or one entry per stream); `th` is a
    number or a (..., 1) tensor. `search_by_projection_points_local`, then
    `resolve_duplicate_targets` over all the points."""
    best_idx, best_val, valid = search_by_projection_points_local(
        kp_xy, kp_octave, kp_bits, kp_valid, kp_free, pr_uv, pr_level, pr_viewcos, pr_bits,
        pr_valid, scale_factors, th, ratio)
    valid = resolve_duplicate_targets(best_idx, best_val, valid, kp_xy.shape[-2])
    return best_idx, best_val, valid


def search_by_projection_points_local(kp_xy, kp_octave, kp_bits, kp_valid, kp_free,
                                      pr_uv, pr_level, pr_viewcos, pr_bits, pr_valid,
                                      scale_factors, th: float = 1.0, ratio: float = 0.8):
    """The part of `search_by_projection_points` that looks at each map point
    alone: its best keypoint, distance and ratio test, before duplicate
    keypoints are resolved. Each point's row depends on no other point, so
    a block of the points gives the rows of the whole for that block."""
    r = radius_by_viewing_cos(pr_viewcos) * th * scale_factors[pr_level]
    _, _, in_window = _window(pr_uv, kp_xy, r)
    kp_oct, lvl = kp_octave[..., None, :], pr_level[..., None]
    lvl_ok = (kp_oct >= lvl - 1) & (kp_oct <= lvl)
    mask = (in_window & lvl_ok & kp_valid[..., None, :] & kp_free[..., None, :]
            & pr_valid[..., None])
    dist = hamming_matrix(pr_bits, kp_bits)
    best_val, best_idx, second_val, second_idx = masked_top2(dist, mask)
    ratio_ok = (kp_octave.gather(-1, best_idx) != kp_octave.gather(-1, second_idx)) | (
        best_val.float() <= ratio * second_val.float())
    valid = pr_valid & (best_val <= TH_HIGH) & ratio_ok
    return best_idx, best_val, valid


def search_by_projection_frame(kp_xy, kp_octave, kp_angle, kp_bits, kp_valid,
                               pr_uv, pr_octave, pr_angle, pr_bits, pr_valid,
                               scale_factors, th: float, check_rotation: bool = True,
                               dist_th: int = TH_HIGH):
    """Motion-model projection search: projected points (queries) against
    current keypoints (targets) in a th*scale window, level window [l-1,
    l+1], then the rotation-consistency filter."""
    r = th * scale_factors[pr_octave]
    _, _, in_window = _window(pr_uv, kp_xy, r)
    lvl_ok = (kp_octave[None, :] >= pr_octave[:, None] - 1) & (kp_octave[None, :] <= pr_octave[:, None] + 1)
    mask = in_window & lvl_ok & kp_valid[None, :] & pr_valid[:, None]
    dist = hamming_matrix(pr_bits, kp_bits)
    best_val, best_idx, _, _ = masked_top2(dist, mask)
    valid = pr_valid & (best_val <= dist_th)
    if check_rotation:
        valid = rotation_consistency_mask(pr_angle, kp_angle[best_idx], valid)
    valid = resolve_duplicate_targets(best_idx, best_val, valid, kp_xy.shape[0])
    return best_idx, best_val, valid


def search_for_initialization(xy1, angle1, bits1, valid1, octave1,
                              xy2, angle2, bits2, valid2, octave2,
                              window: float = 100.0, ratio: float = 0.9,
                              check_rotation: bool = True):
    """Two-view bootstrap matching: level-0 keypoints, +-window box, TH_LOW +
    0.9 ratio + rotation filter."""
    du = (xy1[:, 0:1] - xy2[None, :, 0]).abs()
    dv = (xy1[:, 1:2] - xy2[None, :, 1]).abs()
    mask = ((du <= window) & (dv <= window) & (octave1[:, None] == 0)
            & (octave2[None, :] == 0) & valid1[:, None] & valid2[None, :])
    dist = hamming_matrix(bits1, bits2)
    best_val, best_idx, second_val, _ = masked_top2(dist, mask)
    valid = (valid1 & (octave1 == 0) & (best_val <= TH_LOW)
             & (best_val.float() < ratio * second_val.float()))
    if check_rotation:
        valid = rotation_consistency_mask(angle1, angle2[best_idx], valid)
    valid = resolve_duplicate_targets(best_idx, best_val, valid, xy2.shape[0])
    return best_idx, best_val, valid


def search_by_descriptor(angle_q, bits_q, valid_q, angle_t, bits_t, valid_t,
                         ratio: float = 0.7, check_rotation: bool = True,
                         dist_th: int = TH_LOW):
    """Brute-force descriptor association (the SearchByBoW gates: TH_LOW +
    0.7 ratio + rotation filter) over the full Q x T distance matrix."""
    mask = valid_q[:, None] & valid_t[None, :]
    dist = hamming_matrix(bits_q, bits_t)
    best_val, best_idx, second_val, _ = masked_top2(dist, mask)
    valid = valid_q & (best_val <= dist_th) & (best_val.float() < ratio * second_val.float())
    if check_rotation:
        valid = rotation_consistency_mask(angle_q, angle_t[best_idx], valid)
    valid = resolve_duplicate_targets(best_idx, best_val, valid, bits_t.shape[0])
    return best_idx, best_val, valid


def search_for_triangulation(xy1, octave1, angle1, bits1, valid1,
                             xy2, octave2, angle2, bits2, valid2,
                             F12, epipole2, level_sigma2, scale_factors,
                             check_rotation: bool = True):
    """Epipolar search for new map points: unassociated keypoints of two
    keyframes under the gate dist^2 < 3.84*sigma2(octave2), an
    epipole-proximity rejection, and a mutual best-match cross-check (the
    stand-in for the reference's shared-vocabulary-node pruning).

    Keyframe 2's arguments, F12 (..., 3, 3) and epipole2 (..., 2) may carry
    leading axes (none, or one entry per neighbour keyframe), against which
    keyframe 1's (N1, ...) broadcast; the results carry them too."""
    mask = valid1[..., :, None] & valid2[..., None, :]
    x1h = torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)
    l2 = x1h @ F12  # (..., N1, 3) epipolar lines [a, b, c] in image 2
    num = (l2[..., 0:1] * xy2[..., None, :, 0] + l2[..., 1:2] * xy2[..., None, :, 1]
           + l2[..., 2:3])
    den = l2[..., 0:1] ** 2 + l2[..., 1:2] ** 2
    dsqr = num * num / den.clamp_min(1e-12)
    epi_ok = dsqr < 3.84 * level_sigma2[octave2][..., None, :]
    de = ((xy2 - epipole2[..., None, :]) ** 2).sum(-1)
    far_from_epipole = de >= 100.0 * scale_factors[octave2] ** 2
    mask = mask & epi_ok & far_from_epipole[..., None, :]

    dist = hamming_matrix(bits1, bits2)
    best_val, best_idx, _, _ = masked_top2(dist, mask)
    d2 = torch.where(mask, dist, torch.full_like(dist, BIG))
    col_best = d2.argmin(-2)  # best row of each column
    mutual = col_best.gather(-1, best_idx) == torch.arange(best_idx.shape[-1], device=best_idx.device)
    valid = valid1 & (best_val <= TH_LOW) & mutual
    if check_rotation:
        valid = rotation_consistency_mask(angle1, angle2.gather(-1, best_idx), valid)
    valid = resolve_duplicate_targets(best_idx, best_val, valid, xy2.shape[-2])
    return best_idx, best_val, valid


def search_fuse(kp_xy, kp_octave, kp_bits, kp_valid, pr_uv, pr_level, pr_bits,
                pr_valid, scale_factors, th: float = 3.0, dist_th: int = TH_LOW,
                inv_level_sigma2=None):
    """Fuse projection search: map points projected into a keyframe, radius
    th*scale(predicted level), level window [l-1, l], best descriptor under
    dist_th; `inv_level_sigma2` enables the 5.99 chi2 gate of Fuse overload 1.
    Keypoint arguments (..., N, ...) and projections (..., M, ...) may carry
    leading axes (none, or one entry per target keyframe), against which the
    points' descriptors pr_bits (M, 256) broadcast."""
    r = th * scale_factors[pr_level]
    du, dv, in_window = _window(pr_uv, kp_xy, r)
    kp_oct, lvl = kp_octave[..., None, :], pr_level[..., None]
    lvl_ok = (kp_oct >= lvl - 1) & (kp_oct <= lvl)
    mask = in_window & lvl_ok & kp_valid[..., None, :] & pr_valid[..., None]
    if inv_level_sigma2 is not None:
        e2 = du * du + dv * dv
        mask = mask & (e2 * inv_level_sigma2[kp_octave][..., None, :] <= 5.99)
    dist = hamming_matrix(pr_bits, kp_bits)
    best_val, best_idx, _, _ = masked_top2(dist, mask)
    valid = pr_valid & (best_val <= dist_th)
    return best_idx, best_val, valid
