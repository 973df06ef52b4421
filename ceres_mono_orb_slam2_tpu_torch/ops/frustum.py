"""Batched frustum visibility + scale prediction for map points.

Port of `ceres_mono_orb_slam2_tpu/ops/frustum.py` (Frame::isInFrustum and
MapPoint::PredictScale over the whole local map at once).
"""

from __future__ import annotations

import torch

from ceres_mono_orb_slam2_tpu_torch.ops import lie


def frustum_and_scale(Rcw, tcw, K, bounds, pos, normal, min_dist, max_dist, valid,
                      log_scale: float, n_levels: int):
    """Rcw (..., 3,3), tcw (..., 3), K (3,3), bounds (4,) [min_x, max_x, min_y,
    max_y], pos/normal (..., M,3), min/max_dist (..., M), valid (..., M); the
    leading axes (none, or one entry per stream) are shared.
    Returns (uv (..., M,2), level (..., M) int64, viewcos (..., M), visible (..., M))."""
    Rwc = Rcw.transpose(-1, -2)
    Xc = pos @ Rwc + tcw[..., None, :]
    z = Xc[..., 2]
    zok = z > 0.0
    zs = torch.where(zok, z, torch.ones_like(z))
    u = K[0, 0] * Xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / zs + K[1, 2]
    in_img = (u >= bounds[0]) & (u < bounds[1]) & (v >= bounds[2]) & (v < bounds[3])

    Oc = lie.matvec(-Rwc, tcw)
    PO = pos - Oc[..., None, :]
    dist = torch.linalg.norm(PO, dim=-1)
    # [0.8 * min, 1.2 * max] slack of the reference's scale-invariance check
    dist_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)
    viewcos = (PO * normal).sum(-1) / dist.clamp_min(1e-9)
    view_ok = viewcos > 0.5
    ratio = max_dist.clamp_min(1e-9) / dist.clamp_min(1e-9)
    level = torch.ceil(torch.log(ratio) / log_scale).to(torch.int64).clamp(0, n_levels - 1)
    visible = valid & zok & in_img & dist_ok & view_ok
    return torch.stack([u, v], dim=-1), level, viewcos, visible
