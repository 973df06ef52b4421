"""Pinhole camera model with OpenCV radial-tangential distortion.

Port of `ceres_mono_orb_slam2_tpu/ops/camera.py`. Batched over leading dims.
"""

from __future__ import annotations

import torch


def project(K: torch.Tensor, xyz: torch.Tensor):
    """Perspective projection of camera-frame points (undistorted, like the
    optimizer residuals). K: (3, 3); xyz: (..., 3) -> ((..., 2) px, (...,) z)."""
    z = xyz[..., 2]
    safe_z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * xyz[..., 0] / safe_z + K[0, 2]
    v = K[1, 1] * xyz[..., 1] / safe_z + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward OpenCV distortion on normalized coords; dist = (k1,k2,p1,p2,k3)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(uv: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert the distortion model by fixed-point iteration (the scheme of
    cv::undistortPoints): distorted pixels in, undistorted pixels out."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        safe = torch.where(radial.abs() < 1e-9, torch.full_like(radial, 1e-9), radial)
        x = (x0 - dx) / safe
        y = (y0 - dy) / safe
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)

