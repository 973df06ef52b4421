"""SO(3) / SE(3) Lie-group operations in PyTorch.

Port of the SO(3)/SE(3) half of `ceres_mono_orb_slam2_tpu/ops/lie.py` (the
Sim(3) half waits for loop closing). Same conventions:
  - so3 tangent: omega (3,); se3 tangent: (upsilon(3), omega(3)) -> (6,)
  - quaternions are (x, y, z, w), Eigen coefficient order.
Small-angle branches are `torch.where` on guarded denominators, batched over
leading dims, no host synchronisation.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    small = theta.abs() < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(safe) / safe)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    # (1 - cos t)/t^2 = 2 sin^2(t/2)/t^2, the cancellation-free half-angle form
    small = theta2 < _EPS ** 2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    sh = torch.sin(theta * 0.5)
    b = torch.where(small, 0.5 - theta2 / 24.0, 2.0 * sh * sh / safe_t2)[..., None, None]
    return _eye3(w) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3). Handles angles up to pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    w_generic = vee(R - R.transpose(-1, -2))
    small = theta < 1e-5
    # arccos loses ~sqrt(eps) near +-1: recover theta in a wide near-pi band
    # from |vee(R - R^T)| = 2 sin(theta)
    near_pi = math.pi - theta < 1e-3
    denom = torch.where(sin_theta.abs() < _EPS, torch.ones_like(sin_theta), 2.0 * sin_theta)
    factor = torch.where(small, 0.5 + theta ** 2 / 12.0, theta / denom)
    w = factor[..., None] * w_generic
    sin_np = (0.5 * torch.linalg.norm(w_generic, dim=-1)).clamp(0.0, 1.0)
    theta = torch.where(near_pi, math.pi - torch.arcsin(sin_np), theta)
    # near pi: (R + I)/2 ~ a a^T; its largest column is the axis, signed like
    # vee(R - R^T) = 2 sin(theta) a
    B = (R + _eye3(R)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = diag.argmax(-1)
    col = torch.take_along_dim(B, k[..., None, None].expand(*k.shape, 3, 1), dim=-1)[..., 0]
    axis = col / torch.linalg.norm(col, dim=-1, keepdim=True).clamp_min(_EPS)
    flip = torch.where((w_generic * axis).sum(-1) < 0, -1.0, 1.0)
    w_pi = flip[..., None] * axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) by two Newton steps of the polar
    iteration R <- R (3I - R^T R)/2.

    Load-bearing: without it f32 determinant drift survives the LM solves and
    the constant-velocity model compounds it every frame (the JAX package's
    KNOWN_ISSUES frame-14 divergence). Call it at every optimizer entry/exit.
    """
    eye = _eye3(R)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.transpose(-1, -2) @ R))
    return R


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2)
    W = hat(w)
    W2 = W @ W
    # (t - sin t)/t^3 by Taylor below t = 0.1 (the closed form loses about
    # half the f32 mantissa to cancellation there)
    small = theta < 0.1
    tiny = theta < _EPS
    one = torch.ones_like(theta)
    safe_t = torch.where(small, one, theta)
    safe_t2 = torch.where(small, one, theta2)
    sh = torch.sin(theta * 0.5)
    a = torch.where(tiny, 0.5 - theta2 / 24.0, 2.0 * sh * sh / torch.where(tiny, one, theta2))
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (safe_t - torch.sin(theta)) / (safe_t2 * safe_t),
    )
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def se3_exp(xi: torch.Tensor):
    """(..., 6) tangent (upsilon, omega) -> (R (..., 3, 3), t (..., 3))."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    t = (V @ v[..., None])[..., 0]
    return R, t


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (x, y, z, w), w >= 0. Branch-free Shepperd method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(qw.clamp_min(1e-12)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    c0 = torch.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0), w0], dim=-1)
    c1 = torch.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1), (m21 - m12) / (4 * x1)], dim=-1)
    c2 = torch.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2), (m02 - m20) / (4 * y2)], dim=-1)
    c3 = torch.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3, (m10 - m01) / (4 * z3)], dim=-1)
    best = qw.argmax(-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.take_along_dim(cands, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)[..., 0, :]
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
