"""SO(3) / SE(3) / Sim(3) Lie-group operations in PyTorch.

Port of `ceres_mono_orb_slam2_tpu/ops/lie.py`. Same conventions:
  - so3 tangent: omega (3,); se3 tangent: (upsilon(3), omega(3)) -> (6,)
  - sim3 tangent: (upsilon(3), omega(3), sigma) -> (7,), scale s = exp(sigma);
    a Sim(3) element is (R, t, s) acting as x -> s R x + t
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


def matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A (..., n, m) times v (..., m) -> (..., n). One matrix and one vector
    take the plain matrix-vector product, so that an unbatched caller keeps
    the arithmetic it had before the leading axes were allowed."""
    if A.dim() == 2 and v.dim() == 1:
        return A @ v
    return (A @ v[..., None])[..., 0]


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


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (..., 6)."""
    w = so3_log(R)
    V = so3_left_jacobian(w)
    v = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (..., 4, 4) homogeneous matrix."""
    bot = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bot[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bot], dim=-2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion -> rotation matrix. Normalizes its input."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


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


# ---------------------------------------------------------------------- Sim(3)


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The sim3 'V' matrix W with t = W @ upsilon in sim3_exp:
    W = integral_0^1 e^{sigma u} R(u theta) du = C I + A Omega + B Omega^2.

    float32 stability decides the form (the naive closed form loses its
    mantissa to cancellation for theta in [1e-5, 1e-1]). Three regimes, every
    branch finite so that the unselected ones cannot poison `torch.where`:
      1. theta < 0.1 and |sigma| < 0.1: double Taylor series of the moment
         integrals E_k = integral_0^1 u^k e^{sigma u} du,
      2. theta < 0.1, |sigma| >= 0.1: E_k by the recurrence
         E_k = (e^s - k E_{k-1}) / s,
      3. theta >= 0.1: closed form from half-angle and expm1 terms.
    """
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2)
    s = torch.exp(sigma)
    expm1s = torch.expm1(sigma)
    Omega = hat(w)
    Omega2 = Omega @ Omega
    small_t = theta < 0.1
    small_s = sigma.abs() < 0.1
    one = torch.ones_like(theta)

    def ek_series(k):  # |sigma| < 0.1: the next term is below 1e-8
        return (1.0 / (k + 1) + sigma * (1.0 / (k + 2)) + sigma ** 2 * (0.5 / (k + 3))
                + sigma ** 3 * (1.0 / (6.0 * (k + 4))) + sigma ** 4 * (1.0 / (24.0 * (k + 5))))

    A1 = ek_series(1) - (theta2 / 6.0) * ek_series(3)
    B1 = 0.5 * ek_series(2) - (theta2 / 24.0) * ek_series(4)
    C1 = ek_series(0)

    safe_sig = torch.where(small_s, one, sigma)
    E0 = expm1s / safe_sig
    E1 = (s - E0) / safe_sig
    E2 = (s - 2.0 * E1) / safe_sig
    E3 = (s - 3.0 * E2) / safe_sig
    E4 = (s - 4.0 * E3) / safe_sig
    A2 = E1 - (theta2 / 6.0) * E3
    B2 = 0.5 * E2 - (theta2 / 24.0) * E4
    C = torch.where(small_s, C1, E0)

    safe_t = torch.where(small_t, one, theta)
    safe_t2 = torch.where(small_t, one, theta2)
    safe_c = torch.where(small_t, one, theta2 + sigma * sigma)  # theta >= 0.1 -> c >= 0.01
    a_ = s * torch.sin(theta)
    sh = torch.sin(theta * 0.5)
    one_minus_b = 2.0 * s * sh * sh - expm1s  # = 1 - s cos(theta), stable
    A3 = (a_ * sigma + one_minus_b * safe_t) / (safe_t * safe_c)
    B3 = (C - (a_ * safe_t - sigma * one_minus_b) / safe_c) / safe_t2

    A = torch.where(small_t, torch.where(small_s, A1, A2), A3)
    B = torch.where(small_t, torch.where(small_s, B1, B2), B3)
    return A[..., None, None] * Omega + B[..., None, None] * Omega2 + C[..., None, None] * _eye3(w)


def sim3_exp(xi: torch.Tensor):
    """(..., 7) tangent (upsilon, omega, sigma) -> (R, t, s)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_sim3_W(w, sigma) @ v[..., None])[..., 0]
    return so3_exp(w), t, torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(R, t, s) -> (..., 7)."""
    w = so3_log(R)
    sigma = torch.log(s)
    # solve_ex: the bits of solve without its host check of `info` (which
    # synchronises and cannot be captured)
    v = torch.linalg.solve_ex(_sim3_W(w, sigma), t[..., None])[0][..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0], s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(a) * (b): x -> sa Ra (sb Rb x + tb) + ta."""
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def sim3_apply(R, t, s, x):
    """Apply a similarity to points x (..., 3)."""
    return s[..., None] * (R @ x[..., None])[..., 0] + t


def sim3_adjoint(R, t, s) -> torch.Tensor:
    """7x7 adjoint, S exp(x) S^-1 = exp(Adj_S x), tangent order (v, w, sigma):
    Adj = [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]] (the form of the
    essential-graph Jacobian)."""
    A = torch.zeros(R.shape[:-2] + (7, 7), dtype=R.dtype, device=R.device)
    A[..., 0:3, 0:3] = s[..., None, None] * R
    A[..., 0:3, 3:6] = hat(t) @ R
    A[..., 0:3, 6] = -t
    A[..., 3:6, 3:6] = R
    A[..., 6, 6] = 1.0
    return A


def sim3_ad(xi: torch.Tensor) -> torch.Tensor:
    """7x7 'little' adjoint ad(xi) of a sim3 tangent xi = (v, w, sigma):
    [[hat(w) + sigma I, hat(v), -v], [0, hat(w), 0], [0, 0, 0]]."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    A = torch.zeros(xi.shape[:-1] + (7, 7), dtype=xi.dtype, device=xi.device)
    A[..., 0:3, 0:3] = hat(w) + sigma[..., None, None] * _eye3(xi)
    A[..., 0:3, 3:6] = hat(v)
    A[..., 0:3, 6] = -v
    A[..., 3:6, 3:6] = hat(w)
    return A


def sim3_right_jacobian_inv_approx(xi: torch.Tensor) -> torch.Tensor:
    """BCH-approximate inverse right Jacobian Jr^-1 ~ I + ad/2 + ad^2/12, the
    approximation of the essential-graph residual Jacobians."""
    ad = sim3_ad(xi)
    eye = torch.eye(7, dtype=xi.dtype, device=xi.device)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)
