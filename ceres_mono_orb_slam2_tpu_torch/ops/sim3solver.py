"""Horn closed-form similarity and its RANSAC for loop-closure Sim(3).

Port of `ceres_mono_orb_slam2_tpu/ops/sim3solver.py`, the equivalent of the
reference Sim3Solver: Horn 1987 absolute orientation (quaternion from the
eigendecomposition of the 4x4 N matrix) with the reference's asymmetric
scale formula, inside a RANSAC over 3-point sets whose inlier test is the
two-way reprojection with chi2 gates 9.210 * sigma2. All hypotheses are
evaluated as one batch; the RANSAC draws are an argument, as in `ops/pnp`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def horn_sim3(P1, P2, fix_scale: bool = False):
    """Closed-form similarity S12 aligning point sets: P1 ~ s R P2 + t.

    P1, P2: (..., M, 3) corresponding 3D points (M >= 3).
    Returns (R (..., 3, 3), t (..., 3), s (...,)).
    """
    c1 = P1.mean(-2, keepdim=True)
    c2 = P2.mean(-2, keepdim=True)
    Pr1 = P1 - c1
    Pr2 = P2 - c2
    # (..., 3, 3) = sum p2 p1^T: with this orientation of Horn's M the
    # recovered quaternion rotates frame-2 points into frame 1
    M = Pr2.transpose(-1, -2) @ Pr1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    # Horn's symmetric 4x4 N matrix, quaternion order (w, x, y, z)
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
        ],
        dim=-2,
    )
    _, vecs = torch.linalg.eigh(N)
    # largest eigenvalue -> rotation quaternion; R is even in q, so the
    # eigenvector's arbitrary sign does not matter
    q = vecs[..., :, -1]
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )
    P3 = R @ Pr2.transpose(-1, -2)  # (..., 3, M) rotated Pr2
    if fix_scale:
        s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    else:
        # the reference's asymmetric scale: s = <Pr1, R Pr2> / ||R Pr2||^2
        num = (Pr1.transpose(-1, -2) * P3).sum((-1, -2))
        den = (P3 * P3).sum((-1, -2))
        s = num / den.clamp_min(1e-12)
    t = c1[..., 0, :] - s[..., None] * (R @ c2[..., 0, :, None])[..., 0]
    return R, t, s


class Sim3RansacResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def ransac_sim3(
    noise,  # (NH, N) uniform draws
    K1,
    K2,
    X1,  # (N, 3) matched map points in the camera-1 frame
    X2,  # (N, 3) matched map points in the camera-2 frame
    uv1,  # (N, 2) keypoint of the match in image 1
    uv2,  # (N, 2) keypoint of the match in image 2
    inv_sigma2_1,  # (N,) octave information in image 1
    inv_sigma2_2,  # (N,)
    valid,  # (N,)
    chi2_th: float = 9.210,
    min_inliers: int = 20,
    fix_scale: bool = False,
) -> Sim3RansacResult:
    """RANSAC Horn Sim(3) S12 with the two-way reprojection inlier test
    (Sim3Solver::iterate + CheckInliers). A hypothesis' 3-point set is the 3
    largest entries of its noise row among the valid matches."""
    noise = torch.where(valid[None, :], noise, torch.full_like(noise, -1.0))
    sets = torch.topk(noise, 3, dim=-1).indices  # (NH, 3)
    R, t, s = horn_sim3(X1[sets], X2[sets], fix_scale=fix_scale)

    def proj(Km, X):
        z = torch.where(X[..., 2].abs() < 1e-9, torch.full_like(X[..., 2], 1e-9), X[..., 2])
        return torch.stack([Km[0, 0] * X[..., 0] / z + Km[0, 2],
                            Km[1, 1] * X[..., 1] / z + Km[1, 2]], dim=-1)

    # X2 -> camera 1, and X1 -> camera 2 through the inverse
    q1 = s[..., None, None] * torch.einsum("...ij,mj->...mi", R, X2) + t[..., None, :]
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    ti = -si[..., None] * (Rt @ t[..., None])[..., 0]
    q2 = si[..., None, None] * torch.einsum("...ij,mj->...mi", Rt, X1) + ti[..., None, :]
    e1 = ((proj(K1, q1) - uv1) ** 2).sum(-1) * inv_sigma2_1
    e2 = ((proj(K2, q2) - uv2) ** 2).sum(-1) * inv_sigma2_2
    inl = valid & (e1 <= chi2_th) & (e2 <= chi2_th)
    counts = inl.sum(-1, dtype=torch.int32)
    best = counts.argmax()  # the first maximum
    n = counts[best]
    return Sim3RansacResult(success=n >= min_inliers, R=R[best], t=t[best], s=s[best],
                            inliers=inl[best], n_inliers=n)
