"""Two-view monocular initialization: batched RANSAC H/F + reconstruction.

Port of `ceres_mono_orb_slam2_tpu/ops/twoview.py`: every hypothesis of both
models is fitted and scored as one batch, the RH = SH/(SH+SF) > 0.40 model
selection (with fallback to the other model when the preferred one fails its
own gates), then batched reconstruction with cheirality voting.

The random 8-point sets are the top-8 of masked uniform noise per hypothesis;
the (n_hypotheses, N) noise is an argument, so a test can feed both ports
the same draws. Eigenvector and SVD sign conventions differ between backends;
every quantity used downstream is invariant to them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50


def _normalize_points(xy, valid):
    """Zero mean, unit mean absolute deviation per axis; xn = T @ x."""
    n = valid.sum().clamp_min(1).to(xy.dtype)
    mean = torch.where(valid[:, None], xy, torch.zeros_like(xy)).sum(0) / n
    d = torch.where(valid[:, None], (xy - mean).abs(), torch.zeros_like(xy))
    s = 1.0 / (d.sum(0) / n).clamp_min(1e-9)
    xn = (xy - mean) * s
    T = torch.eye(3, dtype=xy.dtype, device=xy.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mean[0] * s[0], -mean[1] * s[1]
    return xn, T


def _smallest_eigvec(A):
    """Eigenvector of the smallest eigenvalue of symmetric A (batched)."""
    return torch.linalg.eigh(A)[1][..., :, 0]


def _fit_homography(x1, x2):
    """DLT from 8 correspondences: (..., 8, 2) -> H (..., 3, 3), x2 ~ H x1."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    A = torch.cat([r1, r2], dim=-2)
    h = _smallest_eigvec(A.transpose(-1, -2) @ A)
    return h.reshape(h.shape[:-1] + (3, 3))


def _fit_fundamental(x1, x2):
    """8-point + rank-2 projection."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)
    f = _smallest_eigvec(A.transpose(-1, -2) @ A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ (S[..., None] * Vt)


def _safe_w(w):
    return torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)


def _apply_h(H, xy):
    """(..., 3, 3) x (N, 2) -> (..., N, 2) projective transform."""
    x, y = xy[..., 0], xy[..., 1]
    w = _safe_w(H[..., 2, 0, None] * x + H[..., 2, 1, None] * y + H[..., 2, 2, None])
    u = (H[..., 0, 0, None] * x + H[..., 0, 1, None] * y + H[..., 0, 2, None]) / w
    v = (H[..., 1, 0, None] * x + H[..., 1, 1, None] * y + H[..., 1, 2, None]) / w
    return torch.stack([u, v], -1)


def _score_homography(H21, xy1, xy2, valid, sigma2: float = 1.0):
    """Symmetric transfer chi2 both ways; score = sum of (5.991 - chi2) over
    passing directions; inlier iff both pass."""
    H12 = torch.linalg.inv_ex(H21)[0]
    chi21 = ((xy2 - _apply_h(H21, xy1)) ** 2).sum(-1) / sigma2
    chi12 = ((xy1 - _apply_h(H12, xy2)) ** 2).sum(-1) / sigma2
    ok1 = chi21 <= CHI2_H
    ok2 = chi12 <= CHI2_H
    zero = torch.zeros_like(chi21)
    sc = torch.where(ok1, CHI2_H - chi21, zero) + torch.where(ok2, CHI2_H - chi12, zero)
    return torch.where(valid, sc, zero).sum(-1), valid & ok1 & ok2


def _epipolar_chi2(F21, xy1, xy2, sigma2: float):
    """Squared point-to-epipolar-line distances, both directions."""
    x, y = xy1[..., 0], xy1[..., 1]
    a2 = F21[..., 0, 0, None] * x + F21[..., 0, 1, None] * y + F21[..., 0, 2, None]
    b2 = F21[..., 1, 0, None] * x + F21[..., 1, 1, None] * y + F21[..., 1, 2, None]
    c2 = F21[..., 2, 0, None] * x + F21[..., 2, 1, None] * y + F21[..., 2, 2, None]
    num2 = a2 * xy2[..., 0] + b2 * xy2[..., 1] + c2
    chi21 = num2 * num2 / (a2 * a2 + b2 * b2).clamp_min(1e-12) / sigma2
    u, v = xy2[..., 0], xy2[..., 1]
    a1 = F21[..., 0, 0, None] * u + F21[..., 1, 0, None] * v + F21[..., 2, 0, None]
    b1 = F21[..., 0, 1, None] * u + F21[..., 1, 1, None] * v + F21[..., 2, 1, None]
    c1 = F21[..., 0, 2, None] * u + F21[..., 1, 2, None] * v + F21[..., 2, 2, None]
    num1 = a1 * xy1[..., 0] + b1 * xy1[..., 1] + c1
    chi12 = num1 * num1 / (a1 * a1 + b1 * b1).clamp_min(1e-12) / sigma2
    return chi21, chi12


def _score_fundamental(F21, xy1, xy2, valid, sigma2: float = 1.0):
    """Inlier gate 3.841, score credit (5.991 - chi2) per passing direction."""
    chi21, chi12 = _epipolar_chi2(F21, xy1, xy2, sigma2)
    ok1 = chi21 <= CHI2_F
    ok2 = chi12 <= CHI2_F
    zero = torch.zeros_like(chi21)
    sc = torch.where(ok1, SCORE_TH - chi21, zero) + torch.where(ok2, SCORE_TH - chi12, zero)
    return torch.where(valid, sc, zero).sum(-1), valid & ok1 & ok2


def dlt_normal_matrix(P1, P2, xy1, xy2):
    """A^T A (..., 4, 4) of the linear triangulation of xy1 / xy2 (..., 2)
    under P1, P2 (..., 3, 4): its smallest eigenvector is the point."""
    r0 = xy1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :]
    r1 = xy1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :]
    r2 = xy2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :]
    r3 = xy2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]
    A = torch.stack([r0, r1, r2, r3], dim=-2)
    return A.transpose(-1, -2) @ A


def dlt_point(x):
    """The homogeneous solution x (..., 4) as a 3D point (..., 3)."""
    return x[..., :3] / _safe_w(x[..., 3])[..., None]


def triangulate_dlt(P1, P2, xy1, xy2):
    """Linear triangulation: P1, P2 (..., 3, 4); xy (..., 2) -> (..., 3)."""
    return dlt_point(_smallest_eigvec(dlt_normal_matrix(P1, P2, xy1, xy2)))


def check_rt(R, t, K, xy1, xy2, valid, th2: float = 4.0, sigma2: float = 1.0):
    """CheckRT: triangulate all matches under candidate (R, t) (cam1 =
    identity) and count 'good' points (finite, parallax, positive depth,
    reprojection chi2 < th2*sigma2). R (..., 3, 3), t (..., 3).
    Returns (n_good, parallax_deg, pts3d (..., N, 3), good mask)."""
    dt, dev = K.dtype, K.device
    # triangulate in K-normalised coordinates (the pixel-scale DLT matrix is
    # too ill-conditioned for f32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xn1 = torch.stack([(xy1[..., 0] - cx) / fx, (xy1[..., 1] - cy) / fy], -1)
    xn2 = torch.stack([(xy2[..., 0] - cx) / fx, (xy2[..., 1] - cy) / fy], -1)
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    P2 = torch.cat([R, t[..., None]], -1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    bshape = R.shape[:-2]
    N = xy1.shape[0]
    xy1b = xy1.expand(bshape + xy1.shape)
    xy2b = xy2.expand(bshape + xy2.shape)
    P1b = P1.expand(bshape + (N, 3, 4))
    P2b = P2[..., None, :, :].expand(bshape + (N, 3, 4))
    X = triangulate_dlt(P1b, P2b, xn1.expand(bshape + xn1.shape), xn2.expand(bshape + xn2.shape))

    finite = torch.isfinite(X).all(-1)
    n2 = X - O2[..., None, :]
    d1 = torch.linalg.norm(X, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = (X * n2).sum(-1) / (d1 * d2).clamp_min(1e-12)
    z1 = X[..., 2]
    z2 = ((R[..., None, :, :] @ X[..., None])[..., 0] + t[..., None, :])[..., 2]
    ok_depth = (z1 > 0) & (z2 > 0)
    low_par = cos_par > 0.99998

    def reproj_err(P, xy):
        ph = (P[..., :, :3] @ X[..., None])[..., 0] + P[..., :, 3]
        w = _safe_w(ph[..., 2])
        u = fx * ph[..., 0] / w + cx
        v = fy * ph[..., 1] / w + cy
        return (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2

    ok_rep = (reproj_err(P1b, xy1b) <= th2 * sigma2) & (reproj_err(P2b, xy2b) <= th2 * sigma2)
    # the depth test is skipped for near-infinite points (cos >= 0.99998),
    # which still count toward nGood but are not triangulated-good
    counted = valid & finite & ok_rep & (ok_depth | low_par)
    good = counted & ~low_par
    n_good = counted.to(torch.int32).sum(-1)
    # parallax statistic: the min(50, n-1)-th smallest counted cosine
    kk = min(51, cos_par.shape[-1])
    cp = torch.where(counted, cos_par, torch.full_like(cos_par, 2.0))
    asc = torch.topk(cp, kk, dim=-1, largest=False, sorted=True).values
    idx = (n_good - 1).clamp_max(50).clamp(0, kk - 1).long()
    cos_stat = torch.gather(asc, -1, idx[..., None])[..., 0]
    parallax_deg = torch.rad2deg(torch.arccos(cos_stat.clamp(-1.0, 1.0)))
    parallax_deg = torch.where(n_good > 0, parallax_deg, torch.zeros_like(parallax_deg))
    return n_good, parallax_deg, X, good


def _decompose_E(E):
    """E -> (R1, R2, t_unit) (DecomposeE)."""
    U, _, Vt = torch.linalg.svd(E)
    t = U[..., :, 2]
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))[..., None, None]
    R2 = R2 * torch.sign(torch.linalg.det(R2))[..., None, None]
    return R1, R2, t


def _homography_motions(H21, K):
    """Faugeras decomposition of a homography into 8 candidate motions
    (ReconstructH). Returns (8, 3, 3) R and (8, 3) unit t, cam1 -> cam2."""
    dt, dev = H21.dtype, H21.device
    A = torch.linalg.inv(K) @ H21 @ K
    U, d, Vt = torch.linalg.svd(A)
    V = Vt.transpose(-1, -2)
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3).clamp_min(1e-12)).clamp_min(0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3).clamp_min(1e-12)).clamp_min(0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp_min(0.0))

    # case d' = d2 > 0
    aux_st = root / ((d1 + d3) * d2).clamp_min(1e-12)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp_min(1e-12)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    # case d' = -d2 < 0
    aux_sp = root / ((d1 - d3) * d2).clamp_min(1e-12)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp_min(1e-12)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    for i in range(4):
        Rs.append(mat([[ct, zero, -st[i]], [zero, one, zero], [st[i], zero, ct]]))
        ts.append(torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3))
    for i in range(4):
        Rs.append(mat([[cp, zero, sp[i]], [zero, -one, zero], [sp[i], zero, -cp]]))
        ts.append(torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3))
    Rs_out, ts_out = [], []
    for Rp, tp in zip(Rs, ts):
        Rs_out.append(s * (U @ Rp @ Vt))
        t = U @ tp
        ts_out.append(t / torch.linalg.norm(t).clamp_min(1e-12))
    return torch.stack(Rs_out), torch.stack(ts_out)


class InitResult(NamedTuple):
    success: torch.Tensor  # () bool
    used_homography: torch.Tensor  # () bool
    R21: torch.Tensor  # (3, 3)
    t21: torch.Tensor  # (3,)
    points3d: torch.Tensor  # (N, 3) in camera-1 frame
    triangulated: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def initialize_two_view(noise, K, xy1, xy2, valid, sigma: float = 1.0) -> InitResult:
    """Monocular bootstrap (Initializer::Initialize): batched 8-point RANSAC
    for H and F, RH model selection, batched reconstruction + cheirality.

    noise: (n_hypotheses, N) uniform [0, 1) draws; hypothesis h uses the 8
    valid matches with the largest noise (top-k, lower index on ties).
    xy1, xy2: (N, 2) undistorted matched keypoints (aligned rows); valid (N,).
    """
    sigma2 = sigma * sigma
    noise = torch.where(valid[None, :], noise, torch.full_like(noise, -1.0))
    # stable descending sort == lax.top_k's lower-index-first tie order
    sets = torch.sort(noise, dim=1, descending=True, stable=True).indices[:, :8]

    xn1, T1 = _normalize_points(xy1, valid)
    xn2, T2 = _normalize_points(xy2, valid)
    Hn = _fit_homography(xn1[sets], xn2[sets])
    Fn = _fit_fundamental(xn1[sets], xn2[sets])
    H21 = torch.linalg.inv(T2) @ Hn @ T1
    F21 = T2.T @ Fn @ T1

    h_scores, h_inl = _score_homography(H21, xy1, xy2, valid[None, :], sigma2)
    f_scores, f_inl = _score_fundamental(F21, xy1, xy2, valid[None, :], sigma2)
    hi = h_scores.argmax()
    fi = f_scores.argmax()
    SH, SF = h_scores[hi], f_scores[fi]
    inlH, inlF = h_inl[hi], f_inl[fi]
    use_h = SH / (SH + SF).clamp_min(1e-9) > 0.40

    # F path: E decomposition -> 4 candidates
    R1, R2, tu = _decompose_E(K.T @ F21[fi] @ K)
    Rf = torch.stack([R1, R1, R2, R2])
    tf = torch.stack([tu, -tu, tu, -tu])
    nf, pf, Xf, gf = check_rt(Rf, tf, K, xy1, xy2, inlF, th2=4.0, sigma2=sigma2)
    # H path: 8 Faugeras motions
    Rh, th = _homography_motions(H21[hi], K)
    nh, ph, Xh, gh = check_rt(Rh, th, K, xy1, xy2, inlH, th2=4.0, sigma2=sigma2)

    def pick(n_good, par, Xs, good, n_ref, second_ratio):
        k = n_good.argmax()
        best = n_good[k]
        second = n_good.scatter(0, k[None], -1).max()
        n_min = torch.clamp_min((0.9 * n_ref).to(torch.int32), MIN_TRIANGULATED)
        ok = (best >= n_min) & (second < second_ratio * best) & (par[k] > MIN_PARALLAX_DEG)
        return ok, k, Xs[k], good[k], best

    okf, kf, Xf_b, gf_b, nf_b = pick(nf, pf, Xf, gf, inlF.to(torch.int32).sum(), 0.7)
    okh, kh, Xh_b, gh_b, nh_b = pick(nh, ph, Xh, gh, inlH.to(torch.int32).sum(), 0.75)

    # RH picks the preferred model; fall back to the other one when the
    # preferred fails its own acceptance gates and the other passes
    choose_h = (use_h & okh) | (~use_h & ~okf & okh)
    choose_f = (~use_h & okf) | (use_h & ~okh & okf)
    return InitResult(
        success=choose_h | choose_f,
        used_homography=choose_h,
        R21=torch.where(choose_h, Rh[kh], Rf[kf]),
        t21=torch.where(choose_h, th[kh], tf[kf]),
        points3d=torch.where(choose_h, Xh_b, Xf_b),
        triangulated=torch.where(choose_h, gh_b, gf_b),
        n_inliers=torch.where(choose_h, nh_b, nf_b),
    )
