"""Two-view monocular initialization: batched RANSAC H/F + reconstruction.

Port of `ceres_mono_orb_slam2_tpu/ops/twoview.py`: every hypothesis of both
models is fitted and scored as one batch, the RH = SH/(SH+SF) > 0.40 model
selection (with fallback to the other model when the preferred one fails its
own gates), then batched reconstruction with cheirality voting.

The random 8-point sets are the top-8 of masked uniform noise per hypothesis;
the (n_hypotheses, N) noise is an argument, so a test can feed both ports
the same draws. Eigenvector and SVD sign conventions differ between backends;
every quantity used downstream is invariant to them.

`initialize_two_view` runs four device stages (`TwoViewStages`: fit,
score, motions, check) around the linear algebra that reads its status
back to the host and so cannot be captured: the eigensolvers of the H and F
fits, the SVD of F's rank-2 projection, the SVDs of E and of K^-1 H K, and
the cheirality check's batched 4x4 eigensolver (`smallest_eigvecs`, in
chunks of at most `EIGH_BATCH` matrices). The stages read nothing back and
upload nothing, so `Tracking` replays a captured program of each.
"""

from __future__ import annotations

from functools import partial
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


# matrices per call of the batched eigensolver: cuSOLVER's batched syev
# (CUDA 12.8, H100) refuses 32,768 or more 4x4 matrices in a call with
# CUSOLVER_STATUS_INVALID_VALUE (the mapper's B = 20 neighbours of 2000
# keypoints are 40,000; the cheirality check's 8 homography motions of 4096
# matches are 32,768), and each matrix is solved alone, so a chunked call
# gives the same bits
EIGH_BATCH = 16384


def smallest_eigvecs(A):
    """The eigenvector of the smallest eigenvalue of each symmetric matrix
    in A (..., n, n), through the batched eigensolver in chunks of at most
    `EIGH_BATCH` matrices."""
    flat = A.reshape((-1,) + A.shape[-2:])
    parts = [torch.linalg.eigh(c)[1][..., :, 0] for c in flat.split(EIGH_BATCH)]
    return torch.cat(parts).reshape(A.shape[:-1])


def _take(a, i):
    """a[i] for a 0-d index tensor i, without reading i back to the host
    (indexing with a 0-d tensor does)."""
    return a.index_select(0, i.reshape(1))[0]


def _homography_system(x1, x2):
    """A^T A (..., 9, 9) of the DLT from 8 correspondences (..., 8, 2): its
    smallest eigenvector is H (x2 ~ H x1), row-major."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    A = torch.cat([r1, r2], dim=-2)
    return A.transpose(-1, -2) @ A


def _fundamental_system(x1, x2):
    """A^T A (..., 9, 9) of the 8-point algorithm: its smallest eigenvector
    is F before the rank-2 projection."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1)
    return A.transpose(-1, -2) @ A


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


def _candidate_cameras(R, t, N: int):
    """P1 = [I | 0] and P2 = [R | t] of each candidate, expanded to
    (..., N, 3, 4)."""
    dt, dev = R.dtype, R.device
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev), torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    P2 = torch.cat([R, t[..., None]], -1)
    bshape = R.shape[:-2]
    return P1.expand(bshape + (N, 3, 4)), P2[..., None, :, :].expand(bshape + (N, 3, 4))


def k_normalised(K, xy):
    """Pixels (..., 2) -> K-normalised image coordinates (..., 2)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], -1)


def cheirality_system(R, t, K, xy1, xy2):
    """CheckRT up to its eigensolver: the DLT normal matrices (..., N, 4,
    4) of every match (xy1, xy2 (N, 2)) under each candidate (R (..., 3,
    3), t (..., 3); cam1 = identity), in K-normalised coordinates (the
    pixel-scale DLT matrix is too ill-conditioned for f32)."""
    bshape = R.shape[:-2]
    P1b, P2b = _candidate_cameras(R, t, xy1.shape[0])
    xn1, xn2 = k_normalised(K, xy1), k_normalised(K, xy2)
    return dlt_normal_matrix(P1b, P2b, xn1.expand(bshape + xn1.shape), xn2.expand(bshape + xn2.shape))


def cheirality_gates(x, R, t, K, xy1, xy2, valid, th2: float = 4.0, sigma2: float = 1.0):
    """CheckRT after its eigensolver: the points from the DLT eigenvectors
    x (..., N, 4), and the 'good' count of each candidate (finite,
    parallax, positive depth, reprojection chi2 < th2*sigma2).
    Returns (n_good, parallax_deg, pts3d (..., N, 3), good mask)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    P1b, P2b = _candidate_cameras(R, t, xy1.shape[0])
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    bshape = R.shape[:-2]
    xy1b = xy1.expand(bshape + xy1.shape)
    xy2b = xy2.expand(bshape + xy2.shape)
    X = dlt_point(x)

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


def _essential_motions(U, Vt):
    """DecomposeE from the SVD of E: (R1, R2, t_unit)."""
    t = U[..., :, 2]
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-12)
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]] filled on the device: an
    # uploaded constant (or a Python number assigned into it) would be a
    # host copy inside a capture
    W = torch.zeros((3, 3), dtype=U.dtype, device=U.device)
    W[0, 1].fill_(-1.0)
    W[1, 0].fill_(1.0)
    W[2, 2].fill_(1.0)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))[..., None, None]
    R2 = R2 * torch.sign(torch.linalg.det(R2))[..., None, None]
    return R1, R2, t


def _homography_motions(U, d, Vt):
    """Faugeras decomposition (ReconstructH) of a homography from the SVD
    U diag(d) Vt of K^-1 H21 K into 8 candidate motions. Returns (8, 3, 3)
    R and (8, 3) unit t, cam1 -> cam2."""
    dt, dev = U.dtype, U.device
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


class TwoViewScores(NamedTuple):
    """What `score_stage` keeps of the best H and the best F."""
    E: torch.Tensor  # (3, 3) K^T F21 K of the best F
    A: torch.Tensor  # (3, 3) K^-1 H21 K of the best H
    use_h: torch.Tensor  # () bool: RH > 0.40
    inl_h: torch.Tensor  # (N,) bool
    inl_f: torch.Tensor  # (N,) bool


class Motions(NamedTuple):
    """The candidate motions of both models and their cheirality systems."""
    Rf: torch.Tensor  # (4, 3, 3)
    tf: torch.Tensor  # (4, 3)
    Rh: torch.Tensor  # (8, 3, 3)
    th: torch.Tensor  # (8, 3)
    AtA_f: torch.Tensor  # (4, N, 4, 4)
    AtA_h: torch.Tensor  # (8, N, 4, 4)


def fit_stage(noise, xy1, xy2, valid):
    """Stage 1, up to the eigensolvers of the fits: each hypothesis' 8
    matches (the 8 largest draws of its row among the valid matches, lower
    index first on ties), the points normalised, and the H and F normal
    matrices. Returns (AtA_h (NH, 9, 9), AtA_f (NH, 9, 9), T1, T2)."""
    noise = torch.where(valid[None, :], noise, torch.full_like(noise, -1.0))
    # stable descending sort == lax.top_k's lower-index-first tie order
    sets = torch.sort(noise, dim=1, descending=True, stable=True).indices[:, :8]
    xn1, T1 = _normalize_points(xy1, valid)
    xn2, T2 = _normalize_points(xy2, valid)
    return _homography_system(xn1[sets], xn2[sets]), _fundamental_system(xn1[sets], xn2[sets]), T1, T2


def score_stage(h, U, S, Vt, T1, T2, K, xy1, xy2, valid, sigma2: float = 1.0) -> TwoViewScores:
    """Stage 2, from the fits' eigenvectors (h (NH, 9); F's SVD U, S, Vt)
    to the SVDs of E and of K^-1 H K: F projected to rank 2, both models
    denormalised and scored, the best of each kept, RH computed."""
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    Fn = U @ (S[..., None] * Vt)
    H21 = torch.linalg.inv_ex(T2)[0] @ Hn @ T1
    F21 = T2.T @ Fn @ T1
    h_scores, h_inl = _score_homography(H21, xy1, xy2, valid[None, :], sigma2)
    f_scores, f_inl = _score_fundamental(F21, xy1, xy2, valid[None, :], sigma2)
    hi = h_scores.argmax()
    fi = f_scores.argmax()
    SH, SF = _take(h_scores, hi), _take(f_scores, fi)
    return TwoViewScores(E=K.T @ _take(F21, fi) @ K,
                         A=torch.linalg.inv_ex(K)[0] @ _take(H21, hi) @ K,
                         use_h=SH / (SH + SF).clamp_min(1e-9) > 0.40,
                         inl_h=_take(h_inl, hi), inl_f=_take(f_inl, fi))


def motions_stage(Ue, Vte, Ua, da, Vta, K, xy1, xy2) -> Motions:
    """Stage 3, from the SVDs of E (Ue, Vte) and of K^-1 H K (Ua, da, Vta)
    to the cheirality check's eigensolver: E's 4 candidates, H's 8 and the
    DLT normal matrices of every match under each."""
    R1, R2, tu = _essential_motions(Ue, Vte)
    Rf = torch.stack([R1, R1, R2, R2])
    tf = torch.stack([tu, -tu, tu, -tu])
    Rh, th = _homography_motions(Ua, da, Vta)
    return Motions(Rf, tf, Rh, th, cheirality_system(Rf, tf, K, xy1, xy2),
                   cheirality_system(Rh, th, K, xy1, xy2))


def check_stage(xf, xh, mo: Motions, sc: TwoViewScores, K, xy1, xy2,
                sigma2: float = 1.0) -> InitResult:
    """Stage 4, after the cheirality eigensolver (xf (4, N, 4), xh (8, N,
    4)): each candidate's good points, the best candidate of each model
    and the model selection."""
    nf, pf, Xf, gf = cheirality_gates(xf, mo.Rf, mo.tf, K, xy1, xy2, sc.inl_f, th2=4.0, sigma2=sigma2)
    nh, ph, Xh, gh = cheirality_gates(xh, mo.Rh, mo.th, K, xy1, xy2, sc.inl_h, th2=4.0, sigma2=sigma2)

    def pick(n_good, par, Xs, good, n_ref, second_ratio):
        k = n_good.argmax()
        best = _take(n_good, k)
        second = n_good.scatter(0, k[None], -1).max()
        n_min = torch.clamp_min((0.9 * n_ref).to(torch.int32), MIN_TRIANGULATED)
        ok = (best >= n_min) & (second < second_ratio * best) & (_take(par, k) > MIN_PARALLAX_DEG)
        return ok, k, _take(Xs, k), _take(good, k), best

    okf, kf, Xf_b, gf_b, nf_b = pick(nf, pf, Xf, gf, sc.inl_f.to(torch.int32).sum(), 0.7)
    okh, kh, Xh_b, gh_b, nh_b = pick(nh, ph, Xh, gh, sc.inl_h.to(torch.int32).sum(), 0.75)

    # RH picks the preferred model; fall back to the other one when the
    # preferred fails its own acceptance gates and the other passes
    use_h = sc.use_h
    choose_h = (use_h & okh) | (~use_h & ~okf & okh)
    choose_f = (~use_h & okf) | (use_h & ~okh & okf)
    return InitResult(
        success=choose_h | choose_f,
        used_homography=choose_h,
        R21=torch.where(choose_h, _take(mo.Rh, kh), _take(mo.Rf, kf)),
        t21=torch.where(choose_h, _take(mo.th, kh), _take(mo.tf, kf)),
        points3d=torch.where(choose_h, Xh_b, Xf_b),
        triangulated=torch.where(choose_h, gh_b, gf_b),
        n_inliers=torch.where(choose_h, nh_b, nf_b),
    )


class TwoViewStages(NamedTuple):
    """The four device stages of `initialize_two_view` at sigma 1: the
    functions, or programs of them."""
    fit: object = fit_stage
    score: object = score_stage
    motions: object = motions_stage
    check: object = check_stage


def initialize_two_view(noise, K, xy1, xy2, valid, sigma: float = 1.0,
                        stages: TwoViewStages = None) -> InitResult:
    """Monocular bootstrap (Initializer::Initialize): batched 8-point RANSAC
    for H and F, RH model selection, batched reconstruction + cheirality.

    noise: (n_hypotheses, N) uniform [0, 1) draws; hypothesis h uses the 8
    valid matches with the largest noise (top-k, lower index on ties).
    xy1, xy2: (N, 2) undistorted matched keypoints (aligned rows); valid (N,).

    `stages` (default: the stage functions at `sigma`) run between the five
    linear-algebra calls; `Tracking` passes programs of them at sigma 1.
    """
    sigma2 = sigma * sigma
    stages = stages or TwoViewStages(score=partial(score_stage, sigma2=sigma2),
                                     check=partial(check_stage, sigma2=sigma2))
    AtA_h, AtA_f, T1, T2 = stages.fit(noise, xy1, xy2, valid)
    f = smallest_eigvecs(AtA_f)
    sc = stages.score(smallest_eigvecs(AtA_h), *torch.linalg.svd(f.reshape(f.shape[:-1] + (3, 3))),
                      T1, T2, K, xy1, xy2, valid)
    Ue, _, Vte = torch.linalg.svd(sc.E)
    mo = stages.motions(Ue, Vte, *torch.linalg.svd(sc.A), K, xy1, xy2)
    return stages.check(smallest_eigvecs(mo.AtA_f), smallest_eigvecs(mo.AtA_h), mo, sc, K, xy1, xy2)
