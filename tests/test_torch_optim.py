"""Port parity: ops/optim.py (pose optimization, dense-Schur bundle
adjustment) and ops/twoview.py (two-view initialization) against the JAX
package on the same synthetic problems.

Tolerances, with their reasons:
- pose_optimization: R and t within 1e-4 and exact inlier masks on a
  well-conditioned problem (the LM iterates agree to f32 rounding; chi2
  classifications are far from the gate).
- bundle_adjustment at P=6, M=200, O=800: 1e-3 relative, since the Schur
  reductions sum in a different order (segment sums vs one-hot matmuls).
- the deterministic normal-equation assembly against an `index_add_`
  assembly (float atomics on CUDA): both sum the same k terms of a segment
  in different orders, and each order is within (k - 1) u sum|x| of the
  exact sum (u the unit roundoff, 2^-53 in f64 and 2^-24 in f32), so they
  differ by at most (k - 1) 2u sum|x|; f64 is also held to 1e-12 sum|x|.
- initialize_two_view: both sides get the same RANSAC noise, so they pick
  the same minimal sets and hypotheses; success flags equal and R21, t21
  within 1e-3 on a well-conditioned pair. The chosen pose is the raw 8-point
  fit of one minimal set, solved by each backend's f32 eigensolver: on a
  poorly conditioned set the two differ by a few 1e-3 in t. Eigen/SVD sign
  conventions differ too, so intermediates are not compared.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import lie as jlie, optim as jopt, twoview as jtv
from ceres_mono_orb_slam2_tpu_torch.ops import optim as topt, twoview as ttv

torch.set_num_threads(2)
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _se3(xi):
    R, t = jlie.se3_exp(jnp.asarray(np.asarray(xi, np.float32)))
    return np.asarray(R), np.asarray(t)


def _scene(rng, n, depth=(4.0, 8.0)):
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                     rng.uniform(*depth, n)], -1).astype(np.float32)


def _project(R, t, pts):
    Xc = pts @ R.T + t
    return np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240],
                    -1).astype(np.float32), Xc[:, 2]


def test_pose_optimization_parity(rng):
    n = 150
    pts = _scene(rng, n)
    R_true, t_true = _se3([0.1, -0.2, 0.15, 0.03, -0.05, 0.02])
    uv, _ = _project(R_true, t_true, pts)
    uv += rng.standard_normal(uv.shape).astype(np.float32) * 0.3
    uv[:15] += rng.uniform(30, 80, (15, 2)).astype(np.float32)  # gross outliers
    w = rng.choice([1.0, 1 / 1.44], n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-10:] = False
    R0, t0 = _se3([0.15, -0.15, 0.07, 0.05, -0.02, 0.0])
    args = (K, R0, t0, pts, uv, w, valid)
    rj = jopt.pose_optimization(*(jnp.asarray(a) for a in args))
    rt = topt.pose_optimization(*(torch.tensor(np.asarray(a)) for a in args))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert not rt.inliers.numpy()[:15].any()


def _ba_problem(rng, P=6, M=200, O=800):
    pts = _scene(rng, M)
    Rs, ts = zip(*[_se3([0.3 * p, 0.02 * p, 0, 0, 0.02 * p, 0]) for p in range(P)])
    Rs, ts = np.stack(Rs), np.stack(ts)
    op = rng.integers(0, P, O).astype(np.int32)
    oj = rng.integers(0, M, O).astype(np.int32)
    oj[:M] = np.arange(M)  # every point observed
    op[:M] = np.arange(M) % P
    op[M:2 * M] = (np.arange(M) + 1) % P  # ... at least twice
    oj[M:2 * M] = np.arange(M)
    ouv = np.stack([_project(Rs[p], ts[p], pts[j:j + 1])[0][0] for p, j in zip(op, oj)])
    ouv += rng.standard_normal(ouv.shape).astype(np.float32) * 0.5
    ouv[-20:] += 40.0  # outliers for the trimming pass
    Rp, tp = Rs.copy(), ts.copy()
    for p in range(2, P):
        dR, dt = _se3(rng.standard_normal(6) * 0.01)
        Rp[p], tp[p] = dR @ Rp[p], dR @ tp[p] + dt
    pts0 = pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.05
    fixed = np.zeros(P, bool)
    fixed[:2] = True
    return (K, Rp, tp, pts0, op, oj, ouv.astype(np.float32),
            rng.choice([1.0, 0.7], O).astype(np.float32), np.ones(O, bool), fixed,
            np.ones(M, bool))


def test_bundle_adjustment_parity(rng):
    args = _ba_problem(rng)
    rj = jopt.bundle_adjustment(*(jnp.asarray(a) for a in args), iters_huber=5, iters_trimmed=5)
    rt = topt.bundle_adjustment(*(torch.tensor(np.asarray(a)) for a in args), iters_huber=5, iters_trimmed=5)
    for a, b in [(rj.R, rt.R), (rj.t, rt.t), (rj.points, rt.points)]:
        a = np.asarray(a)
        scale = np.abs(a).max()
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-3 * scale)
    np.testing.assert_array_equal(rt.inlier_obs.numpy(), np.asarray(rj.inlier_obs))
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    # fixed poses stay fixed
    np.testing.assert_array_equal(rt.R.numpy()[:2], np.asarray(args[1])[:2])


def _index_add_assembly(op, oj, A, B, r, w, P, M):
    """The normal-equation assembly by index_add_ and accumulating
    index_put_ (float atomics on CUDA), the reference."""
    wA, wB = w[:, None, None] * A, w[:, None, None] * B
    z = lambda *shape: torch.zeros(shape, dtype=A.dtype)  # noqa: E731
    return (z(P, 6, 6).index_add_(0, op, torch.einsum("oik,oil->okl", wA, A)),
            z(P, 6).index_add_(0, op, -torch.einsum("oik,oi->ok", wA, r)),
            z(M, 3, 3).index_add_(0, oj, torch.einsum("oik,oil->okl", wB, B)),
            z(M, 3).index_add_(0, oj, -torch.einsum("oik,oi->ok", wB, r)),
            z(M, P, 6, 3).index_put_((oj, op), torch.einsum("oik,oil->okl", wA, B),
                                     accumulate=True))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_deterministic_assembly_matches_index_add(rng, dtype):
    P, M, O = 7, 300, 2500
    op = torch.as_tensor(rng.integers(0, P, O))
    oj = torch.as_tensor(rng.integers(0, M, O))
    oj[-300:], op[-300:] = oj[:300].clone(), op[:300].clone()  # repeated (point, pose) pairs
    A, B, r, w = (torch.as_tensor(x, dtype=dtype) for x in (
        rng.standard_normal((O, 2, 6)) * 50, rng.standard_normal((O, 2, 3)) * 50,
        rng.standard_normal((O, 2)), rng.uniform(0.2, 1.0, O)))
    pair = oj * P + op
    seg = topt.SegmentSum(op, P), topt.SegmentSum(oj, M), topt.SegmentSum(pair, M * P)
    assert seg[2].index.shape[1] >= 2  # some pair segments hold several terms
    new = topt.assemble_normal_equations(*seg, A, B, r, w, P, M)
    old = _index_add_assembly(op, oj, A, B, r, w, P, M)
    mag = [m.abs() for m in _index_add_assembly(op, oj, A.abs(), B.abs(), r.abs(), w, P, M)]
    k_pose, k_point = torch.bincount(op, minlength=P), torch.bincount(oj, minlength=M)
    k_pair = torch.bincount(pair, minlength=M * P).reshape(M, P)
    terms = (k_pose[:, None, None], k_pose[:, None], k_point[:, None, None], k_point[:, None],
             k_pair[:, :, None, None])
    u = torch.finfo(dtype).eps / 2
    for name, a, b, m, k in zip(("Hpp", "bp", "Hll", "bl", "U"), new, old, mag, terms):
        assert a.shape == b.shape, name
        bound = (k - 1).clamp_min(0) * 2 * u * m
        if dtype == torch.float64:
            bound = torch.minimum(bound, 1e-12 * m)
        assert ((a - b).abs() <= bound).all(), (name, float((a - b).abs().max()))


def _two_view(rng, n=400, baseline=0.8):
    pts = _scene(rng, n, depth=(4.0, 10.0))
    R21, t21 = _se3([baseline, 0.02, 0.01, 0.01, -0.08, 0.02])
    uv1, _ = _project(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), pts)
    uv2, _ = _project(R21, t21, pts)
    inb = ((uv1 > 0) & (uv1 < [640, 480]) & (uv2 > 0) & (uv2 < [640, 480])).all(-1)
    uv1 = uv1 + rng.standard_normal(uv1.shape).astype(np.float32) * 0.3
    uv2 = uv2 + rng.standard_normal(uv2.shape).astype(np.float32) * 0.3
    bad = rng.random(n) < 0.1
    uv2[bad] = rng.uniform(0, 640, (bad.sum(), 2)).astype(np.float32)
    return uv1.astype(np.float32), uv2.astype(np.float32), inb


def test_initialize_two_view_parity(rng):
    import jax

    for baseline in (0.8, 0.0):  # a good pair, and a pure rotation that must fail
        uv1, uv2, valid = _two_view(rng, baseline=baseline)
        key = jax.random.PRNGKey(3)
        noise = np.asarray(jax.random.uniform(key, (256, len(uv1))))
        rj = jtv.initialize_two_view(key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2),
                                     jnp.asarray(valid))
        rt = ttv.initialize_two_view(torch.as_tensor(noise), torch.as_tensor(K),
                                     torch.as_tensor(uv1), torch.as_tensor(uv2),
                                     torch.as_tensor(valid))
        assert bool(rt.success) == bool(rj.success)
        assert bool(rt.success) == (baseline > 0)
        if bool(rj.success):
            assert bool(rt.used_homography) == bool(rj.used_homography)
            np.testing.assert_allclose(rt.R21.numpy(), np.asarray(rj.R21), atol=1e-3)
            np.testing.assert_allclose(rt.t21.numpy(), np.asarray(rj.t21), atol=1e-3)
            tri_j, tri_t = np.asarray(rj.triangulated), rt.triangulated.numpy()
            assert (tri_j != tri_t).sum() <= 0.01 * tri_j.sum()
