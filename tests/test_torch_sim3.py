"""Port parity of ops/sim3solver.py and ops/sim3opt.py.

Horn Sim(3) RANSAC with the JAX solver's own uniform draws fed to the port
(same 3-point sets, same best hypothesis): R, t, s within 1e-3, equal inlier
masks on clean data. `optimize_sim3` and `optimize_essential_graph`: poses
within 1e-3 of the JAX results, final cost within 1% (plus a 1e-6 absolute
floor where the optimum is zero), and two port solves bit-identical. The
4x4 eigh of Horn's N matrix has another sign convention in LAPACK than in
XLA; R is even in the quaternion, so nothing compared depends on it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import lie as jlie
from ceres_mono_orb_slam2_tpu.ops import sim3opt as jopt
from ceres_mono_orb_slam2_tpu.ops import sim3solver as jsolver
from ceres_mono_orb_slam2_tpu_torch.ops import sim3opt as topt
from ceres_mono_orb_slam2_tpu_torch.ops import sim3solver as tsolver

torch.set_num_threads(2)
K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
XI_TRUE = np.array([0.2, -0.1, 0.3, 0.05, -0.04, 0.08, np.log(1.3)], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def proj(X):
    return np.stack([500 * X[:, 0] / X[:, 2] + 320, 500 * X[:, 1] / X[:, 2] + 240], -1).astype(np.float32)


def two_view(seed, n=90, n_bad=0, noise_px=0.0):
    rng = np.random.default_rng(seed)
    X2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], -1).astype(np.float32)
    R12, t12, s12 = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(XI_TRUE)))
    X1 = (s12 * X2 @ R12.T + t12).astype(np.float32)
    uv1 = proj(X1) + rng.standard_normal((n, 2)).astype(np.float32) * noise_px
    uv2 = proj(X2) + rng.standard_normal((n, 2)).astype(np.float32) * noise_px
    if n_bad:  # wrong matches: the 3D point of camera 1 belongs to another landmark
        X1[:n_bad] = X1[rng.permutation(n)[:n_bad]] + rng.uniform(0.5, 1.0, (n_bad, 3)).astype(np.float32)
    w1 = rng.choice([1.0, 0.694], n).astype(np.float32)
    w2 = rng.choice([1.0, 0.694], n).astype(np.float32)
    return (R12, t12, s12), X1, X2, uv1, uv2, w1, w2


def test_horn_sim3_matches():
    rng = np.random.default_rng(0)
    P2 = rng.standard_normal((40, 3, 3)).astype(np.float32)
    xi = (rng.standard_normal((40, 7)) * 0.4).astype(np.float32)
    R, t, s = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi)))
    P1 = (s[:, None, None] * np.einsum("nij,nmj->nmi", R, P2) + t[:, None]).astype(np.float32)
    for fix in (False, True):
        jr = jsolver.horn_sim3(jnp.asarray(P1), jnp.asarray(P2), fix_scale=fix)
        tr = tsolver.horn_sim3(T(P1), T(P2), fix_scale=fix)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    np.testing.assert_allclose(tsolver.horn_sim3(T(P1), T(P2))[0].numpy(), R, atol=1e-3)
    np.testing.assert_allclose(tsolver.horn_sim3(T(P1), T(P2))[2].numpy(), s, atol=1e-3)


@pytest.mark.parametrize("n_bad,pad", [(0, 90), (30, 128)])
def test_ransac_sim3_matches(n_bad, pad):
    """`pad` > N mimics the reference's shape bucket: the port is fed the
    first N columns of the (NH, pad) draws."""
    (R12, t12, s12), X1, X2, uv1, uv2, w1, w2 = two_view(1, n_bad=n_bad)
    n = len(X1)
    key = jax.random.PRNGKey(42)

    def p(a, fill=0):
        out = np.full((pad,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        if a.ndim == 2 and a.shape[1] == 3:
            out[n:, 2] = 1.0
        return jnp.asarray(out)

    valid = np.ones(n, bool)
    jr = jsolver.ransac_sim3(key, jnp.asarray(K), jnp.asarray(K), p(X1), p(X2), p(uv1), p(uv2),
                             p(w1, 1), p(w2, 1), p(valid, False))
    noise = np.array(jax.random.uniform(key, (256, pad)))[:, :n]
    tr = tsolver.ransac_sim3(T(noise), T(K), T(K), T(X1), T(X2), T(uv1), T(uv2), T(w1), T(w2), T(valid))
    assert bool(tr.success) and bool(jr.success)
    assert int(tr.n_inliers) == int(jr.n_inliers) == n - n_bad
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers)[:n])
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    np.testing.assert_allclose(float(tr.s), float(jr.s), atol=1e-3)
    np.testing.assert_allclose(tr.R.numpy(), R12, atol=1e-3)
    np.testing.assert_allclose(float(tr.s), s12, atol=1e-3)


@pytest.mark.parametrize("n_bad", [0, 10])
def test_optimize_sim3_matches(n_bad):
    (R12, t12, s12), X1, X2, uv1, uv2, w1, w2 = two_view(2, n=80, noise_px=0.3)
    if n_bad:
        uv1[:n_bad] += np.random.default_rng(3).uniform(30, 60, (n_bad, 2)).astype(np.float32)
    xi0 = XI_TRUE + np.array([0.05, -0.04, 0.06, 0.02, 0.02, -0.02, 0.08], np.float32)
    R0, t0, s0 = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi0)))
    valid = np.ones(80, bool)
    valid[-5:] = False
    jr = jopt.optimize_sim3(*(jnp.asarray(a) for a in (K, K, X1, X2, uv1, uv2, w1, w2, valid, R0, t0, s0)))
    args = tuple(T(a) for a in (K, K, X1, X2, uv1, uv2, w1, w2, valid, R0, t0)) + (torch.tensor(float(s0)),)
    tr = topt.optimize_sim3(*args)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    np.testing.assert_allclose(float(tr.s), float(jr.s), atol=1e-3)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == 75 - n_bad
    xi = np.asarray(jlie.sim3_log(jnp.asarray(tr.R.numpy()), jnp.asarray(tr.t.numpy()), jnp.asarray(tr.s.numpy())))
    assert np.linalg.norm(xi - XI_TRUE) < 0.02
    again = topt.optimize_sim3(*args)
    assert all(torch.equal(a, b) for a, b in zip(tr, again))


def drifted_ring(P, seed):
    """A ring of P poses with exact odometry and loop measurements, and a
    drifted initialisation (noise and scale drift integrated along the ring)."""
    rng = np.random.default_rng(seed)
    Rt, tt = [], []
    for k in range(P):
        ang = 2 * np.pi * k / P
        Rwc = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.0, ang, 0.0], np.float32))))
        cw = np.array([5 * np.sin(ang), 0.0, 5 * (1 - np.cos(ang))], np.float32)
        Rt.append(Rwc.T)
        tt.append(-Rwc.T @ cw)
    Rt, tt, st = np.array(Rt), np.array(tt), np.ones(P, np.float32)
    ei = list(range(P - 1)) + [P - 1]
    ej = list(range(1, P)) + [0]
    Rm = np.stack([Rt[j] @ Rt[i].T for i, j in zip(ei, ej)]).astype(np.float32)
    tm = np.stack([tt[j] - Rt[j] @ Rt[i].T @ tt[i] for i, j in zip(ei, ej)]).astype(np.float32)
    sm = np.ones(P, np.float32)
    R0, t0, s0 = [Rt[0]], [tt[0]], [np.float32(1.0)]
    for k in range(P - 1):
        d = rng.standard_normal(7).astype(np.float32) * np.array([0.02] * 3 + [0.01] * 3 + [0.01], np.float32)
        dR, dt, ds = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(d)))
        Rk, tk, sk = Rm[k] @ R0[k], sm[k] * Rm[k] @ t0[k] + tm[k], sm[k] * s0[k]
        R0.append(dR @ Rk), t0.append(ds * dR @ tk + dt), s0.append(ds * sk)
    fixed = np.zeros(P, bool)
    fixed[0] = True
    return (Rt, tt, st), (np.array(R0, np.float32), np.array(t0, np.float32), np.array(s0, np.float32),
                          np.array(ei, np.int32), np.array(ej, np.int32), Rm, tm, sm,
                          np.ones(P, bool), fixed)


def test_essential_graph_matches():
    (Rt, tt, st), args = drifted_ring(20, 0)
    jr = jopt.optimize_essential_graph(*(jnp.asarray(a) for a in args), gn_iters=12, cg_iters=60)
    targs = tuple(T(a) for a in args)
    tr = topt.optimize_essential_graph(*targs, gn_iters=12, cg_iters=60)
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    np.testing.assert_allclose(tr.s.numpy(), np.asarray(jr.s), atol=1e-3)
    assert abs(float(tr.cost) - float(jr.cost)) <= 0.01 * float(jr.cost) + 1e-6
    assert np.abs(args[1] - tt).max() > 0.1  # the drift was real
    assert np.abs(tr.t.numpy() - tt).max() < 0.02
    assert np.abs(tr.s.numpy() - st).max() < 0.01
    again = topt.optimize_essential_graph(*targs, gn_iters=12, cg_iters=60)
    assert all(torch.equal(a, b) for a, b in zip(tr, again))


def test_essential_graph_ignores_invalid_edges():
    (Rt, tt, st), args = drifted_ring(8, 1)
    args = list(args)
    args[0], args[1], args[2] = Rt.astype(np.float32), tt.astype(np.float32), st  # start at the optimum
    args[6] = args[6].copy()
    args[6][-1] = 99.0  # a bogus loop edge, masked out
    args[8] = args[8].copy()
    args[8][-1] = False
    tr = topt.optimize_essential_graph(*(T(a) for a in args), gn_iters=5, cg_iters=30)
    jr = jopt.optimize_essential_graph(*(jnp.asarray(a) for a in args), gn_iters=5, cg_iters=30)
    assert np.abs(tr.t.numpy() - tt).max() < 1e-3
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
