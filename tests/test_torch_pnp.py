"""Port parity of ops/pnp.py: P3P / DLT RANSAC absolute pose.

The same numpy problem goes through the JAX solver and the port's, with the
port fed the JAX solver's own uniform draws (`jax.random.uniform(key,
(NH, N))`, and for the batched call one split key per candidate), so both
draw the same minimal sets. Stated tolerances: R and t within 1e-3 of each
other; equal best hypothesis (same inlier count) and equal inlier masks on
clean data (no observation near the chi2 gate). The small factorizations
(SVD, eigh) differ between XLA and LAPACK in sign and order conventions;
what is compared does not depend on them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import pnp as jpnp
from ceres_mono_orb_slam2_tpu_torch.ops import pnp as tpnp

torch.set_num_threads(2)
K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)


def rot(w):
    th = np.linalg.norm(w)
    k = np.asarray(w) / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


def problem(seed, n=160, inlier_frac=0.6, noise_px=0.0):
    rng = np.random.default_rng(seed)
    R, t = rot([0.1, -0.2, 0.05]), np.array([0.3, -0.1, 0.5], np.float32)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], -1).astype(np.float32)
    Xc = X @ R.T + t
    uv = (K[:2, :2].diagonal() * Xc[:, :2] / Xc[:, 2:] + K[:2, 2]).astype(np.float32)
    uv += rng.standard_normal(uv.shape).astype(np.float32) * noise_px
    bad = rng.random(n) >= inlier_frac
    uv[bad] += (rng.uniform(30, 90, (int(bad.sum()), 2)) * rng.choice([-1, 1], (int(bad.sum()), 2))).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-15:] = False
    w = rng.choice([1.0, 0.694, 0.482], n).astype(np.float32)
    return R, t, X, uv, w, valid, bad


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("solver,inlier_frac,nh", [("p3p", 0.6, 64), ("p3p", 0.4, 256), ("dlt", 0.85, 64)])
def test_ransac_pnp_matches(solver, inlier_frac, nh):
    R, t, X, uv, w, valid, bad = problem(1, inlier_frac=inlier_frac)
    key = jax.random.PRNGKey(3)
    jr = jpnp.ransac_pnp(key, jnp.asarray(K), jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w),
                         jnp.asarray(valid), n_hypotheses=nh, solver=solver)
    noise = T(np.array(jax.random.uniform(key, (nh, len(X)))))
    tr = tpnp.ransac_pnp(noise, T(K), T(X), T(uv), T(w), T(valid), solver=solver)
    assert bool(jr.success) and bool(tr.success)
    assert int(tr.n_inliers) == int(jr.n_inliers)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    np.testing.assert_array_equal(tr.inliers.numpy(), valid & ~bad)  # clean data: exactly the true set
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-3)
    np.testing.assert_allclose(tr.R.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(tr.t.numpy(), t, atol=1e-3)


def test_minimal_sets_and_hypotheses_match():
    """The port draws the JAX solver's minimal sets, and its P3P hypotheses
    (seed-major over 4 scale seeds) agree where the Newton runs converged."""
    _, _, X, uv, w, valid, _ = problem(2, inlier_frac=1.0)
    nh = 32
    noise = np.array(jax.random.uniform(jax.random.PRNGKey(5), (nh, len(X))))
    masked = np.where(valid[None], noise, -1.0).astype(np.float32)
    jsets = np.asarray(jax.lax.top_k(jnp.asarray(masked), 3)[1])
    tsets = torch.topk(T(masked), 3, dim=-1).indices
    np.testing.assert_array_equal(tsets.numpy(), jsets)
    uvn = (uv - K[:2, 2]) / K[:2, :2].diagonal()
    rays = np.concatenate([uvn, np.ones((len(X), 1), np.float32)], -1)
    rays = (rays / np.linalg.norm(rays, axis=-1, keepdims=True)).astype(np.float32)
    jR, jt = jpnp._p3p_pose(jnp.asarray(X), jnp.asarray(rays), jnp.asarray(jsets))
    tR, tt = tpnp._p3p_pose(T(X), T(rays), tsets)
    jR, jt = np.asarray(jR), np.asarray(jt)
    assert tR.shape == jR.shape == (4 * nh, 3, 3)
    ok = np.isfinite(jt).all(-1) & np.isfinite(tt.numpy()).all(-1)
    assert ok.mean() > 0.9
    close = np.abs(tR.numpy()[ok] - jR[ok]).max((-1, -2)) < 1e-2
    assert close.mean() > 0.95  # ill-conditioned triples may settle on different branches


def test_dlt_pose_matches_on_all_points():
    R, t, X, uv, w, valid, _ = problem(3, inlier_frac=1.0, noise_px=0.3)
    uvn = ((uv - K[:2, 2]) / K[:2, :2].diagonal()).astype(np.float32)
    wt = valid.astype(np.float32)
    jR, jt = jpnp._dlt_pose(jnp.asarray(X), jnp.asarray(uvn), jnp.asarray(wt))
    tR, tt = tpnp._dlt_pose(T(X), T(uvn), T(wt))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(tR.numpy(), R, atol=5e-3)


def test_ransac_pnp_multi_matches():
    """Three candidates, one of them with wrong 3D points; the reference pads
    its noise to a fixed width, the port takes the first N columns."""
    R, t, X, uv, w, valid, bad = problem(4, n=120, inlier_frac=0.5)
    rng = np.random.default_rng(9)
    C, n, nh, pad = 3, len(X), 256, 136
    Xs = np.stack([X, X + rng.normal(0, 2.0, X.shape).astype(np.float32), X])
    key = jax.random.PRNGKey(11)

    def padded(a, fill=0):
        out = np.full((C, pad) + a.shape[2:], fill, a.dtype)
        out[:, :n] = a
        return out

    bc = lambda a: np.broadcast_to(a, (C,) + a.shape).copy()  # noqa: E731
    jr = jpnp.ransac_pnp_multi(key, jnp.asarray(K), jnp.asarray(padded(Xs)),
                               jnp.asarray(padded(bc(uv))), jnp.asarray(padded(bc(w), 1)),
                               jnp.asarray(padded(bc(valid), False)))
    keys = jax.random.split(key, C)
    noise = np.stack([np.array(jax.random.uniform(k, (nh, pad))) for k in keys])[:, :, :n]
    tr = tpnp.ransac_pnp_multi(T(noise), T(K), T(Xs), T(bc(uv)), T(bc(w)), T(bc(valid)))
    np.testing.assert_array_equal(tr.success.numpy(), np.asarray(jr.success))
    np.testing.assert_array_equal(tr.success.numpy(), [True, False, True])
    np.testing.assert_array_equal(tr.n_inliers.numpy(), np.asarray(jr.n_inliers))
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers)[:, :n])
    for c in (0, 2):
        np.testing.assert_allclose(tr.R[c].numpy(), np.asarray(jr.R[c]), atol=1e-3)
        np.testing.assert_allclose(tr.t[c].numpy(), np.asarray(jr.t[c]), atol=1e-3)
        np.testing.assert_allclose(tr.R[c].numpy(), R, atol=1e-3)
