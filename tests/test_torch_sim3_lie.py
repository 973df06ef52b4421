"""Port parity of the Sim(3) half of ops/lie.py (and se3_log, se3_to_matrix,
quat_to_rot): the same numpy inputs through the JAX functions and the port's,
outputs within 1e-5 absolute (both are float32; near-pi logs excluded by the
sampled ranges)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import lie as jlie
from ceres_mono_orb_slam2_tpu_torch.ops import lie as tlie

torch.set_num_threads(2)
TOL = 1e-5


def T(a):
    return torch.from_numpy(np.asarray(a))


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=0)


def tangents(scale_w, scale_s, n=64, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((n, 7)).astype(np.float32)
    xi[:, 3:6] *= scale_w
    xi[:, 6] *= scale_s
    return xi


# the three regimes of _sim3_W: small/small, small angle + large sigma, large angle
REGIMES = [(0.01, 0.01), (0.02, 0.5), (0.8, 0.02), (0.8, 0.5), (1e-6, 1e-6)]


@pytest.mark.parametrize("scale_w,scale_s", REGIMES)
def test_sim3_exp_matches(scale_w, scale_s):
    xi = tangents(scale_w, scale_s)
    for t, j in zip(tlie.sim3_exp(T(xi)), jlie.sim3_exp(jnp.asarray(xi))):
        close(t, j)
    close(tlie._sim3_W(T(xi[:, 3:6]), T(xi[:, 6])),
          jlie._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])))


@pytest.mark.parametrize("scale_w,scale_s", REGIMES)
def test_sim3_exp_log_round_trip(scale_w, scale_s):
    xi = tangents(scale_w, scale_s, seed=1)
    R, t, s = tlie.sim3_exp(T(xi))
    back = tlie.sim3_log(R, t, s)
    close(back, jlie.sim3_log(*jlie.sim3_exp(jnp.asarray(xi))), 2e-5)
    np.testing.assert_allclose(back.numpy(), xi, atol=2e-4, rtol=0)


def test_sim3_compose_inverse_apply():
    xa, xb = tangents(0.5, 0.3, seed=2), tangents(0.5, 0.3, seed=3)
    x = np.random.default_rng(4).standard_normal((64, 3)).astype(np.float32)
    ta, tb = tlie.sim3_exp(T(xa)), tlie.sim3_exp(T(xb))
    ja, jb = jlie.sim3_exp(jnp.asarray(xa)), jlie.sim3_exp(jnp.asarray(xb))
    for t, j in zip(tlie.sim3_compose(*ta, *tb), jlie.sim3_compose(*ja, *jb)):
        close(t, j)
    for t, j in zip(tlie.sim3_inverse(*ta), jlie.sim3_inverse(*ja)):
        close(t, j)
    close(tlie.sim3_apply(*ta, T(x)), jlie.sim3_apply(*ja, jnp.asarray(x)))
    # S * S^-1 = identity
    R, t, s = tlie.sim3_compose(*ta, *tlie.sim3_inverse(*ta))
    np.testing.assert_allclose(R.numpy(), np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-5)


def test_sim3_adjoint_ad_and_jacobian():
    xi = tangents(0.5, 0.3, seed=5)
    ts, js = tlie.sim3_exp(T(xi)), jlie.sim3_exp(jnp.asarray(xi))
    close(tlie.sim3_adjoint(*ts), jlie.sim3_adjoint(*js))
    close(tlie.sim3_ad(T(xi)), jlie.sim3_ad(jnp.asarray(xi)))
    close(tlie.sim3_right_jacobian_inv_approx(T(xi)),
          jlie.sim3_right_jacobian_inv_approx(jnp.asarray(xi)))
    # the adjoint's defining property on a small tangent: S exp(x) S^-1 = exp(Adj x)
    x = 1e-2 * tangents(1.0, 1.0, seed=6)
    lhs = tlie.sim3_compose(*tlie.sim3_compose(*ts, *tlie.sim3_exp(T(x))), *tlie.sim3_inverse(*ts))
    rhs = tlie.sim3_exp((tlie.sim3_adjoint(*ts) @ T(x)[..., None])[..., 0])
    for a, b in zip(lhs, rhs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_se3_log_matrix_and_quaternion():
    rng = np.random.default_rng(7)
    xi = (rng.standard_normal((64, 6)) * 0.7).astype(np.float32)
    tR, tt = tlie.se3_exp(T(xi))
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    close(tlie.se3_log(tR, tt), jlie.se3_log(jR, jt), 2e-5)
    np.testing.assert_allclose(tlie.se3_log(tR, tt).numpy(), xi, atol=1e-4)
    close(tlie.se3_to_matrix(tR, tt), jlie.se3_to_matrix(jR, jt))
    q = rng.standard_normal((64, 4)).astype(np.float32)
    close(tlie.quat_to_rot(T(q)), jlie.quat_to_rot(jnp.asarray(q)))
    close(tlie.quat_to_rot(tlie.rot_to_quat(tR)), jR, 2e-5)
