"""Port parity: ops/lie.py (SO(3)/SE(3) subset) and ops/camera.py against the
JAX package on the same numpy inputs.

Tolerance: rtol 1e-5 with atol 1e-6, the float32 resolution of these
closed-form expressions (XLA and PyTorch may order the few multiply-adds of
each entry differently and use transcendental implementations that differ
in the last ulp)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import camera as jcam, lie as jlie
from ceres_mono_orb_slam2_tpu_torch.ops import camera as tcam, lie as tlie

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _tangents(rng, n, dim):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    rot = x[:, -3:] if dim == 3 else x[:, 3:6]
    norm = np.linalg.norm(rot, axis=-1, keepdims=True)
    rot *= np.minimum(1.0, 2.8 / np.maximum(norm, 1e-9))
    rot[:4] *= 1e-9  # exercise the small-angle branches
    return x


def _both(fn_j, fn_t, *arrays):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays))
    out_t = fn_t(*(torch.tensor(np.asarray(a)) for a in arrays))
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [np.asarray(a) for a in out_j], [b.numpy() for b in out_t]


@pytest.mark.parametrize("name", ["hat", "so3_exp", "so3_left_jacobian", "se3_exp"])
def test_tangent_maps(rng, name):
    dim = 6 if name == "se3_exp" else 3
    x = _tangents(rng, 64, dim)
    js, ts = _both(getattr(jlie, name), getattr(tlie, name), x)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b, a, **TOL)


def test_group_ops(rng):
    R = np.asarray(jlie.so3_exp(jnp.asarray(_tangents(rng, 32, 3))))
    t = rng.standard_normal((32, 3)).astype(np.float32)
    R2 = np.asarray(jlie.so3_exp(jnp.asarray(_tangents(rng, 32, 3))))
    t2 = rng.standard_normal((32, 3)).astype(np.float32)
    for fj, ft, args in [(jlie.vee, tlie.vee, (R,)),
                         (jlie.so3_log, tlie.so3_log, (R,)),
                         (jlie.rot_to_quat, tlie.rot_to_quat, (R,)),
                         (jlie.se3_inverse, tlie.se3_inverse, (R, t)),
                         (jlie.se3_compose, tlie.se3_compose, (R, t, R2, t2))]:
        js, ts = _both(fj, ft, *args)
        for a, b in zip(js, ts):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=2e-6)


def test_so3_project(rng):
    R = np.asarray(jlie.so3_exp(jnp.asarray(_tangents(rng, 32, 3))))
    R = R + rng.standard_normal(R.shape).astype(np.float32) * 1e-3  # drifted
    js, ts = _both(jlie.so3_project, tlie.so3_project, R)
    np.testing.assert_allclose(ts[0], js[0], **TOL)


def test_camera(rng):
    K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
    dist = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633], np.float32)
    xyz = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-2, 2, 200),
                    rng.uniform(2, 9, 200)], -1).astype(np.float32)
    js, ts = _both(jcam.project, tcam.project, K, xyz)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-4)  # ~1e-5 relative of ~500 px
    xy = rng.uniform(-0.4, 0.4, (200, 2)).astype(np.float32)
    js, ts = _both(jcam.distort_normalized, tcam.distort_normalized, xy, dist)
    np.testing.assert_allclose(ts[0], js[0], **TOL)
    uv = xy * np.array([520.9, 521.0], np.float32) + np.array([325.1, 249.7], np.float32)
    js, ts = _both(jcam.undistort_points, tcam.undistort_points, uv, K, dist)
    np.testing.assert_allclose(ts[0], js[0], rtol=1e-5, atol=1e-3)  # 8 fixed-point iterations
