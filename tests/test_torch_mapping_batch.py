"""Port parity: ops/mapping_batch.py (the batched triangulation against B
covisible neighbours and the forward fuse into B target keyframes) against
the JAX package's vmapped functions, on one seeded scene seen by a current
keyframe and B = 3 others (N = 256 keypoints each, one a landmark, its
descriptor a noisy copy of the landmark's; a tenth of the keypoints not
free).

Tolerances, with their reasons:
- match indices, `good` and `valid`: bit-exact. Hamming distances are exact
  in f32, and the scene keeps every gate (epipolar distance, reprojection
  chi2, parallax, scale ratio, search window) far from its threshold.
- the triangulated points X, where `good`: 1e-4 relative. Both packages
  solve the same 4x4 DLT normal matrices with their own f32 eigensolvers.

The port's neighbour / target axis is native (no loop over it): each slice of
a batched call equals the B = 1 call of that neighbour or target to the bit
on the CPU. About 10 s on two threads (the JAX CPU compiles)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import lie as jlie, mapping_batch as jmb
from ceres_mono_orb_slam2_tpu_torch.ops import mapping_batch as tmb

torch.set_num_threads(2)
N, B = 256, 3
FX, CX, CY = 500.0, 320.0, 240.0
K = np.array([[FX, 0, CX], [0, FX, CY], [0, 0, 1]], np.float32)
SCALE_FACTOR, N_LEVELS = 1.2, 8
SCALES = (SCALE_FACTOR ** np.arange(N_LEVELS)).astype(np.float32)
LEVEL_SIGMA2 = (SCALES ** 2).astype(np.float32)


def _pose(xi):
    R, t = jlie.se3_exp(jnp.asarray(np.asarray(xi, np.float32)))
    return np.asarray(R), np.asarray(t)


def _flip(rng, desc, n_bits):
    d = desc.copy()
    for i in range(len(d)):
        for b in rng.choice(256, n_bits, replace=False):
            d[i, b // 8] ^= np.uint8(1 << (b % 8))
    return d


def _keyframe(rng, R, t, X, desc, order):
    """Keypoints of landmarks X seen from (R, t) in the slot order `order`,
    0.3 px noise, octave 0 or 1, angles near 0.3 rad, 3 flipped bits."""
    Xc = X[order] @ R.T + t
    xy = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FX * Xc[:, 1] / Xc[:, 2] + CY], -1)
    xy = (xy + rng.normal(0, 0.3, xy.shape)).astype(np.float32)
    return dict(xy=xy, oct=rng.integers(0, 2, N).astype(np.int32),
                ang=(0.3 + rng.normal(0, 0.02, N)).astype(np.float32),
                desc=_flip(rng, desc[order], 3), Xc=Xc)


def _scene(seed: int = 0):
    """The current keyframe, B neighbours along a sideways baseline, the
    landmarks and their descriptors."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2.5, 2.5, N), rng.uniform(-1.8, 1.8, N),
                  rng.uniform(5.0, 9.0, N)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    R1, t1 = _pose([0.0] * 6)
    kf1 = _keyframe(rng, R1, t1, X, desc, np.arange(N))
    nbs = []
    for b in range(B):
        R, t = _pose([-0.25 * (b + 1), 0.03 * b, 0.0, 0.0, 0.02 * (b + 1), 0.0])
        nbs.append(_keyframe(rng, R, t, X, desc, rng.permutation(N)) | dict(R=R, t=t))
    free1 = rng.random(N) > 0.1
    free2 = np.stack([rng.random(N) > 0.1 for _ in range(B)])
    return X, desc, (R1, t1, kf1, free1), (nbs, free2)


def _tri_args(scene):
    _, _, (R1, t1, kf1, free1), (nbs, free2) = scene
    st = lambda key: np.stack([nb[key] for nb in nbs])  # noqa: E731
    invK = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    return ((K, invK, R1, t1, kf1["xy"], kf1["oct"], kf1["ang"], kf1["desc"], free1,
             st("R"), st("t"), st("xy"), st("oct"), st("ang"), st("desc"), free2),
            (LEVEL_SIGMA2, SCALES, np.float32(1.5 * SCALE_FACTOR)))


@pytest.fixture(scope="module")
def scene():
    return _scene()


def test_triangulate_with_neighbors_matches_jax(scene):
    head, tail = _tri_args(scene)
    j = jmb.triangulate_with_neighbors(*(jnp.asarray(a) for a in head), jnp.ones(B, bool),
                                       *(jnp.asarray(a) for a in tail))
    t = tmb.triangulate_with_neighbors(*(torch.tensor(a) for a in head + tail[:2]), float(tail[2]))
    idx_j, good_j, X_j = (np.asarray(a) for a in j)
    idx_t, good_t, X_t = (a.numpy() for a in t)
    assert idx_t.shape == (B, N) and X_t.shape == (B, N, 3)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(good_t, good_j)
    assert good_t.sum() >= B * N // 2  # the gates pass most of the scene
    np.testing.assert_allclose(X_t[good_t], X_j[good_j], rtol=1e-4, atol=0)


def test_triangulate_each_neighbour_alone_equals_the_batch(scene):
    head, tail = _tri_args(scene)
    T = [torch.tensor(a) for a in head + tail[:2]]
    batch = tmb.triangulate_with_neighbors(*T, float(tail[2]))
    for b in range(B):
        one = [a[b:b + 1] if i >= 9 else a for i, a in enumerate(T[:16])] + T[16:]
        alone = tmb.triangulate_with_neighbors(*one, float(tail[2]))
        for x, y in zip(batch, alone):
            assert torch.equal(x[b:b + 1], y)


def _fuse_args(scene):
    """The current keyframe's landmarks, moved 5 mm, as the map-point block
    fused into the B neighbours (a third of them already observed there)."""
    X, desc, _, (nbs, _) = scene
    rng = np.random.default_rng(7)
    pos = (X + rng.normal(0, 0.005, X.shape)).astype(np.float32)
    normal = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    dist = np.linalg.norm(pos, axis=-1)
    mvalid = np.stack([rng.random(N) > 0.33 for _ in range(B)])
    st = lambda key: np.stack([nb[key] for nb in nbs])  # noqa: E731
    kp_valid = np.stack([rng.random(N) > 0.05 for _ in range(B)])
    bounds = np.array([0.0, 640.0, 0.0, 480.0], np.float32)
    return ((K, st("R"), st("t"), st("xy"), st("oct"), st("desc"), kp_valid, pos, normal,
             (0.5 * dist).astype(np.float32), (1.1 * dist).astype(np.float32),
             _flip(rng, desc, 2), mvalid),
            (float(np.log(SCALE_FACTOR)), N_LEVELS), (SCALES, (1.0 / LEVEL_SIGMA2).astype(np.float32),
                                                     bounds))


def test_fuse_into_targets_matches_jax(scene):
    head, (log_scale, n_levels), (sf, ils2, bounds) = _fuse_args(scene)
    for box in (None, bounds):
        j = jmb.fuse_into_targets(*(jnp.asarray(a) for a in head), log_scale, n_levels,
                                  jnp.asarray(sf), jnp.asarray(ils2),
                                  bounds=None if box is None else jnp.asarray(box))
        t = tmb.fuse_into_targets(*(torch.tensor(a) for a in head), log_scale, n_levels,
                                  torch.as_tensor(sf), torch.as_tensor(ils2),
                                  bounds=None if box is None else torch.as_tensor(box))
        assert t[0].shape == (B, N)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        assert int(t[1].sum()) >= N  # most unobserved points find their keypoint


def test_fuse_each_target_alone_equals_the_batch(scene):
    head, (log_scale, n_levels), (sf, ils2, _) = _fuse_args(scene)
    T = [torch.tensor(a) for a in head]
    batch = tmb.fuse_into_targets(*T, log_scale, n_levels, torch.as_tensor(sf), torch.as_tensor(ils2))
    per_target = (1, 2, 3, 4, 5, 6, 12)  # the arguments with a target axis
    for b in range(B):
        one = [a[b:b + 1] if i in per_target else a for i, a in enumerate(T)]
        alone = tmb.fuse_into_targets(*one, log_scale, n_levels, torch.as_tensor(sf),
                                      torch.as_tensor(ils2))
        for x, y in zip(batch, alone):
            assert torch.equal(x[b:b + 1], y)
