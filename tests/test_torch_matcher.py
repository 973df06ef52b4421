"""Port parity: ops/matcher.py against the JAX package on random
descriptors, with deliberate ties (duplicated descriptors, equal distances).

Every output here is discrete and every intermediate exact (Hamming distance
as a {-1, +1} f32 product is exact), so indices, distances and validity
masks must be bit-exact."""

import numpy as np
import jax.numpy as jnp
import torch

from ceres_mono_orb_slam2_tpu.ops import matcher as jm
from ceres_mono_orb_slam2_tpu_torch.ops import matcher as tm

torch.set_num_threads(2)


def _desc(rng, n, base=None, flips=0):
    if base is None:
        return rng.integers(0, 256, (n, 32), dtype=np.uint8)
    d = base.copy()
    for i in range(n):
        bits = rng.choice(256, flips, replace=False)
        for b in bits:
            d[i, b // 8] ^= np.uint8(1 << (b % 8))
    return d


def _frame(rng, n, h=480, w=640, desc=None):
    return dict(xy=rng.uniform(0, [w, h], (n, 2)).astype(np.float32),
                oct=rng.integers(0, 4, n).astype(np.int32),
                ang=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
                desc=_desc(rng, n) if desc is None else desc,
                valid=rng.random(n) > 0.1)


def _assert_same(out_j, out_t):
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _pair(rng, n=300):
    """Two frames whose descriptors are noisy copies of one another, with
    exact duplicates (ties) among the targets."""
    f1 = _frame(rng, n)
    d2 = _desc(rng, n, f1["desc"], flips=6)
    d2[n // 2:n // 2 + 20] = d2[n // 2 + 20:n // 2 + 40]  # duplicate targets
    f2 = _frame(rng, n, desc=d2)
    f2["xy"] = (f1["xy"] + rng.normal(0, 3, (n, 2))).astype(np.float32)
    f2["oct"] = f1["oct"].copy()
    f2["ang"] = (f1["ang"] + 0.1).astype(np.float32)
    return f1, f2


def test_hamming_and_top2(rng):
    a, b = _desc(rng, 90), _desc(rng, 120)
    b[60:70] = b[50:60]
    dj = jm.hamming_matrix(jm.unpack_bits_pm1(jnp.asarray(a)), jm.unpack_bits_pm1(jnp.asarray(b)))
    dt = tm.hamming_matrix(tm.unpack_bits_pm1(torch.as_tensor(a)), tm.unpack_bits_pm1(torch.as_tensor(b)))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    mask = rng.random(dj.shape) > 0.3
    _assert_same(jm.masked_top2(dj, jnp.asarray(mask)), tm.masked_top2(dt, torch.as_tensor(mask)))


def test_resolve_and_rotation(rng):
    n = 200
    best_idx = rng.integers(0, 40, n)
    best_val = rng.integers(0, 5, n).astype(np.int32)  # many equal distances
    valid = rng.random(n) > 0.2
    np.testing.assert_array_equal(
        tm.resolve_duplicate_targets(torch.as_tensor(best_idx), torch.as_tensor(best_val),
                                     torch.as_tensor(valid), 40).numpy(),
        np.asarray(jm.resolve_duplicate_targets(jnp.asarray(best_idx), jnp.asarray(best_val),
                                                jnp.asarray(valid), 40)))
    aq = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    at = (aq - rng.choice([0.2, 0.21, 1.5, 3.0], n)).astype(np.float32)  # tied bins
    np.testing.assert_array_equal(
        tm.rotation_consistency_mask(torch.as_tensor(aq), torch.as_tensor(at), torch.as_tensor(valid)).numpy(),
        np.asarray(jm.rotation_consistency_mask(jnp.asarray(aq), jnp.asarray(at), jnp.asarray(valid))))


def test_search_entry_points(rng):
    f1, f2 = _pair(rng)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    sf = np.float32(1.2) ** np.arange(8, dtype=np.float32)
    ls2 = sf ** 2
    bj1, bj2 = jm.unpack_bits_pm1(J(f1["desc"])), jm.unpack_bits_pm1(J(f2["desc"]))
    bt1, bt2 = tm.unpack_bits_pm1(T(f1["desc"])), tm.unpack_bits_pm1(T(f2["desc"]))
    n = len(f1["xy"])

    oct0 = np.zeros(n, np.int32)
    _assert_same(
        jm.search_for_initialization(J(f1["xy"]), J(f1["ang"]), bj1, J(f1["valid"]), J(oct0),
                                     J(f2["xy"]), J(f2["ang"]), bj2, J(f2["valid"]), J(oct0)),
        tm.search_for_initialization(T(f1["xy"]), T(f1["ang"]), bt1, T(f1["valid"]), T(oct0),
                                     T(f2["xy"]), T(f2["ang"]), bt2, T(f2["valid"]), T(oct0)))
    for th in (15.0, 30.0):
        _assert_same(
            jm.search_by_projection_frame(J(f2["xy"]), J(f2["oct"]), J(f2["ang"]), bj2, J(f2["valid"]),
                                          J(f1["xy"]), J(f1["oct"]), J(f1["ang"]), bj1, J(f1["valid"]),
                                          J(sf), th=th),
            tm.search_by_projection_frame(T(f2["xy"]), T(f2["oct"]), T(f2["ang"]), bt2, T(f2["valid"]),
                                          T(f1["xy"]), T(f1["oct"]), T(f1["ang"]), bt1, T(f1["valid"]),
                                          T(sf), th=th))
    viewcos = rng.choice([0.999, 0.9], n).astype(np.float32)
    free = rng.random(n) > 0.2
    _assert_same(
        jm.search_by_projection_points(J(f2["xy"]), J(f2["oct"]), bj2, J(f2["valid"]), J(free),
                                       J(f1["xy"]), J(f1["oct"]), J(viewcos), bj1, J(f1["valid"]),
                                       J(sf), th=3.0),
        tm.search_by_projection_points(T(f2["xy"]), T(f2["oct"]), bt2, T(f2["valid"]), T(free),
                                       T(f1["xy"]), T(f1["oct"]), T(viewcos), bt1, T(f1["valid"]),
                                       T(sf), th=3.0))
    _assert_same(
        jm.search_by_descriptor(J(f1["ang"]), bj1, J(f1["valid"]), J(f2["ang"]), bj2, J(f2["valid"])),
        tm.search_by_descriptor(T(f1["ang"]), bt1, T(f1["valid"]), T(f2["ang"]), bt2, T(f2["valid"])))
    for gate in (None, 1.0 / ls2):
        _assert_same(
            jm.search_fuse(J(f2["xy"]), J(f2["oct"]), bj2, J(f2["valid"]), J(f1["xy"]),
                           J(f1["oct"]), bj1, J(f1["valid"]), J(sf),
                           inv_level_sigma2=None if gate is None else J(gate)),
            tm.search_fuse(T(f2["xy"]), T(f2["oct"]), bt2, T(f2["valid"]), T(f1["xy"]),
                           T(f1["oct"]), bt1, T(f1["valid"]), T(sf),
                           inv_level_sigma2=None if gate is None else T(gate)))
    # epipolar search under a pure x-translation: horizontal epipolar lines
    F12 = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32) / 500.0
    ep2 = np.array([1e5, 240.0], np.float32)
    _assert_same(
        jm.search_for_triangulation(J(f1["xy"]), J(f1["oct"]), J(f1["ang"]), bj1, J(f1["valid"]),
                                    J(f2["xy"]), J(f2["oct"]), J(f2["ang"]), bj2, J(f2["valid"]),
                                    J(F12), J(ep2), J(ls2), J(sf)),
        tm.search_for_triangulation(T(f1["xy"]), T(f1["oct"]), T(f1["ang"]), bt1, T(f1["valid"]),
                                    T(f2["xy"]), T(f2["oct"]), T(f2["ang"]), bt2, T(f2["valid"]),
                                    T(F12), T(ep2), T(ls2), T(sf)))
