"""Port parity of the dp x mp tracking step (parallel/multistream.py
`shard_step_over_mesh`) on a (2, 2) mesh of 4 gloo ranks.

At the JAX package's multi-chip dry run shapes (`__graft_entry__.py`:
96x128 images, 128 features, 3 levels, 4 streams, 512 map points) the
port's sharded step runs on 4 CPU processes (streams over `dp`, map points
over `mp`, one spawned group for the cases of this file) on the JAX
package's `synthetic_stream_state`, and is held against the JAX package's
`shard_step_over_mesh` on a (2, 2) JAX mesh (counts equal; R within 5e-4, t
within 2e-3, the tolerances of tests/test_torch_multistream.py, where the
two extractors put level >= 1 keypoints on slightly different pixels, or
within the two packages' unsharded difference where that is larger: at
19-31 matches a stream one stream's pose moves 1.3e-3 / 1.1e-2 with them)
and against the port's unsharded step (counts equal, R within 1e-5, t
within 1e-4). The split matcher (`search_by_projection_points_local`, then
the argmin combine over `mp`) equals `resolve_duplicate_targets` over all
the points to the bit, ties included. About 35 s alone.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ceres_mono_orb_slam2_tpu.parallel import multistream as jms
from ceres_mono_orb_slam2_tpu.utils.config import ORBConfig, SlamConfig
from ceres_mono_orb_slam2_tpu_torch.ops import matcher
from ceres_mono_orb_slam2_tpu_torch.parallel import mesh as tmesh
from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as tms
from ceres_mono_orb_slam2_tpu_torch.utils.convert import (
    config_from_reference, stream_state_from_reference)

torch.set_num_threads(2)
DPMP = ((2, 2), ("dp", "mp"))
H, W, S, N_MAP = 96, 128, 4, 512


def _ties(rng):
    """Duplicate-resolution inputs with many claims per target and many
    equal distances: 2 streams x 64 queries on 20 targets."""
    best_idx = rng.integers(0, 20, (2, 64))
    best_val = rng.integers(0, 4, (2, 64)).astype(np.int32)
    valid = rng.random((2, 64)) < 0.8
    return best_idx, best_val, valid


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = SlamConfig(orb=ORBConfig(n_features=128, n_levels=3))
    images, jstate = jms.synthetic_stream_state(cfg, S, N_MAP, h=H, w=W)
    devices = np.array(jax.devices()[:4]).reshape(2, 2)
    jmesh = Mesh(devices, ("dp", "mp"))
    jstep, img_s, state_s = jms.shard_step_over_mesh(cfg, H, W, jmesh)
    with jmesh:
        jres = jstep(jax.device_put(images, img_s),
                     jax.tree_util.tree_map(jax.device_put, jstate, state_s))
        jres = jax.tree_util.tree_map(np.asarray, jres)
        jun = jms.make_multistream_step(cfg, H, W)(images, jstate)
    tcfg = config_from_reference(cfg)
    tstate = stream_state_from_reference(jstate)
    ties = _ties(np.random.default_rng(0))
    calls = [(tms.step_over_mesh, *DPMP, (tcfg, H, W, np.asarray(images),
                                          tms.StreamState(*(a.numpy() for a in tstate))), {}),
             (tms.resolve_duplicate_targets_over_mesh, *DPMP, ("mp",) + ties + (20,), {})]
    ranks = tmesh.spawn(tmesh.run_calls, 4, backend="gloo", device="cpu", args=(calls,),
                        timeout_s=240, store_dir=tmp_path_factory.mktemp("store"), num_threads=2)
    unsharded = tms.make_multistream_step(tcfg, H, W, device="cpu")(np.asarray(images), tstate)
    return dict(jax=jres, jax_unsharded=jax.tree_util.tree_map(np.asarray, jun),
                ranks=[[step[0], won] for (step, _), (won, _) in ranks], unsharded=unsharded,
                ties=ties)


def test_every_rank_returns_the_full_result(runs):
    first = runs["ranks"][0]
    assert first[0].Rcw.shape == (S, 3, 3) and first[0].n_matches.shape == (S,)
    for other in runs["ranks"][1:]:
        for a, b in zip(first, other):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("want", ["jax", "unsharded"])
def test_sharded_step_matches(runs, want):
    """Counts equal. Against the port's unsharded step: R within 1e-5, t
    within 1e-4. Against the JAX package's sharded step: R within 5e-4 and t
    within 2e-3, except where the two packages' unsharded steps already
    differ by more (at 19-31 matches a stream, one keypoint of level >= 1
    on another pixel moves a pose by ~1e-3 in R and ~1e-2 in t): there
    within that difference plus the unsharded tolerances."""
    got = runs["ranks"][0][0]
    ref = type(got)(*(np.asarray(a) for a in runs[want]))
    assert (ref.n_matches > 10).all(), ref.n_matches  # the search really matches
    np.testing.assert_array_equal(got.n_matches, ref.n_matches)
    np.testing.assert_array_equal(got.n_inliers, ref.n_inliers)
    if want == "unsharded":
        np.testing.assert_allclose(got.Rcw, ref.Rcw, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.tcw, ref.tcw, rtol=0, atol=1e-4)
        return
    jun, tun = runs["jax_unsharded"], runs["unsharded"]
    for name, atol, tight in (("Rcw", 5e-4, 1e-5), ("tcw", 2e-3, 1e-4)):
        apart = np.abs(getattr(tun, name).numpy() - getattr(jun, name))
        bound = np.maximum(atol, apart + tight)
        assert (np.abs(getattr(got, name) - getattr(ref, name)) <= bound).all(), name


def test_split_matcher_equals_the_whole(runs):
    """The argmin combine over `mp` of each rank's half of the queries
    keeps exactly the queries `resolve_duplicate_targets` keeps over all of
    them: the smallest distance, the lowest query index on ties."""
    best_idx, best_val, valid = (torch.as_tensor(a) for a in runs["ties"])
    want = matcher.resolve_duplicate_targets(best_idx, best_val, valid, 20).numpy()
    got = runs["ranks"][0][1]
    np.testing.assert_array_equal(got, want)
    # the inputs hold contested targets, some of them tied at the least distance
    idx, val, ok = runs["ties"]
    tied = 0
    for s in range(2):
        for t in range(20):
            claims = val[s][ok[s] & (idx[s] == t)]
            tied += int(len(claims) > 1 and (claims == claims.min()).sum() > 1)
    assert 0 < want.sum() < valid.sum() and tied > 0


def test_unsharded_search_is_local_part_then_resolution(rng):
    """search_by_projection_points is its local part followed by
    resolve_duplicate_targets, to the bit (the split changes nothing
    without a mesh)."""
    N, M = 80, 120
    kp_xy = torch.as_tensor(rng.uniform(0, 60, (N, 2)).astype(np.float32))
    kp_oct = torch.as_tensor(rng.integers(0, 3, N))
    kp_bits = torch.as_tensor(rng.choice([-1.0, 1.0], (N, 256)).astype(np.float32))
    kp_valid = torch.as_tensor(rng.random(N) < 0.9)
    src = torch.as_tensor(rng.integers(0, N, M))  # 120 points on 80 keypoints: shared
    pr_uv = kp_xy[src] + torch.as_tensor(rng.normal(0, 1, (M, 2)).astype(np.float32))
    pr_level = kp_oct[src]
    pr_viewcos = torch.as_tensor(rng.uniform(0.99, 1.0, M).astype(np.float32))
    pr_bits = kp_bits[src].clone()
    pr_valid = torch.as_tensor(rng.random(M) < 0.9)
    scales = torch.tensor([1.0, 1.2, 1.44])
    args = (kp_xy, kp_oct, kp_bits, kp_valid, torch.ones_like(kp_valid), pr_uv, pr_level,
            pr_viewcos, pr_bits, pr_valid, scales, 3.0)
    idx, val, ok = matcher.search_by_projection_points(*args)
    lidx, lval, lok = matcher.search_by_projection_points_local(*args)
    assert torch.equal(idx, lidx) and torch.equal(val, lval)
    assert torch.equal(ok, matcher.resolve_duplicate_targets(lidx, lval, lok, N))
    assert 0 < int(ok.sum()) < int(lok.sum())  # duplicates were resolved
