"""Port parity of the sharded solvers (parallel/sharded_ba.py) on 4 gloo ranks.

The port's `bundle_adjustment_cg_sharded` and
`optimize_essential_graph_sharded` run on 4 CPU processes under
torch.distributed (gloo, started by `parallel.mesh.spawn`, one spawned group
for the cases of this file), the observation / edge axis split over a
4-rank mesh axis, on the inputs of tests/test_sharded_ba.py (P=6, M=300,
O=1504 with 7 padded rows; the ring of 24 Sim(3) poses). They are held
against the JAX package's sharded functions on a 4-device JAX mesh and
against the port's single-process solve, at the JAX test's tolerances
(R 5e-4, t 5e-3, points 2e-2, s 1e-3; inlier masks equal). The sums reduce
in another order across ranks, so tolerances, not bits; every rank returns
the same bits. About 35-45 s alone.
"""

import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ceres_mono_orb_slam2_tpu.ops import lie as jlie
from ceres_mono_orb_slam2_tpu.parallel import sharded_ba as jsb
from ceres_mono_orb_slam2_tpu_torch.ops import optim, sim3opt
from ceres_mono_orb_slam2_tpu_torch.parallel import mesh as tmesh
from ceres_mono_orb_slam2_tpu_torch.parallel import sharded_ba as tsb
from tests.test_sharded_ba import _make_problem
from tests.test_sim3opt import circle_poses, rel_sim3

torch.set_num_threads(2)
N_RANKS = 4
OBS = ((N_RANKS,), ("obs",))
ONE = ((N_RANKS, 1), ("rep", "one"))  # 1-rank groups on the "one" axis
BA_ITERS = dict(iters=15, cg_iters=40, robust=True)
COST_ITERS = dict(iters=20, cg_iters=50, robust=True)


def _ring(rng, P=24):
    """The drifted ring of tests/test_sharded_ba.py: P-1 odometry edges and
    one loop edge, exact measurements, odometry integrated with noise."""
    Rt, tt, st = circle_poses(P)
    ei, ej, Rm, tm, sm = [], [], [], [], []
    for k in range(P):
        j = (k + 1) % P
        Rr, tr, sr = rel_sim3(Rt[k], tt[k], st[k], Rt[j], tt[j], st[j])
        ei.append(k), ej.append(j)
        Rm.append(np.asarray(Rr)), tm.append(np.asarray(tr)), sm.append(float(sr))
    R0, t0, s0 = [Rt[0]], [tt[0]], [1.0]
    for k in range(P - 1):
        noise = rng.standard_normal(7).astype(np.float32) * np.array(
            [0.02] * 3 + [0.01] * 3 + [0.01], np.float32)
        dR, dt, ds = jlie.sim3_exp(jnp.asarray(noise))
        Rn, tn, sn = jlie.sim3_compose(
            dR, dt, ds,
            *jlie.sim3_compose(jnp.asarray(Rm[k]), jnp.asarray(tm[k]), jnp.asarray(sm[k]),
                               jnp.asarray(R0[k]), jnp.asarray(t0[k]),
                               jnp.asarray(np.float32(s0[k]))))
        R0.append(np.asarray(Rn)), t0.append(np.asarray(tn)), s0.append(float(sn))
    fixed = np.zeros(P, bool)
    fixed[0] = True
    args = (np.array(R0), np.array(t0), np.array(s0, np.float32), np.array(ei, np.int32),
            np.array(ej, np.int32), np.array(Rm), np.array(tm), np.array(sm, np.float32),
            np.ones(P, bool), fixed)
    return (tt, st), args


def _reproj_cost(R, t, points, args):
    """Sum of squared pixel errors over the valid observations (the JAX
    test's measure of `test_sharded_cg_improves_cost`)."""
    (_, _, _, _, op, oj, uv, _, valid, _, _) = args
    Xc = np.einsum("oij,oj->oi", R[op], points[oj]) + t[op]
    prj = np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1)
    return float((((uv - prj) ** 2).sum(-1) * valid).sum())


def _torch(args):
    return [torch.as_tensor(a) for a in args]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ba_args = _make_problem(np.random.default_rng(0))
    ring_truth, eg_args = _ring(np.random.default_rng(0))
    cost_args = _make_problem(np.random.default_rng(0), P=8, M=400, O=2000)
    calls = [
        (tsb.bundle_adjustment_cg_sharded, *OBS, ("obs",) + ba_args, BA_ITERS),
        (tsb.optimize_essential_graph_sharded, *OBS, ("obs",) + eg_args, {}),
        (tsb.bundle_adjustment_cg_sharded, *OBS, ("obs",) + cost_args, COST_ITERS),
        (tsb.bundle_adjustment_cg_sharded, *ONE, ("one",) + ba_args, BA_ITERS),
        (tsb.optimize_essential_graph_sharded, *ONE, ("one",) + eg_args, {}),
    ]
    ranks = tmesh.spawn(tmesh.run_calls, N_RANKS, backend="gloo", device="cpu", args=(calls,),
                        timeout_s=240, store_dir=tmp_path_factory.mktemp("store"), num_threads=2)
    ranks = [[res for res, _ in rank] for rank in ranks]
    mesh4 = Mesh(np.array(jax.devices()[:N_RANKS]), ("obs",))
    return dict(
        ba_args=ba_args, eg_args=eg_args, ring_truth=ring_truth, cost_args=cost_args, ranks=ranks,
        jax_ba=jsb.bundle_adjustment_cg_sharded(mesh4, "obs", *ba_args, **BA_ITERS),
        jax_eg=jsb.optimize_essential_graph_sharded(mesh4, "obs", *eg_args),
        single_ba=optim.bundle_adjustment_cg(*_torch(ba_args), **BA_ITERS),
        single_eg=sim3opt.optimize_essential_graph(*_torch(eg_args)))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_every_rank_returns_the_same_bits(runs):
    first = runs["ranks"][0]
    for other in runs["ranks"][1:]:
        for a, b in zip(first, other):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("want", ["jax_ba", "single_ba"])
def test_sharded_cg_matches(runs, want):
    """Against the JAX package's sharded solve and the port's single-process
    one: the JAX test's tolerances, inlier masks equal, and the solve moved
    the state much further than the two differ."""
    got, ref = runs["ranks"][0][0], runs[want]
    _close(got.R, ref.R, 5e-4)
    _close(got.t, ref.t, 5e-3)
    _close(got.points, ref.points, 2e-2)
    np.testing.assert_array_equal(got.inlier_obs, np.asarray(ref.inlier_obs))
    assert got.inlier_obs.shape == (1504,) and not got.inlier_obs[-7:].any()
    assert np.abs(got.t - runs["ba_args"][2]).max() > 1e-2


@pytest.mark.parametrize("want", ["jax_eg", "single_eg"])
def test_sharded_essential_graph_matches(runs, want):
    """The edge-sharded pose graph against the JAX package's sharded solve
    and the port's single-process one, and it closes the ring."""
    got, ref = runs["ranks"][0][1], runs[want]
    _close(got.R, ref.R, 5e-4)
    _close(got.t, ref.t, 5e-3)
    _close(got.s, ref.s, 1e-3)
    tt, st = runs["ring_truth"]
    assert np.abs(runs["eg_args"][1] - tt).max() > 0.1
    assert np.abs(got.t - tt).max() < 0.02
    assert np.abs(got.s - st).max() < 0.01


def test_sharded_cg_improves_cost(runs):
    """The JAX test's problem (P=8, M=400, O=2000), 20 LM x 50 CG: the
    reprojection cost falls below a tenth of its start."""
    args = runs["cost_args"]
    got = runs["ranks"][0][2]
    assert _reproj_cost(got.R, got.t, got.points, args) < 0.1 * _reproj_cost(*args[1:4], args)


@pytest.mark.parametrize("which", [("single_ba", 3), ("single_eg", 4)])
def test_a_one_rank_group_changes_no_bit(runs, which):
    """A solve whose group has one rank (every rank holds all the
    observations / edges) equals the solve without a group to the bit: the
    group adds its all_reduces and nothing else."""
    name, call = which
    for x, y in zip(runs["ranks"][0][call], runs[name]):
        np.testing.assert_array_equal(x, y.numpy())


def test_indivisible_axis_raises(tmp_path):
    args = _make_problem(np.random.default_rng(0), O=1503)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.spawn(tmesh.run_calls, N_RANKS, backend="gloo", device="cpu",
                    args=([(tsb.bundle_adjustment_cg_sharded, *OBS, ("obs",) + args, {})],),
                    timeout_s=120, store_dir=tmp_path, num_threads=1)


def test_a_failing_rank_is_raised_and_no_rank_survives(tmp_path):
    """Rank 2 raises while ranks 0, 1 and 3 wait in an all_reduce that
    cannot complete: spawn re-raises rank 2's error (with its traceback)
    long before its time limit and leaves no rank alive."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="fails on purpose") as info:
        tmesh.spawn(tmesh.run_calls, N_RANKS, backend="gloo", device="cpu",
                    args=([(tmesh.fail_on_rank, *OBS, ("obs", 2), {})],),
                    timeout_s=120, store_dir=tmp_path, num_threads=1)
    assert time.monotonic() - t0 < 60
    assert isinstance(info.value.__cause__, tmesh.RankError)
    assert "fail_on_rank" in str(info.value.__cause__)
    assert multiprocessing.active_children() == []
