"""Port parity of `ops/optim.bundle_adjustment_cg` (matrix-free Schur BA)
and of `models/optimization.run_global_ba`.

The same numpy problem goes through the JAX CG solver and the port's:
poses and points within 1e-3 of the largest magnitude, cost within 0.1%,
equal inlier classification. The port's CG solver against the port's dense
Schur solver on the same robust problem: cost within 1%. Two port calls
give bit-identical results (segment sums in place of scatter-adds).
`run_global_ba` on a converted 14-keyframe ring map (radius 3): rotations
within 1e-3, translations within 1e-2 and points within 2e-2 of the JAX
package's, looser than the solver's own parity because one fixed keyframe
leaves the monocular scale a flat direction along which both solvers stop
at slightly different places."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models import optimization as jmopt
from ceres_mono_orb_slam2_tpu.ops import optim as jopt
from ceres_mono_orb_slam2_tpu_torch.models import optimization as tmopt
from ceres_mono_orb_slam2_tpu_torch.ops import optim as topt
from ceres_mono_orb_slam2_tpu_torch.utils import convert
from test_loopclosing import drifted_loop_map  # noqa: F401  (fixture)
from test_torch_optim import _ba_problem

torch.set_num_threads(2)


def T(args):
    return tuple(torch.tensor(np.asarray(a)) for a in args)


@pytest.mark.parametrize("robust", [True, False])
def test_bundle_adjustment_cg_parity(rng, robust):
    args = _ba_problem(rng)
    kw = dict(iters=8, cg_iters=30, robust=robust)
    rj = jopt.bundle_adjustment_cg(*(jnp.asarray(a) for a in args), **kw)
    rt = topt.bundle_adjustment_cg(*T(args), **kw)
    for a, b in [(rj.R, rt.R), (rj.t, rt.t), (rj.points, rt.points)]:
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-3 * np.abs(a).max())
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    # observations within 1% of the chi2 gate may fall on either side
    np.testing.assert_array_equal(rt.inlier_obs.numpy()[:-20], np.asarray(rj.inlier_obs)[:-20])
    assert not rt.inlier_obs.numpy()[-20:].any()  # the planted outliers
    np.testing.assert_array_equal(rt.R.numpy()[:2], np.asarray(args[1])[:2])  # fixed poses stay


def test_cg_reaches_the_dense_solvers_cost_and_repeats(rng):
    args = T(_ba_problem(rng, P=8, M=300, O=1500))
    cg = topt.bundle_adjustment_cg(*args, iters=15, cg_iters=50, robust=True)
    dense = topt.bundle_adjustment(*args, iters_huber=15, iters_trimmed=0)
    # the dense solver reports its trimmed cost: take the Huber cost of its
    # solution from a zero-iteration CG call, which only evaluates it
    dense_cost = topt.bundle_adjustment_cg(args[0], dense.R, dense.t, dense.points, *args[4:], iters=0).cost
    start = topt.bundle_adjustment_cg(*args, iters=0)
    assert float(cg.cost) < 0.9 * float(start.cost)
    np.testing.assert_allclose(float(cg.cost), float(dense_cost), rtol=1e-2)
    np.testing.assert_allclose(cg.t.numpy(), dense.t.numpy(), atol=5e-3)
    again = topt.bundle_adjustment_cg(*args, iters=15, cg_iters=50, robust=True)
    assert all(torch.equal(a, b) for a, b in zip(cg, again))


@pytest.fixture()
def noisy_loop_map(drifted_loop_map):  # noqa: F811
    """The 14-keyframe ring map of tests/test_loopclosing.py, its points
    perturbed so that a global BA has work to do."""
    cfg, m, *_ = drifted_loop_map
    rng = np.random.default_rng(1)
    for mp in m.map_points.values():
        mp.pos = (mp.pos + rng.standard_normal(3) * 0.03).astype(np.float32)
    m.keyframe_origins = [0]
    return cfg, m


@pytest.mark.parametrize("force_cg", [False, True])
def test_run_global_ba_parity(noisy_loop_map, force_cg, monkeypatch):
    cfg, jm = noisy_loop_map
    tm = convert.map_from_reference(jm)
    tcfg = convert.config_from_reference(cfg)
    if force_cg:
        monkeypatch.setenv("CERES_TPU_GBA_CG", "1")
    assert jmopt.run_global_ba(jm, cfg, loop_kf_id=13, n_iters=10, chunk=5)
    stats = {}
    assert tmopt.run_global_ba(tm, tcfg, loop_kf_id=13, n_iters=10, chunk=5, force_cg=force_cg,
                               device="cpu", stats=stats)
    assert stats["solver"] == ("cg" if force_cg else "dense")
    assert (stats["P"], stats["M"]) == (14, 14 * 60) and stats["O"] == 27 * 60
    assert tm.big_change_idx == jm.big_change_idx == 1
    for k in jm.keyframes:
        np.testing.assert_allclose(tm.keyframes[k].Rcw, jm.keyframes[k].Rcw, atol=1e-3)
        np.testing.assert_allclose(tm.keyframes[k].tcw, jm.keyframes[k].tcw, atol=1e-2)
        assert tm.keyframes[k].gba_for_kf == 13
    pj = np.stack([jm.map_points[i].pos for i in sorted(jm.map_points)])
    pt = np.stack([tm.map_points[i].pos for i in sorted(tm.map_points)])
    np.testing.assert_allclose(pt, pj, atol=2e-2)
    # an aborted solve leaves the map untouched
    before = tm.keyframes[5].tcw.copy()
    assert not tmopt.run_global_ba(tm, tcfg, 13, n_iters=10, chunk=5, stop_cb=lambda: True, device="cpu")
    np.testing.assert_array_equal(tm.keyframes[5].tcw, before)
