"""The mapper's device solves as fixed-count functions of tensors, staged
through `utils/graphs.py` on the CPU against the direct calls.

- `bundle_adjustment` runs each LM pass for its full count with a device
  `done` flag that freezes the state once an accepted step converged (the
  JAX package's scan): equal to the bit to a loop of the same iterations
  that exits on the host at convergence (the port's form before), and to
  itself with 5 more iterations once converged. Against the JAX package at
  the tolerances of tests/test_torch_optim.py.
- `bundle_adjustment_streams` at S = 2, fixed-count too: each stream within
  tests/test_torch_multistream.py's bars of its own single solve.
- The LM iterations staged as `CapturedFunction`s (one program per pass and
  shape, replayed by the second call of a local BA) and the essential
  graph's GN iteration staged the same way, against the direct calls: equal
  to the bit.
- A `MonoSLAM` with graphs and one with `graphs=False` over the geometric
  strafe: every keyframe pose and map point equal to the bit, the local BA's
  programs called; then the loop closer's global BA over each map, staged
  against direct, equal to the bit.

About 25 s on two threads."""

import collections
import threading
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import optim as joptim
from ceres_mono_orb_slam2_tpu_torch.models.optimization import run_global_ba
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops import optim, sim3opt
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from test_torch_optim import _ba_problem
from test_torch_sim3 import drifted_ring

torch.set_num_threads(2)
_THREADS_BEFORE = set(threading.enumerate())


@pytest.fixture(autouse=True)
def no_worker_thread_left():
    yield
    left = [t.name for t in threading.enumerate()
            if t.name in ("mapper", "gba") and t.is_alive() and t not in _THREADS_BEFORE]
    assert not left, f"worker threads left alive: {left}"


def T(a):
    return torch.tensor(np.asarray(a))


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _exit_at_convergence(K, R, t, points, obs_pose, obs_point, obs_uv, obs_w, obs_valid, fixed,
                         point_valid, iters_huber, iters_trimmed):
    """`bundle_adjustment` with each pass ended on the host at the first
    converged step: the port's loop before the fixed count."""
    prob = optim.ba_problem(K, obs_pose, obs_point, obs_uv, obs_w, fixed, point_valid)
    delta = float(np.sqrt(optim.CHI2_MONO))

    def run_pass(Rp, tp, pts, mask, robust, step, n):
        state = optim.LMState(Rp, tp, pts, torch.tensor(1e-4), optim._ba_cost(prob, Rp, tp, pts, mask,
                                                                             robust, delta),
                              torch.tensor(False))
        for _ in range(n):
            state = step(state, mask, prob)
            if bool(state.done):
                break
        return state

    s1 = run_pass(optim.lie.so3_project(R), t, points, obs_valid, True, optim.lm_iteration_robust,
                  iters_huber)
    R1 = optim.lie.so3_project(s1.R)
    s, _, Xc = optim._ba_chi2(prob, R1, s1.t, s1.points)
    keep = obs_valid & (s <= optim.CHI2_MONO) & (Xc[..., 2] > 1e-6)
    s2 = run_pass(R1, s1.t, s1.points, keep, False, optim.lm_iteration_trimmed, iters_trimmed)
    return optim.lie.so3_project(s2.R), s2.t, s2.points, s2.cost


@pytest.mark.parametrize("iters", [(5, 5), (0, 5), (5, 10), (20, 0)])
def test_fixed_count_equals_exit_at_convergence(iters):
    for seed in range(3):
        args = [T(a) for a in _ba_problem(np.random.default_rng(seed))]
        res = optim.bundle_adjustment(*args, iters_huber=iters[0], iters_trimmed=iters[1])
        assert _same((res.R, res.t, res.points, res.cost), _exit_at_convergence(*args, *iters))


def test_fixed_count_freezes_once_converged():
    args = [T(a) for a in _ba_problem(np.random.default_rng(0))]
    a = optim.bundle_adjustment(*args, iters_huber=20, iters_trimmed=20)
    b = optim.bundle_adjustment(*args, iters_huber=25, iters_trimmed=25)
    assert _same(a, b)


def test_bundle_adjustment_matches_jax():
    """The fixed-count solve against the JAX scan, at
    tests/test_torch_optim.py's tolerances (1e-3 of the largest value)."""
    args = _ba_problem(np.random.default_rng(3))
    rj = joptim.bundle_adjustment(*(jnp.asarray(a) for a in args), iters_huber=5, iters_trimmed=5)
    rt = optim.bundle_adjustment(*(T(a) for a in args), iters_huber=5, iters_trimmed=5)
    for a, b in [(rj.R, rt.R), (rj.t, rt.t), (rj.points, rt.points)]:
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-3 * np.abs(a).max())
    np.testing.assert_array_equal(rt.inlier_obs.numpy(), np.asarray(rj.inlier_obs))
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)


def _centres(R, t):
    return np.einsum("pij,pj->pi", np.asarray(R).transpose(0, 2, 1), -np.asarray(t))


def test_streams_equal_each_stream_alone():
    """S = 2 problems of one shape in one fixed-count solve, each against
    its own single solve: centres within 1e-3, points within 5e-3, the same
    inlier observations, cost within 1e-4 (the batched assembly sums in
    another order)."""
    probs = [_ba_problem(np.random.default_rng(100 + s), P=4, M=120, O=500) for s in range(2)]
    stack = lambda i: np.stack([p[i] for p in probs])  # noqa: E731
    res_b = optim.bundle_adjustment_streams(T(probs[0][0]), *(T(stack(i)) for i in range(1, 11)))
    for s in range(2):
        res_s = optim.bundle_adjustment(*(T(x) for x in probs[s]))
        assert np.abs(_centres(res_b.R[s], res_b.t[s]) - _centres(res_s.R, res_s.t)).max() < 1e-3
        assert np.abs(res_b.points[s].numpy() - res_s.points.numpy()).max() < 5e-3
        assert torch.equal(res_b.inlier_obs[s], res_s.inlier_obs)
        np.testing.assert_allclose(float(res_b.cost[s]), float(res_s.cost), rtol=1e-4)


def test_staged_lm_iterations_equal_direct():
    """Both passes' iterations through `CapturedFunction`s: the bits of the
    direct calls; one program per pass for the window, its calls one per
    iteration; a second solve of the same window calls the same programs;
    a window of another shape makes new ones and, past `max_programs`,
    drops the oldest."""
    robust = graphs.CapturedFunction(optim.lm_iteration_robust, "cpu", owner="mapper", max_programs=1)
    trimmed = graphs.CapturedFunction(optim.lm_iteration_trimmed, "cpu", owner="mapper", max_programs=1)
    args = [T(a) for a in _ba_problem(np.random.default_rng(1))]
    direct = optim.bundle_adjustment(*args, iters_huber=5, iters_trimmed=5)
    staged = optim.bundle_adjustment(*args, iters_huber=5, iters_trimmed=5, robust_step=robust,
                                     trimmed_step=trimmed)
    assert _same(direct, staged)
    again = optim.bundle_adjustment(*args[:1], staged.R, staged.t, staged.points, *args[4:],
                                    iters_huber=0, iters_trimmed=5, robust_step=robust,
                                    trimmed_step=trimmed)
    assert _same(again, optim.bundle_adjustment(*args[:1], direct.R, direct.t, direct.points,
                                                *args[4:], iters_huber=0, iters_trimmed=5))
    (r,), (t,) = robust.report(), trimmed.report()
    assert (r["calls"], t["calls"], r["captures"]) == (5, 10, 0)  # the CPU stages without capture
    other = [T(a) for a in _ba_problem(np.random.default_rng(2), P=5, M=150, O=600)]
    assert _same(optim.bundle_adjustment(*other, robust_step=robust, trimmed_step=trimmed),
                 optim.bundle_adjustment(*other))
    assert len(robust.programs) == 1 and robust.summary()["dropped"] == 1


def test_staged_essential_graph_equals_direct():
    """One GN iteration (its 60 PCG iterations included) staged per (P, E)
    and called for every iteration: the bits of the direct solve."""
    _, args = drifted_ring(20, 0)
    targs = [T(a) for a in args]
    step = graphs.CapturedFunction(partial(sim3opt.gn_iteration, cg_iters=60), "cpu",
                                   name="essential_graph_gn", owner="mapper")
    direct = sim3opt.optimize_essential_graph(*targs, gn_iters=12, cg_iters=60)
    staged = sim3opt.optimize_essential_graph(*targs, gn_iters=12, cg_iters=60, step=step)
    assert _same(direct, staged)
    (p,) = step.report()
    assert p["calls"] == 12


@pytest.fixture(scope="module")
def strafe_pair():
    """The geometric strafe through a MonoSLAM with graphs (its mapper's
    programs staged on the CPU) and one with graphs=False."""
    n_frames, H, W = 12, 480, 640
    cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
                     orb=ORBConfig(n_features=600),
                     shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                                         max_ba_points=1024, max_ba_obs=4096))
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    systems = []
    for g in (True, False):
        slam = MonoSLAM(cfg, device="cpu", graphs=g)
        slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W, px_noise=0.3,
                                              bit_noise=2, seed=5, device="cpu")
        for k in range(n_frames):
            slam.track_monocular(frame_image(k, H, W), k / 30.0)
        slam.shutdown()
        systems.append(slam)
    return systems


def _map_state(m):
    return ({k: (kf.Rcw, kf.tcw) for k, kf in m.keyframes.items()},
            {i: mp.pos for i, mp in m.map_points.items()})


def _same_map(a, b) -> bool:
    (kfs_a, mps_a), (kfs_b, mps_b) = _map_state(a), _map_state(b)
    return (kfs_a.keys() == kfs_b.keys()
            and all(np.array_equal(x, y) for k in kfs_a for x, y in zip(kfs_a[k], kfs_b[k]))
            and mps_a.keys() == mps_b.keys() and all(np.array_equal(mps_a[i], mps_b[i]) for i in mps_a))


def test_system_with_mapper_programs_equals_graphs_false(strafe_pair):
    """Every keyframe pose and map point equal to the bit after the run; the
    local BA's programs called, the triangulation and the fuse eager in
    both."""
    slam_g, slam_e = strafe_pair
    lm_g, lm_e = slam_g.local_mapper, slam_e.local_mapper
    assert len(slam_g.map.keyframes) >= 3 and lm_g.n_local_ba >= 1
    assert _same_map(slam_g.map, slam_e.map)
    calls = collections.Counter()
    for p in lm_g.programs():
        calls[p["name"]] += p["calls"]
    assert set(calls) == {"lba_lm_robust", "lba_lm_trimmed"} and calls["lba_lm_robust"] >= 5
    assert lm_e.programs() == []


def test_staged_global_ba_equals_direct(strafe_pair):
    """The loop closer's global BA (`run_global_ba`, two chunks of 10) over
    each system's map, its LM iterations staged through `CapturedFunction`s
    as `LoopClosing` passes them, against the direct calls: every keyframe
    pose and map point equal to the bit, one program called 20 times."""
    slam_g, slam_e = strafe_pair
    assert _same_map(slam_g.map, slam_e.map)
    steps = {f"{kind}_step": graphs.CapturedFunction(fn, "cpu", name=f"gba_lm_{kind}", owner="mapper",
                                                     max_programs=1)
             for kind, fn in (("robust", optim.lm_iteration_robust),
                              ("trimmed", optim.lm_iteration_trimmed))}
    loop_id = max(slam_g.map.keyframes)
    assert run_global_ba(slam_g.map, slam_g.config, loop_id, n_iters=20, device="cpu", **steps)
    assert run_global_ba(slam_e.map, slam_e.config, loop_id, n_iters=20, device="cpu")
    assert _same_map(slam_g.map, slam_e.map)
    (p,) = steps["robust_step"].report()
    assert p["calls"] == 20 and steps["trimmed_step"].report() == []
