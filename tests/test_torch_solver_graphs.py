"""The port's solver programs staged on the CPU against their direct calls.

A non-fused frame's extraction (`Tracking.build_frame`), relocalization's
RANSAC stages (`ops/pnp.RansacStages`) and the CG bundle adjustment's LM
iteration each run through `utils/graphs.CapturedFunction`, which on the
CPU stages and clones without capture: the bits of graphs=False. Padding:
RANSAC padded to 8 candidates against the live candidates alone (equal
success, inliers and counts, R and t within 1e-6); the Sim(3) refinement
(`solve_ex`, no host read) with masked rows at `bucket(N)` against N (R
1e-5, t 1e-4, s 1e-4, equal inliers) and against the JAX `optimize_sim3` on
the same padded inputs, as the JAX loop closer pads them
(`tests/test_torch_sim3.py`'s 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import lie as jlie
from ceres_mono_orb_slam2_tpu.ops import sim3opt as jopt
from ceres_mono_orb_slam2_tpu_torch.models import localmapping
from ceres_mono_orb_slam2_tpu_torch.models.optimization import run_global_ba
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops import optim, pnp, sim3opt
from ceres_mono_orb_slam2_tpu_torch.ops.orb import kernels
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.geosim import (
    GeoExtractor, GeoWorld, frame_image, make_geo_trajectory)
from ceres_mono_orb_slam2_tpu_torch.utils.padding import bucket, pad_rows
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence
from test_torch_optim import _ba_problem
from test_torch_sim3 import K, XI_TRUE, two_view

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_build_frame_through_the_extraction_program_equals_graphs_false():
    """Two frames through each tracker: features equal to the bit, one
    extraction program called twice, none without graphs."""
    h, w = 96, 128
    cfg = SlamConfig(camera=CameraConfig(fx=200.0, fy=200.0, cx=w / 2.0, cy=h / 2.0, fps=30.0),
                     orb=ORBConfig(n_features=300, n_levels=4))
    seq = make_rendered_sequence(2, h, w, 200.0, 200.0, motion="circle", seed=3)
    images = np.clip(seq.images + 0.5, 0.0, 255.0).astype(np.uint8)
    trackers = [MonoSLAM(cfg, device="cpu", graphs=g).tracker for g in (True, False)]
    kernels.reset_launch_counts()
    for i in range(2):
        fg, fe = (tr.build_frame(images[i], float(i)) for tr in trackers)
        for name in ("kp_und", "kp_octave", "kp_angle", "desc", "kp_valid"):
            assert np.array_equal(getattr(fg, name), getattr(fe, name)), name
        assert fg.kp_valid.sum() > 50
    (p,) = trackers[0].programs()
    assert (p["name"], p["calls"], p["shapes"]) == ("extract", 2, [[h, w]])
    assert trackers[1].programs() == []
    assert sum(kernels.launch_counts.values()) == 0  # the CPU runs the plain versions


def _pnp_problem(C, N=300, NH=64, seed=0):
    """C candidates, candidate 1 holding the true points for half its matches."""
    rng = np.random.default_rng(seed)
    R = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.1, -0.2, 0.05], np.float32))))
    t = np.array([0.3, -0.1, 0.5], np.float32)
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 10, N)], -1)
    Xc = X @ R.T + t
    uv = 500.0 * Xc[:, :2] / Xc[:, 2:] + K[:2, 2] + rng.standard_normal((N, 2)) * 0.5
    Xs = X[None].repeat(C, 0) + rng.standard_normal((C, N, 3))
    Xs[1] = np.where((rng.random(N) < 0.5)[:, None], X, Xs[1])
    valid = rng.random((C, N)) < 0.95
    noise = torch.rand((C, NH, N), generator=torch.Generator().manual_seed(seed))
    w = rng.choice([1.0, 0.694], N).astype(np.float32)
    return (noise, T(K), T(Xs.astype(np.float32)), T(np.broadcast_to(uv.astype(np.float32), (C, N, 2))),
            T(np.broadcast_to(w, (C, N))), T(valid))


def test_ransac_stages_equal_the_direct_solve():
    """The four stages through `CapturedFunction`s: the bits of the direct
    call; each stage program called once."""
    args = _pnp_problem(8)
    stages = pnp.RansacStages(*(graphs.CapturedFunction(fn, "cpu", name=name)
                                for name, fn in zip(pnp.RansacStages._fields, pnp.RansacStages())))
    direct = pnp.ransac_pnp_multi(*args)
    assert _same(pnp.ransac_pnp_multi(*args, stages=stages), direct)
    assert [p["calls"] for f in stages for p in f.report()] == [1, 1, 1, 1]
    assert bool(direct.success[1]) and int(direct.n_inliers[1]) > 100


@pytest.mark.parametrize("C", [1, 3])
def test_ransac_padded_to_eight_candidates_equals_the_live_ones(C):
    """C candidates padded to 8 as the tracker pads them (zero points, no
    valid row, zero draws): the live rows' success, inliers and counts
    equal, R and t within 1e-6; the padded rows fail. C = 1 is candidate 1,
    the one with the true points."""
    live = [1] if C == 1 else [0, 1, 2]
    noise, K_, pts, uv, w, valid = _pnp_problem(3)
    noise, pts, uv, w, valid = (a[live] for a in (noise, pts, uv, w, valid))
    pad = lambda a: torch.cat([a, a.new_zeros((8 - C,) + a.shape[1:])])  # noqa: E731
    res = pnp.ransac_pnp_multi(noise, K_, pts, uv, w, valid)
    padded = pnp.ransac_pnp_multi(pad(noise), K_, pad(pts), uv[:1].expand(8, -1, -1),
                                  w[:1].expand(8, -1), pad(valid))
    for name in ("success", "inliers", "n_inliers"):
        assert torch.equal(getattr(padded, name)[:C], getattr(res, name)), name
    torch.testing.assert_close(padded.R[:C], res.R, rtol=0, atol=1e-6)
    torch.testing.assert_close(padded.t[:C], res.t, rtol=0, atol=1e-6)
    assert not padded.success[C:].any() and int(padded.n_inliers[C:].sum()) == 0


def _sim3_inputs(rows=None):
    """`two_view(2)` with 5 gross matches, refined from a perturbed start;
    padded to `rows` rows as `LoopClosing` pads them."""
    (_, _, _), X1, X2, uv1, uv2, w1, w2 = two_view(2, n=80, noise_px=0.3)
    uv1[:5] += 40.0
    n = len(X1)
    rows = rows or n
    X1, X2 = pad_rows(X1, rows), pad_rows(X2, rows)
    X1[n:, 2] = X2[n:, 2] = 1.0
    xi0 = XI_TRUE + np.array([0.05, -0.04, 0.06, 0.02, 0.02, -0.02, 0.08], np.float32)
    R0, t0, s0 = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi0)))
    return (K, K, X1, X2, pad_rows(uv1, rows), pad_rows(uv2, rows), pad_rows(w1, rows, 1),
            pad_rows(w2, rows, 1), np.arange(rows) < n, R0, t0, np.float32(s0))


def test_optimize_sim3_program_padded():
    """Padded to bucket(80) = 128 rows, the refinement agrees with the
    unpadded solve (R 1e-5, t 1e-4, s 1e-4, equal inliers) and with the JAX
    `optimize_sim3` on the same padded inputs (1e-3, equal inliers)."""
    plain = [T(a) for a in _sim3_inputs()]
    padded_np = _sim3_inputs(bucket(80))
    res_p = sim3opt.optimize_sim3(*(T(a) for a in padded_np))
    res = sim3opt.optimize_sim3(*plain)
    torch.testing.assert_close(res_p.R, res.R, rtol=0, atol=1e-5)
    torch.testing.assert_close(res_p.t, res.t, rtol=0, atol=1e-4)
    # the scale is the least conditioned direction: f32 sums of another
    # length move it by up to 5e-5 on such problems (not 1e-5)
    torch.testing.assert_close(res_p.s, res.s, rtol=0, atol=1e-4)
    assert torch.equal(res_p.inliers[:80], res.inliers) and not res_p.inliers[80:].any()
    assert int(res_p.n_inliers) == int(res.n_inliers) == 75
    jr = jopt.optimize_sim3(*(jnp.asarray(a) for a in padded_np))
    np.testing.assert_allclose(res_p.R.numpy(), np.asarray(jr.R), atol=1e-3)
    np.testing.assert_allclose(res_p.t.numpy(), np.asarray(jr.t), atol=1e-3)
    np.testing.assert_allclose(float(res_p.s), float(jr.s), atol=1e-3)
    np.testing.assert_array_equal(res_p.inliers.numpy(), np.asarray(jr.inliers))


def test_staged_cg_bundle_adjustment_equals_direct():
    """`bundle_adjustment_cg` with its LM iterations through a captured
    `cg_lm_iteration` (8 then 7, as local BA's CG branch calls it) equals
    the direct calls to the bit, one program called 15 times."""
    args = [T(a) for a in _ba_problem(np.random.default_rng(3), P=6, M=150, O=600)]
    step = graphs.CapturedFunction(optim.cg_lm_iteration, "cpu", name="lba_lm_cg", owner="mapper")
    direct = optim.bundle_adjustment_cg(*args, iters=8)
    staged = optim.bundle_adjustment_cg(*args, iters=8, step=step)
    assert _same(staged, direct)
    direct = optim.bundle_adjustment_cg(args[0], direct.R, direct.t, direct.points, *args[4:], iters=7)
    staged = optim.bundle_adjustment_cg(args[0], staged.R, staged.t, staged.points, *args[4:], iters=7,
                                        step=step)
    assert _same(staged, direct)
    assert [p["calls"] for p in step.report()] == [15]
    assert float(direct.cost) < float(optim.bundle_adjustment_cg(*args, iters=0).cost)


@pytest.fixture(scope="module")
def cg_strafe_pair():
    """The geometric strafe through a MonoSLAM with graphs and one with
    graphs=False, local BA forced onto its CG branch (the dense budget set
    to 0)."""
    n_frames, H, W = 8, 480, 640
    cfg = SlamConfig(camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fps=30.0),
                     orb=ORBConfig(n_features=600),
                     shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                                         max_ba_points=1024, max_ba_obs=4096))
    Rcw, tcw = make_geo_trajectory(n_frames, "strafe", 0.12)
    world = GeoWorld(np.random.default_rng(0), 2500, extent=10.0)
    budget, localmapping.DENSE_BA_MAX_BLOCKS = localmapping.DENSE_BA_MAX_BLOCKS, 0
    try:
        systems = []
        for g in (True, False):
            slam = MonoSLAM(cfg, device="cpu", graphs=g)
            slam.tracker.extractor = GeoExtractor(world, cfg.camera.K, Rcw, tcw, 600, H, W,
                                                  px_noise=0.3, bit_noise=2, seed=5, device="cpu")
            for k in range(n_frames):
                slam.track_monocular(frame_image(k, H, W), k / 30.0)
            slam.shutdown()
            systems.append(slam)
    finally:
        localmapping.DENSE_BA_MAX_BLOCKS = budget
    return systems


def _same_map(a, b) -> bool:
    return (a.keyframes.keys() == b.keyframes.keys() and a.map_points.keys() == b.map_points.keys()
            and all(np.array_equal(a.keyframes[k].Rcw, b.keyframes[k].Rcw)
                    and np.array_equal(a.keyframes[k].tcw, b.keyframes[k].tcw) for k in a.keyframes)
            and all(np.array_equal(a.map_points[i].pos, b.map_points[i].pos) for i in a.map_points))


def test_local_ba_cg_branch_through_its_program(cg_strafe_pair):
    """Local BA's CG branch replays `lba_lm_cg` (8 + 7 calls a solve): every
    keyframe pose and map point equal to graphs=False's to the bit."""
    slam_g, slam_e = cg_strafe_pair
    assert slam_g.local_mapper.n_local_ba >= 1 and _same_map(slam_g.map, slam_e.map)
    calls = {}
    for p in slam_g.local_mapper.programs():
        calls[p["name"]] = calls.get(p["name"], 0) + p["calls"]
    assert calls == {"lba_lm_cg": 15 * slam_g.local_mapper.n_local_ba}


def test_global_ba_cg_branch_through_its_program(cg_strafe_pair):
    """`run_global_ba(force_cg=True)` over both maps, one with the captured
    CG step `LoopClosing` passes: equal keyframe poses and map points to the
    bit, the program called once per LM iteration of both chunks."""
    slam_g, slam_e = cg_strafe_pair
    step = graphs.CapturedFunction(optim.cg_lm_iteration, "cpu", name="gba_lm_cg", owner="mapper",
                                   max_programs=1)
    loop_id = max(slam_g.map.keyframes)
    assert run_global_ba(slam_g.map, slam_g.config, loop_id, n_iters=12, chunk=6, force_cg=True,
                         device="cpu", cg_step=step)
    assert run_global_ba(slam_e.map, slam_e.config, loop_id, n_iters=12, chunk=6, force_cg=True,
                         device="cpu")
    assert _same_map(slam_g.map, slam_e.map)
    assert [p["calls"] for p in step.report()] == [12]
