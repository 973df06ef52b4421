"""Monocular initialization's programs staged on the CPU against the direct
calls.

With graphs the tracker runs its initialization through
`utils/graphs.CapturedFunction`s: the bootstrap matcher
(`matcher.search_for_initialization` at its 100-px window), the two-view
RANSAC's four stages (`twoview.TwoViewStages`) around its five linear-algebra
calls, and each LM iteration of the initial map's global BA
(`optim.lm_iteration_robust`, passed as `robust_step`). On the CPU a
`CapturedFunction` stages and clones without capture, so each must give the
bits of the direct call:

- the composed stages against `initialize_two_view` without them, to the
  bit (fields compared as bytes: a failed attempt's points may be NaN), and
  both against the JAX `initialize_two_view` on `test_torch_optim.py`'s
  pair with the JAX draws, at that test's tolerances;
- each program's function issues no host read (`.item()`, a linear-algebra
  status check), no upload of a host constant and no eigensolver or SVD, the
  calls a CUDA graph cannot hold;
- the eigensolver in chunks of 64 matrices against one call, to the bit;
- an argument staged in its own dense layout (a transposed SVD output stays
  transposed);
- `global_bundle_adjustment(robust_step=...)` against the call without;
- a MonoSLAM with graphs against one with graphs=False over a held start
  (frame 0 shown four times, then the next frames): every attempt, the
  initial map after its global BA and every pose, to the bit.

About 15 s alone (the JAX initializer's CPU compile is most of it)."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ceres_mono_orb_slam2_tpu.ops import twoview as jtv
from ceres_mono_orb_slam2_tpu_torch.models import optimization
from ceres_mono_orb_slam2_tpu_torch.models.map import Map
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.ops import matcher, optim, twoview
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.config import (
    CameraConfig, ORBConfig, SlamConfig, StaticShapes)
from ceres_mono_orb_slam2_tpu_torch.utils.synthetic import make_rendered_sequence
from test_torch_matcher import _pair
from test_torch_optim import K, _project, _scene, _se3, _two_view

torch.set_num_threads(2)
HELD = 4  # showings of frame 0 in the held start


def T(a):
    return torch.from_numpy(np.array(a))


def _bits(a) -> tuple:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _same_bits(xs, ys) -> bool:
    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(_bits(x) == _bits(y) for x, y in zip(xs, ys))


def _stage_programs():
    return twoview.TwoViewStages(*(graphs.CapturedFunction(fn, "cpu", name=f"two_view_{name}")
                                   for name, fn in zip(twoview.TwoViewStages._fields,
                                                       twoview.TwoViewStages())))


@pytest.mark.parametrize("baseline", [0.8, 0.0])
def test_two_view_stages_equal_the_direct_call_and_the_jax_initializer(baseline):
    """A good pair and a pure rotation that must fail: the four stage
    programs give the direct call's bits (each called once); both agree
    with the JAX initializer as `test_initialize_two_view_parity` holds
    them."""
    uv1, uv2, valid = _two_view(np.random.default_rng(0), baseline=baseline)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.uniform(key, (256, len(uv1))))
    args = (T(noise), T(K), T(uv1), T(uv2), T(valid))
    stages = _stage_programs()
    direct = twoview.initialize_two_view(*args)
    staged = twoview.initialize_two_view(*args, stages=stages)
    assert _same_bits(staged, direct)
    assert [p["calls"] for f in stages for p in f.report()] == [1, 1, 1, 1]
    rj = jtv.initialize_two_view(key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2),
                                 jnp.asarray(valid))
    assert bool(direct.success) == bool(rj.success) == (baseline > 0)
    if bool(rj.success):
        assert bool(direct.used_homography) == bool(rj.used_homography)
        np.testing.assert_allclose(direct.R21.numpy(), np.asarray(rj.R21), atol=1e-3)
        np.testing.assert_allclose(direct.t21.numpy(), np.asarray(rj.t21), atol=1e-3)
        tri_j, tri_t = np.asarray(rj.triangulated), direct.triangulated.numpy()
        assert (tri_j != tri_t).sum() <= 0.01 * tri_j.sum()


class _Ops(TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


# what a CUDA graph cannot hold: a host read (`.item()`, indexing by a 0-d
# tensor, a linear-algebra status check), a host constant's upload (a
# Python number assigned into a tensor too), the eigensolver and the SVD
UNCAPTURABLE = ("_local_scalar_dense", "_linalg_check_errors", "lift_fresh", "_linalg_eigh",
                "_linalg_svd", "nonzero")


def _program_calls():
    """(name, fn, args) of every initializer program's function on a
    small problem, its arguments as the tracker passes them."""
    uv1, uv2, valid = _two_view(np.random.default_rng(1))
    noise = torch.rand((256, len(uv1)), generator=torch.Generator().manual_seed(0))
    calls = []

    class Record:
        def __init__(self, name, fn):
            self.name, self.fn = name, fn

        def __call__(self, *a):
            calls.append((self.name, self.fn, a))
            return self.fn(*a)

    stages = twoview.TwoViewStages(*(Record(f"two_view_{n}", fn) for n, fn in
                                     zip(twoview.TwoViewStages._fields, twoview.TwoViewStages())))
    twoview.initialize_two_view(noise, T(K), T(uv1), T(uv2), T(valid), stages=stages)
    f1, f2 = _pair(np.random.default_rng(2))
    oct0 = torch.zeros(len(f1["xy"]), dtype=torch.int32)
    calls.append(("init_match", lambda *a: matcher.search_for_initialization(*a, window=100.0),
                  (T(f1["xy"]), T(f1["ang"]), matcher.unpack_bits_pm1(T(f1["desc"])), T(f1["valid"]), oct0,
                   T(f2["xy"]), T(f2["ang"]), matcher.unpack_bits_pm1(T(f2["desc"])), T(f2["valid"]),
                   oct0)))
    Rp, tp, pts, *obs = _two_keyframe_problem(np.random.default_rng(3))
    step = Record("init_gba_lm_robust", optim.lm_iteration_robust)
    optim.bundle_adjustment(T(K), T(Rp), T(tp), T(pts), *(T(a) for a in obs), iters_huber=1,
                            iters_trimmed=0, robust_step=step)
    return calls


@pytest.mark.parametrize("name", ["two_view_fit", "two_view_score", "two_view_motions", "two_view_check",
                                  "init_match", "init_gba_lm_robust"])
def test_initializer_program_holds_no_host_read(name):
    """Each program's function, on the arguments the composed call hands
    it, runs none of `UNCAPTURABLE`."""
    ((_, fn, args),) = [c for c in _program_calls() if c[0] == name]
    with _Ops() as seen:
        fn(*args)
    assert seen.ops and not {op: n for op, n in seen.ops.items() if any(u in op for u in UNCAPTURABLE)}


def test_chunked_eigensolver_equals_one_call(monkeypatch):
    """8 x 200 cheirality matrices in chunks of 64 (25 calls) against one
    eigensolver call; then the whole initializer at that chunk size against
    the default (one chunk here), to the bit."""
    uv1, uv2, valid = _two_view(np.random.default_rng(4), n=200)
    R, t = _se3([0.3, 0.01, 0.02, 0.01, -0.05, 0.01])
    Rs = T(np.stack([R] * 8) + np.random.default_rng(5).standard_normal((8, 3, 3)).astype(np.float32) * 0.01)
    ts = T(np.stack([t] * 8))
    A = twoview.cheirality_system(Rs, ts, T(K), T(uv1), T(uv2))
    assert A.shape == (8, 200, 4, 4)
    one_call = torch.linalg.eigh(A)[1][..., :, 0]
    noise = torch.rand((256, 200), generator=torch.Generator().manual_seed(1))
    args = (noise, T(K), T(uv1), T(uv2), T(valid))
    whole = twoview.initialize_two_view(*args)
    monkeypatch.setattr(twoview, "EIGH_BATCH", 64)
    assert torch.equal(twoview.smallest_eigvecs(A), one_call)
    assert _same_bits(twoview.initialize_two_view(*args), whole)
    assert bool(whole.success)


def test_init_matcher_program_equals_the_direct_call():
    """`search_for_initialization` through a program keyed by N, as the
    tracker binds its window, twice on new data: the direct call's bits."""
    prog = graphs.CapturedFunction(
        lambda *a: matcher.search_for_initialization(*a, window=100.0), "cpu", name="init_match")
    for seed in (0, 1):
        f1, f2 = _pair(np.random.default_rng(seed))
        f1["oct"][::3] = 0
        f2["oct"] = f1["oct"].copy()
        args = (T(f1["xy"]), T(f1["ang"]), matcher.unpack_bits_pm1(T(f1["desc"])), T(f1["valid"]),
                T(f1["oct"]), T(f2["xy"]), T(f2["ang"]), matcher.unpack_bits_pm1(T(f2["desc"])),
                T(f2["valid"]), T(f2["oct"]))
        direct = matcher.search_for_initialization(*args, window=100.0)
        assert _same_bits(prog(*args), direct) and int(direct[2].sum()) > 10
    assert [(p["calls"], p["shapes"][0]) for p in prog.report()] == [(2, [300, 2])]


def test_arguments_are_staged_in_their_own_dense_layout():
    """A transposed argument's static buffer keeps its strides (an op may
    round differently on another layout) and keys a program of its own; a
    broadcast view is staged contiguous and shares the contiguous one's."""
    g = graphs.CapturedFunction(lambda a: a @ a, "cpu", name="square")
    a = torch.randn(3, 3, generator=torch.Generator().manual_seed(0))
    for arg in (a, a.T, a[:1].expand(3, 3), a.T):
        assert torch.equal(g(arg), arg @ arg)
        (staged,) = g.last_inputs
        assert staged.stride() == (arg.stride() if arg.stride() != (0, 1) else (3, 1))
    assert [p["calls"] for p in g.report()] == [2, 2]


def _two_keyframe_problem(rng, M=150):
    """Two views of M points, the second pose and the points perturbed:
    (Rp, tp, pts, obs_pose, obs_point, obs_uv, obs_inv_sigma2, obs_valid,
    fixed, point_valid)."""
    pts = _scene(rng, M)
    R2, t2 = _se3([0.4, 0.02, 0.01, 0.01, -0.06, 0.02])
    Rs = np.stack([np.eye(3, dtype=np.float32), R2])
    ts = np.stack([np.zeros(3, np.float32), t2])
    uv = [_project(Rs[p], ts[p], pts)[0] + rng.standard_normal((M, 2)).astype(np.float32) * 0.5
          for p in range(2)]
    uv[1][:8] += 30.0  # outliers the Huber weight damps
    dR, dt = _se3(rng.standard_normal(6) * 0.01)
    Rp, tp = Rs.copy(), ts.copy()
    Rp[1], tp[1] = dR @ R2, dR @ t2 + dt
    pts0 = (pts + rng.standard_normal(pts.shape) * 0.05).astype(np.float32)
    op = np.repeat(np.arange(2), M).astype(np.int64)
    oj = np.tile(np.arange(M), 2).astype(np.int64)
    return (Rp, tp, pts0, op, oj, np.concatenate(uv).astype(np.float32),
            np.ones(2 * M, np.float32), np.ones(2 * M, bool), np.array([True, False]), np.ones(M, bool))


class _Keypoints:
    """The fields `Map.new_keyframe` reads of a frame."""

    def __init__(self, fid, R, t, uv):
        n = len(uv)
        self.id, self.timestamp = fid, 0.0
        self.Rcw, self.tcw = R.astype(np.float32), t.astype(np.float32)
        self.kp_xy = self.kp_und = uv.astype(np.float32)
        self.kp_octave = np.zeros(n, np.int32)
        self.kp_angle = self.kp_response = np.zeros(n, np.float32)
        self.desc = np.zeros((n, 32), np.uint8)
        self.kp_valid = np.ones(n, bool)
        self.mp_ids = np.full(n, -1, np.int64)


def _two_keyframe_map():
    Rp, tp, pts, _, _, uv, *_ = _two_keyframe_problem(np.random.default_rng(6))
    M = len(pts)
    m = Map()
    kfs = [m.new_keyframe(_Keypoints(i, Rp[i], tp[i], uv[i * M:(i + 1) * M])) for i in range(2)]
    for j in range(M):
        mp = m.new_map_point(pts[j], np.zeros(32, np.uint8), kfs[1].id)
        for kf in kfs:
            m.add_observation(mp, kf, j)
    return m


def test_global_ba_with_its_captured_step_equals_the_plain_call():
    """The initializer's 20-iteration global BA on a two-keyframe map with
    its LM iteration through one program (20 calls) against the plain
    call: every keyframe pose and map point to the bit, the free pose
    moved."""
    cfg = SlamConfig()
    maps = [_two_keyframe_map() for _ in range(2)]
    step = graphs.CapturedFunction(optim.lm_iteration_robust, "cpu", name="init_gba_lm_robust",
                                   max_programs=1)
    before = maps[0].keyframes[1].tcw.copy()
    assert optimization.global_bundle_adjustment(maps[0], cfg, n_iters=20, device="cpu", robust_step=step)
    assert optimization.global_bundle_adjustment(maps[1], cfg, n_iters=20, device="cpu")
    a, b = maps
    assert _same_bits([a.keyframes[i].Rcw for i in (0, 1)] + [a.keyframes[i].tcw for i in (0, 1)],
                      [b.keyframes[i].Rcw for i in (0, 1)] + [b.keyframes[i].tcw for i in (0, 1)])
    assert _same_bits([mp.pos for mp in a.all_map_points()], [mp.pos for mp in b.all_map_points()])
    assert not np.array_equal(a.keyframes[1].tcw, before)
    assert [p["calls"] for p in step.report()] == [20]


def _held_start_config(h, w, f):
    return SlamConfig(camera=CameraConfig(fx=f, fy=f, cx=w / 2, cy=h / 2, fps=30.0),
                      orb=ORBConfig(n_features=1000),
                      shapes=StaticShapes(max_local_points=1024, max_local_keyframes=12,
                                          max_ba_points=1024, max_ba_obs=4096))


def test_held_start_with_graphs_equals_graphs_false(monkeypatch):
    """Frame 0 of a 240x320 spiral shown HELD times, then frames 1 and 2,
    through a MonoSLAM with graphs and one with graphs=False: each attempt
    (match indices and every `InitResult` field), the initial map's
    keyframe poses and map points after its global BA, and every pose
    equal to the bit; the held frames fail to initialise, frame 1 does."""
    h, w, f = 240, 320, 250.0
    seq = make_rendered_sequence(3, h, w, f, f, motion="spiral", step=0.06, seed=3)
    images = np.clip(seq.images + 0.5, 0.0, 255.0).astype(np.uint8)
    frames = [0] * HELD + [1, 2]
    after_ba = []
    gba = optimization.global_bundle_adjustment

    def recorded_gba(m, *a, **kw):
        out = gba(m, *a, **kw)
        after_ba.append(([(k.Rcw.copy(), k.tcw.copy()) for k in m.all_keyframes()],
                         [mp.pos.copy() for mp in m.all_map_points()]))
        return out

    monkeypatch.setattr(optimization, "global_bundle_adjustment", recorded_gba)
    runs = []
    for g in (True, False):
        slam = MonoSLAM(_held_start_config(h, w, f), device="cpu", graphs=g)
        tr, attempts = slam.tracker, []
        attempt = tr._two_view_attempt

        def recorded(ref, frame, attempt=attempt, attempts=attempts):
            out = attempt(ref, frame)
            attempts.append(None if out is None else [out[0], *out[1]])
            return out

        tr._two_view_attempt = recorded
        poses = [slam.track_monocular(images[i], k / 30.0) for k, i in enumerate(frames)]
        runs.append((attempts, poses, tr.programs()))
        slam.shutdown()
    (att_g, poses_g, progs), (att_e, poses_e, progs_e) = runs
    assert len(att_g) == len(att_e) == HELD and all(a is not None for a in att_g)
    assert [bool(a[1]) for a in att_g] == [False] * (HELD - 1) + [True]
    assert all(_same_bits(a, b) for a, b in zip(att_g, att_e))
    assert len(after_ba) == 2
    (kf_g, mp_g), (kf_e, mp_e) = after_ba
    assert _same_bits([x for p in kf_g for x in p], [x for p in kf_e for x in p]) and len(kf_g) == 2
    assert _same_bits(mp_g, mp_e) and len(mp_g) >= 100
    assert [p is None for p in poses_g] == [True] * HELD + [False, False]
    assert _same_bits(poses_g[HELD:], poses_e[HELD:])
    init = {"init_match": HELD, "init_gba_lm_robust": 20,
            **{f"two_view_{n}": HELD for n in twoview.TwoViewStages._fields}}
    assert {p["name"]: p["calls"] for p in progs if p["name"] in init} == init
    assert progs_e == []
