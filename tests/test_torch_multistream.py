"""Port parity of the batched multi-stream step (parallel/multistream.py) and
of the leading stream axis through the ops it uses.

Each batched op runs at S=3 against a loop of its unbatched self on inputs
from a numpy seed: discrete outputs (indices, masks, counts) must be equal,
floats agree within the tolerance stated at each check. Stream 1 starts at
its optimum, so its solve converges in the first iterations and stays frozen
while the others go on; stream 2 has no valid match at all.

`make_multistream_step` and `make_multistream_local_ba` run on the same
seeded inputs through the JAX package (on the CPU, its Pallas kernels through
their plain references as in its own tests) and through the port, the state
carried over by `utils.convert.stream_state_from_reference`."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import optim as joptim
from ceres_mono_orb_slam2_tpu.parallel import multistream as jms
from ceres_mono_orb_slam2_tpu.utils.config import CameraConfig, ORBConfig, SlamConfig
from ceres_mono_orb_slam2_tpu_torch.models import fused_track
from ceres_mono_orb_slam2_tpu_torch.ops import frustum, lie, matcher, optim
from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as tms
from ceres_mono_orb_slam2_tpu_torch.utils.convert import (
    config_from_reference, stream_state_from_reference)

torch.set_num_threads(2)
S = 3
T = torch.as_tensor


def stacked(fn, *per_stream_args):
    """fn over each stream alone, outputs stacked along a new leading axis."""
    outs = [fn(*(a[s] for a in per_stream_args)) for s in range(S)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[i] for o in outs]) for i in range(len(outs[0])))
    return torch.stack(outs)


def assert_same(got, want, atol=0.0):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype.is_floating_point and atol > 0:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, rtol=0)
        else:
            assert torch.equal(g, w)


# ------------------------------------------------------------ matcher, frustum


def test_masked_top2_batched(rng):
    dist = T(rng.integers(0, 40, (S, 50, 70)).astype(np.int32))  # many ties
    mask = T(rng.random((S, 50, 70)) < 0.3)
    mask[2] = False  # a stream with nothing to match: every row all-masked
    assert_same(matcher.masked_top2(dist, mask), stacked(matcher.masked_top2, dist, mask))


def test_resolve_duplicate_targets_batched(rng):
    best_idx = T(rng.integers(0, 20, (S, 60)))  # 60 queries on 20 targets: many claims each
    best_val = T(rng.integers(0, 6, (S, 60)).astype(np.int32))
    valid = T(rng.random((S, 60)) < 0.8)
    valid[2] = False
    got = matcher.resolve_duplicate_targets(best_idx, best_val, valid, 20)
    want = stacked(lambda i, v, ok: matcher.resolve_duplicate_targets(i, v, ok, 20),
                   best_idx, best_val, valid)
    assert_same(got, want)
    for s in range(S):  # at most one query keeps each target
        kept = best_idx[s][got[s]]
        assert len(set(kept.tolist())) == len(kept)
    assert got[0].any() and not got[2].any()


def test_rotation_consistency_mask_batched(rng):
    aq = T(rng.uniform(-3.1, 3.1, (S, 300)).astype(np.float32))
    # stream 0: one dominant offset; stream 1: two offsets; stream 2: nothing valid
    off = np.stack([rng.choice([0.3, 2.0], 300, p=[0.9, 0.1]),
                    rng.choice([0.3, 2.0, -1.0], 300, p=[0.5, 0.45, 0.05]),
                    rng.uniform(-3, 3, 300)]).astype(np.float32)
    at = aq - T(off) + T(rng.normal(0, 0.02, (S, 300)).astype(np.float32))
    valid = T(rng.random((S, 300)) < 0.9)
    valid[2] = False
    got = matcher.rotation_consistency_mask(aq, at, valid)
    assert_same(got, stacked(matcher.rotation_consistency_mask, aq, at, valid))
    assert 0 < int(got[0].sum()) < int(valid[0].sum()) and not got[2].any()


def _points_problem(rng, N=160, M=220):
    """Per stream: M map points in front of a camera near the origin, N
    keypoints of which most observe a point, descriptors a few bits apart.
    The points' scale distances predict level 4, the keypoints sit on levels
    2-5, so the level window [l-1, l] admits about half of them."""
    out = []
    for s in range(S):
        pos = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 9, M)], -1)
        R = lie.so3_exp(T(rng.normal(0, 0.01, 3).astype(np.float32))).numpy()
        t = rng.normal(0, 0.02, 3)
        Xc = pos @ R.T + t
        uv = 300.0 * Xc[:, :2] / Xc[:, 2:] + np.array([160.0, 120.0])
        src = rng.permutation(M)[:N]
        kp_xy = uv[src] + rng.normal(0, 0.4, (N, 2))
        desc = rng.integers(0, 256, (M, 32), dtype=np.uint8)
        kp_desc = desc[src].copy()
        kp_desc[np.arange(N), rng.integers(0, 32, N)] ^= rng.integers(0, 256, N).astype(np.uint8)
        dist = np.linalg.norm(pos, axis=-1)
        out.append(dict(
            Rcw=R, tcw=t, pos=pos, normal=pos / dist[:, None], mind=0.5 * dist, maxd=2.0 * dist,
            valid=rng.random(M) < 0.95, bits=matcher.unpack_u8(desc).numpy(),
            kp_xy=kp_xy, kp_oct=rng.integers(2, 6, N), kp_bits=matcher.unpack_u8(kp_desc).numpy(),
            kp_valid=rng.random(N) < 0.95, src=src))
    out[2]["valid"][:] = False  # stream 2: an empty map, no valid match
    f32 = lambda k: T(np.stack([o[k] for o in out]).astype(np.float32))  # noqa: E731
    raw = lambda k: T(np.stack([o[k] for o in out]))  # noqa: E731
    return dict(Rcw=f32("Rcw"), tcw=f32("tcw"), pos=f32("pos"), normal=f32("normal"),
                mind=f32("mind"), maxd=f32("maxd"), valid=raw("valid"), bits=f32("bits"),
                kp_xy=f32("kp_xy"), kp_oct=raw("kp_oct").to(torch.int32), kp_bits=f32("kp_bits"),
                kp_valid=raw("kp_valid"), src=raw("src"))


K = T(np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]], np.float32))
BOUNDS = T(np.array([0, 320, 0, 240], np.float32))
SCALES = T((1.2 ** np.arange(8)).astype(np.float32))
INV_SIGMA2 = 1.0 / (SCALES * SCALES)


def _frustum(p):
    one = lambda R, t, pos, nrm, mind, maxd, valid: frustum.frustum_and_scale(  # noqa: E731
        R, t, K, BOUNDS, pos, nrm, mind, maxd, valid, float(np.log(1.2)), 8)
    args = (p["Rcw"], p["tcw"], p["pos"], p["normal"], p["mind"], p["maxd"], p["valid"])
    return one(*args), stacked(one, *args)


def test_frustum_and_scale_batched(rng):
    """uv and viewcos within 1e-4 px / 1e-6 (the batched matrix product may
    round differently); level and visibility equal."""
    got, want = _frustum(_points_problem(rng))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), atol=1e-6, rtol=0)
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    assert got[3][0].sum() > 100 and not got[3][2].any()


def _search(p):
    (uv, level, viewcos, visible), _ = _frustum(p)
    one = lambda xy, octv, bits, ok, uv, lvl, vc, mbits, vis: matcher.search_by_projection_points(  # noqa: E731
        xy, octv, bits, ok, torch.ones_like(ok), uv, lvl, vc, mbits, vis, SCALES, th=3.0)
    args = (p["kp_xy"], p["kp_oct"], p["kp_bits"], p["kp_valid"], uv, level, viewcos,
            p["bits"], visible)
    return one(*args), stacked(one, *args)


def test_search_by_projection_points_batched(rng):
    p = _points_problem(rng)
    got, want = _search(p)
    assert_same(got, want)
    idx, _, valid = got
    # most matches of stream 0 are the keypoint that observes the point
    right = (p["src"][0][idx[0][valid[0]]] == torch.nonzero(valid[0])[:, 0]).float().mean()
    assert int(valid[0].sum()) > 40 and right > 0.95 and not valid[2].any()
    # the radius multiplier as a per-stream tensor: streams 0 and 1 as before
    (uv, level, viewcos, visible), _ = _frustum(p)
    th = T(np.array([3.0, 3.0, 1.0], np.float32))[:, None]
    by_tensor = matcher.search_by_projection_points(
        p["kp_xy"], p["kp_oct"], p["kp_bits"], p["kp_valid"], torch.ones_like(p["kp_valid"]),
        uv, level, viewcos, p["bits"], visible, SCALES, th=th)
    for a, b in zip(by_tensor, got):
        assert torch.equal(a[:2], b[:2])


def test_scatter_rows_batched(rng):
    idx = T(np.stack([rng.permutation(40)[:25] for _ in range(S)]))
    ok = T(rng.random((S, 25)) < 0.6)
    ok[2] = False
    safe = torch.where(ok, idx, 40)
    src = T(rng.normal(size=(S, 25, 3)).astype(np.float32))
    for values, fill in ((src, 0.0), (ok, False), (src[..., 0], -1.0)):
        got = fused_track._scatter_rows(40, safe, values, fill)
        assert_same(got, stacked(lambda i, v: fused_track._scatter_rows(40, i, v, fill), safe, values))
        for s in range(S):  # against plain indexing
            want = torch.full((41,) + values.shape[2:], fill, dtype=values.dtype)
            want[safe[s]] = values[s]
            assert torch.equal(got[s], want[:40])


def _fused_inputs(rng, N=300, L=500):
    """One stream's inputs of the fused step: L local map points in front of
    the camera, N current keypoints observing N of them (descriptors a few
    bits apart, levels 3-4 as the points' scale distances predict), a last
    frame holding the same keypoints in another order, half of them bound."""
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L), rng.uniform(4, 10, L)], -1)
    desc_w = rng.integers(0, 256, (L, 32), dtype=np.uint8)
    seen = rng.permutation(L)[:N]
    t_true = np.array([0.05, -0.02, 0.03])
    Xc = X[seen] + t_true
    uv = 300.0 * Xc[:, :2] / Xc[:, 2:] + np.array([160.0, 120.0]) + rng.normal(0, 0.5, (N, 2))
    octv = rng.integers(3, 5, N)
    angle = rng.uniform(-3, 3, N)
    cur_desc = desc_w[seen].copy()
    cur_desc[np.arange(N), rng.integers(0, 32, N)] ^= rng.integers(0, 256, N).astype(np.uint8)
    perm = rng.permutation(N)
    rows = rng.permutation(L)  # local-block row -> world point
    row_of = np.empty(L, np.int64)
    row_of[rows] = np.arange(L)
    dist = np.linalg.norm(X[rows], axis=-1)
    f32 = lambda a: T(np.asarray(a, np.float32))  # noqa: E731
    return dict(
        cur=(f32(uv), T(octv.astype(np.int32)), f32(angle), T(cur_desc), T(rng.random(N) < 0.95)),
        last=(T(octv[perm].astype(np.int32)), f32(angle[perm] + rng.normal(0, 0.02, N)),
              T(desc_w[seen[perm]]), f32(X[seen[perm]]), T(rng.random(N) < 0.5),
              T(row_of[seen[perm]].astype(np.int32))),
        pred=(T(np.eye(3, dtype=np.float32)), f32(t_true + 0.01)),
        loc=(f32(X[rows]), f32(X[rows] / dist[:, None]), f32(0.5 * dist), f32(2.0 * dist),
             T(desc_w[rows]), T(rng.random(L) < 0.97)))


def test_fused_step_and_pack_control_batched(rng):
    """`FusedStep.forward` and `pack_control` at S=3 against each stream
    alone: every index, mask and count equal, und and the bound points
    equal, R within 1e-5 and t within 1e-4; the packed control buffers carry
    the same bits past their float header. Stream 1 searches with the
    widened radius (th_local 5, an (S,) tensor in the batch and a 0-d one alone);
    stream 2 has no bound last-frame point and an empty local map."""
    from ceres_mono_orb_slam2_tpu_torch.utils.config import (
        CameraConfig, ORBConfig, SlamConfig as TConfig)

    cfg = TConfig(camera=CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0),
                  orb=ORBConfig(n_features=300))
    step = fused_track.FusedStep(cfg, device="cpu")
    ins = [_fused_inputs(rng) for _ in range(S)]
    ins[2]["last"] = ins[2]["last"][:4] + (torch.zeros_like(ins[2]["last"][4]),) + ins[2]["last"][5:]
    ins[2]["loc"] = ins[2]["loc"][:5] + (torch.zeros_like(ins[2]["loc"][5]),)
    th = [1.0, 5.0, 1.0]
    alone = [step(*i["cur"], *i["last"], *i["pred"], *i["loc"], BOUNDS, torch.tensor(th[s]))
             for s, i in enumerate(ins)]
    stack = lambda key: tuple(torch.stack([i[key][k] for i in ins])  # noqa: E731
                              for k in range(len(ins[0][key])))
    out = step(*stack("cur"), *stack("last"), *stack("pred"), *stack("loc"), BOUNDS, T(th))
    packed = fused_track.pack_control(out, stack("cur")[4])
    assert packed.shape == (S, fused_track.CTL_HEADER + 300 + 500)
    for s in range(S):
        for name in out._fields:
            a, b = getattr(alone[s], name), getattr(out.stream(s), name)
            if name in ("R", "t"):
                np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5 if name == "R" else 1e-4,
                                           rtol=0, err_msg=name)
            else:
                assert torch.equal(a, b), (s, name)
        one = fused_track.pack_control(alone[s], ins[s]["cur"][4])
        assert torch.equal(packed[s][12:], one[12:])
        R, t, *rest = fused_track.unpack_control(packed[s].numpy(), 500)
        np.testing.assert_array_equal(R, out.R[s].numpy())
        np.testing.assert_array_equal(rest[0], out.m1_idx[s].numpy())
    # stage 1 and stage 2 both bind points on the live streams, none on stream 2
    assert int(out.n1_inliers[0]) > 50 and int(out.n2_inliers[0]) > int(out.n1_inliers[0]) + 20
    assert int(out.m2_valid[1].sum()) >= int(out.m2_valid[0].sum()) - 40
    assert int(out.n1_matches[2]) == 0 and int(out.n2_inliers[2]) == 0


# ------------------------------------------------------------------ lie, optim


def test_lie_batched(rng):
    """so3_project and se3_exp over a leading axis: within 1e-6 of the loop
    (batched 3x3 products)."""
    R = lie.so3_exp(T(rng.normal(0, 0.5, (S, 3)).astype(np.float32)))
    R = R + T(rng.normal(0, 1e-3, (S, 3, 3)).astype(np.float32))
    assert_same(lie.so3_project(R), stacked(lie.so3_project, R), atol=1e-6)
    xi = T(rng.normal(0, 0.3, (S, 6)).astype(np.float32))
    xi[1] = 0.0  # the small-angle branch
    assert_same(lie.se3_exp(xi), stacked(lie.se3_exp, xi), atol=1e-6)
    A, v = T(rng.normal(size=(S, 3, 3)).astype(np.float32)), T(rng.normal(size=(S, 3)).astype(np.float32))
    assert_same(lie.matvec(A, v), stacked(lambda a, b: a @ b, A, v), atol=1e-6)
    assert torch.equal(lie.matvec(A[0], v[0]), A[0] @ v[0])


def _pose_problem(rng, N=200):
    """Stream 0: a perturbed start and 10% gross outliers; stream 1: starts
    at the pose that generated noise-free data (converges at once); stream
    2: no valid observation."""
    Rs, ts, pts, uvs, ws, oks = [], [], [], [], [], []
    for s in range(S):
        X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(4, 9, N)], -1)
        R = lie.so3_exp(T(rng.normal(0, 0.05, 3).astype(np.float32))).numpy().astype(np.float64)
        t = rng.normal(0, 0.1, 3)
        Xc = X @ R.T + t
        uv = 300.0 * Xc[:, :2] / Xc[:, 2:] + np.array([160.0, 120.0])
        if s != 1:
            uv += rng.normal(0, 0.5, uv.shape)
            bad = rng.random(N) < 0.1
            uv[bad] += rng.uniform(15, 40, (int(bad.sum()), 2))
            R = R @ lie.so3_exp(T(rng.normal(0, 0.02, 3).astype(np.float32))).numpy()
            t = t + rng.normal(0, 0.05, 3)
        Rs.append(R), ts.append(t), pts.append(X), uvs.append(uv)
        ws.append(INV_SIGMA2.numpy()[rng.integers(0, 8, N)])
        oks.append(rng.random(N) < (0.0 if s == 2 else 0.9))
    f32 = lambda a: T(np.stack(a).astype(np.float32))  # noqa: E731
    return f32(Rs), f32(ts), f32(pts), f32(uvs), f32(ws), T(np.stack(oks))


def test_pose_optimization_batched(rng):
    """Per-stream damping, cost and `done`: every stream's batched solve
    equals its own solve. Inlier masks and counts equal; R within 1e-5, t
    within 1e-4, cost within 1e-3 relative (float reductions of the batch
    sum in another order)."""
    R0, t0, pts, uv, w, ok = _pose_problem(rng)
    got = optim.pose_optimization(K, R0, t0, pts, uv, w, ok)
    want = stacked(lambda *a: tuple(optim.pose_optimization(K, *a)), R0, t0, pts, uv, w, ok)
    assert got.R.shape == (S, 3, 3) and got.n_inliers.shape == (S,) and got.cost.shape == (S,)
    assert torch.equal(got.inliers, want[2]) and torch.equal(got.n_inliers, want[3])
    np.testing.assert_allclose(got.R.numpy(), want[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), want[1].numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.cost.numpy(), want[4].numpy(), rtol=1e-3, atol=1e-6)
    # stream 0 worked (outliers trimmed, pose moved), stream 1 stayed where
    # it started (converged at once, frozen while stream 0 iterated), stream
    # 2 has nothing to solve and keeps its start
    n_ok = ok.sum(-1)
    assert 0.8 * n_ok[0] < got.n_inliers[0] < n_ok[0]
    assert float((got.t[0] - t0[0]).abs().max()) > 1e-2
    assert got.n_inliers[1] == n_ok[1] and float((got.t[1] - t0[1]).abs().max()) < 1e-4
    assert got.n_inliers[2] == 0
    np.testing.assert_allclose(got.t[2].numpy(), t0[2].numpy(), atol=1e-6)


# ------------------------------------------------------- the multi-stream step


def _step_config():
    return SlamConfig(camera=CameraConfig(fx=300.0, fy=300.0, cx=160.0, cy=120.0, fps=30.0),
                      orb=ORBConfig(n_features=500))


@pytest.fixture(scope="module")
def step_runs():
    cfg = _step_config()
    h, w = 240, 320
    images, jstate = jms.synthetic_stream_state(cfg, 2, 512, seed=0, h=h, w=w)
    jres = jms.make_multistream_step(cfg, h, w)(images, jstate)
    tcfg = config_from_reference(cfg)
    tstate = stream_state_from_reference(jstate)
    tstep = tms.make_multistream_step(tcfg, h, w, device="cpu")
    tres = tstep(np.asarray(images), tstate)
    return cfg, np.asarray(images), jstate, jres, tstate, tstep, tres


def test_multistream_step_matches_jax(step_runs):
    """The same images and the same state (the JAX package's
    `synthetic_stream_state`, S=2, 240x320, 500 features, 512 map points)
    through both steps: match counts and inlier counts equal, R within 5e-4
    and t within 2e-3 (scene depth 4-9; measured 1.8e-4 and 8.2e-4: keypoints
    of pyramid levels >= 1 sit on slightly different pixels under the two
    antialiased resizes, tests/test_torch_extractor.py, and about 110
    matches a stream leave the pose that sensitive)."""
    _, _, _, jres, _, _, tres = step_runs
    jn, tn = np.asarray(jres.n_matches), tres.n_matches.numpy()
    assert (jn > 80).all(), jn  # the search really matches
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tres.n_inliers.numpy(), np.asarray(jres.n_inliers))
    np.testing.assert_allclose(tres.Rcw.numpy(), np.asarray(jres.Rcw), atol=5e-4)
    np.testing.assert_allclose(tres.tcw.numpy(), np.asarray(jres.tcw), atol=2e-3)


def test_multistream_step_equals_each_stream_alone(step_runs):
    """S=2 against each stream run alone through the same step: match and
    inlier counts equal, R within 1e-5, t within 1e-4."""
    _, images, _, _, tstate, tstep, tres = step_runs
    for s in range(2):
        one = tstep(images[s:s + 1], type(tstate)(*(a[s:s + 1] for a in tstate)))
        assert int(one.n_matches[0]) == int(tres.n_matches[s])
        assert int(one.n_inliers[0]) == int(tres.n_inliers[s])
        np.testing.assert_allclose(one.Rcw[0].numpy(), tres.Rcw[s].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(one.tcw[0].numpy(), tres.tcw[s].numpy(), atol=1e-4, rtol=0)


def test_synthetic_stream_state_matches_jax(step_runs):
    """Same seeds, same draws: the port's images equal the JAX package's, and
    its maps (built from its own extractor's keypoints) are as full."""
    cfg, images, jstate, _, _, _, _ = step_runs
    timages, tstate = tms.synthetic_stream_state(config_from_reference(cfg), 2, 512, seed=0,
                                                 h=240, w=320, device="cpu")
    np.testing.assert_array_equal(timages, images)
    for name in tms.StreamState._fields:
        a, b = getattr(tstate, name), np.asarray(getattr(jstate, name))
        assert tuple(a.shape) == b.shape, name
    nj, nt = np.asarray(jstate.map_valid).sum(-1), tstate.map_valid.sum(-1).numpy()
    assert (np.abs(nj - nt) <= 0.05 * nj).all(), (nj, nt)
    z = tstate.map_pos[..., 2][tstate.map_valid]
    assert float(z.min()) >= 4.0 and float(z.max()) <= 9.0


# --------------------------------------------------------- the batched local BA


def _ba_problem(rng, P=4, M=120, O=600):
    """The problem of tests/test_multistream.py."""
    Kc = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    pts_gt = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(4, 10, M)], -1)
    R = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    t = np.stack([np.array([0.3 * i, 0, 0], np.float32) for i in range(P)])
    op = rng.integers(0, P, O).astype(np.int32)
    oj = rng.integers(0, M, O).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", R[op], pts_gt[oj]) + t[op]
    uv = np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    pts0 = (pts_gt + rng.normal(0, 0.1, pts_gt.shape)).astype(np.float32)
    fixed = np.zeros(P, bool)
    fixed[0] = True
    return (Kc, R, t, pts0, op, oj, uv, np.ones(O, np.float32),
            np.ones(O, bool), fixed, np.ones(M, bool))


def _centres(R, t):
    return np.einsum("pij,pj->pi", np.asarray(R).transpose(0, 2, 1), -np.asarray(t))


def test_batched_local_ba(rng):
    """Three problems through the JAX batched solve, the port's batched solve
    and the port's single solve. The port's batch against its own single
    solves: camera centres within 1e-3, points within 5e-3, the same inlier
    observations; against the JAX batch: centres within 5e-3, points within
    2e-2 (the bars of tests/test_multistream.py: one pose is fixed, so the
    scale gauge is free and rounding differences drift along it)."""
    probs = [_ba_problem(np.random.default_rng(100 + s)) for s in range(S)]
    stack = lambda i: np.stack([p[i] for p in probs])  # noqa: E731
    res_j = jms.make_multistream_local_ba()(jnp.asarray(probs[0][0]),
                                            *(jnp.asarray(stack(i)) for i in range(1, 11)))
    res_b = tms.make_multistream_local_ba(device="cpu")(T(probs[0][0]),
                                                        *(T(stack(i)) for i in range(1, 11)))
    assert res_b.R.shape == (S, 4, 3, 3) and res_b.cost.shape == (S,)
    for s in range(S):
        res_s = optim.bundle_adjustment(*(T(x) for x in probs[s]))
        cb, cs, cj = _centres(res_b.R[s], res_b.t[s]), _centres(res_s.R, res_s.t), _centres(
            res_j.R[s], res_j.t[s])
        assert np.abs(cb - cs).max() < 1e-3, np.abs(cb - cs).max()
        assert np.abs(res_b.points[s].numpy() - res_s.points.numpy()).max() < 5e-3
        assert torch.equal(res_b.inlier_obs[s], res_s.inlier_obs)
        np.testing.assert_allclose(float(res_b.cost[s]), float(res_s.cost), rtol=1e-4)
        assert np.abs(cb - cj).max() < 5e-3, np.abs(cb - cj).max()
        assert np.abs(res_b.points[s].numpy() - np.asarray(res_j.points[s])).max() < 2e-2
        # the JAX single solve, as the reference's own test holds it
        res_js = joptim.bundle_adjustment(*(jnp.asarray(x) for x in probs[s]),
                                          iters_huber=5, iters_trimmed=10)
        assert np.abs(cs - _centres(res_js.R, res_js.t)).max() < 5e-3


def test_batched_local_ba_freezes_converged_streams(rng):
    """A stream whose problem is already solved converges at once and keeps
    its state while the others take all their steps: its batched result
    equals its single solve as closely as the others'."""
    probs = [_ba_problem(np.random.default_rng(200 + s)) for s in range(S)]
    solved = optim.bundle_adjustment(*(T(x) for x in probs[1]), iters_huber=10, iters_trimmed=20)
    probs[1] = probs[1][:1] + (solved.R.numpy(), solved.t.numpy(), solved.points.numpy()) + probs[1][4:]
    stack = lambda i: np.stack([p[i] for p in probs])  # noqa: E731
    res_b = optim.bundle_adjustment_streams(T(probs[0][0]), *(T(stack(i)) for i in range(1, 11)))
    for s in range(S):
        res_s = optim.bundle_adjustment(*(T(x) for x in probs[s]))
        assert np.abs(_centres(res_b.R[s], res_b.t[s]) - _centres(res_s.R, res_s.t)).max() < 1e-3
        assert np.abs(res_b.points[s].numpy() - res_s.points.numpy()).max() < 5e-3
    assert np.abs(res_b.points[1].numpy() - probs[1][3]).max() < 1e-3  # barely moved
