"""The batched multi-stream local BA and the loop closer's Sim(3) refinement
through their captured LM iterations, staged on the CPU.

`make_multistream_local_ba` replays `optim.lm_iteration_streams_robust` /
`_trimmed` and `LoopClosing.refine_sim3` replays `sim3opt.sim3_lm_iteration`
(`utils/graphs.CapturedFunction`, which on the CPU stages and clones without
capture): the bits of the direct calls. Against the JAX package: each of S = 2
streams within `test_torch_multistream.py::test_batched_local_ba`'s bars of
the JAX `make_multistream_local_ba` (camera centres 5e-3, points 2e-2); the
refinement padded to the loop closer's row capacity within s 1e-4, R 1e-5,
t 1e-4 of the JAX `optimize_sim3` at the JAX loop closer's `bucket(N)`
padding, with equal inliers on the live rows. About 15 s alone."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops import lie as jlie
from ceres_mono_orb_slam2_tpu.ops import sim3opt as jopt
from ceres_mono_orb_slam2_tpu.parallel import multistream as jms
from ceres_mono_orb_slam2_tpu_torch.models.loopclosing import LoopClosing
from ceres_mono_orb_slam2_tpu_torch.models.map import Map
from ceres_mono_orb_slam2_tpu_torch.ops import optim, sim3opt
from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as tms
from ceres_mono_orb_slam2_tpu_torch.utils.config import SlamConfig
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE
from ceres_mono_orb_slam2_tpu_torch.utils.padding import bucket, pad_rows
from test_torch_multistream import _ba_problem, _centres
from test_torch_sim3 import K, XI_TRUE, two_view

torch.set_num_threads(2)
S = 2
ROWS = 1000  # the loop closer's row capacity in these tests (a keyframe's keypoints)


def T(a):
    return torch.from_numpy(np.array(a))


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def windows():
    """S windows of one shape as numpy (K, then the stacked arguments)."""
    probs = [_ba_problem(np.random.default_rng(300 + s), P=4, M=100, O=400) for s in range(S)]
    return probs[0][0], [np.stack([p[i] for p in probs]) for i in range(1, 11)]


def test_staged_stream_ba_equals_direct(windows):
    """The solve with the steps passed eagerly, and the solver of
    `make_multistream_local_ba` (staged, graphs=True; plain by default on the
    CPU), equal the direct call to the bit; one program a pass, called once an
    iteration, the same programs for a second solve."""
    Kc, args = windows
    args = [T(Kc)] + [T(a) for a in args]
    direct = optim.bundle_adjustment_streams(*args)
    eager = optim.bundle_adjustment_streams(*args, robust_step=optim.lm_iteration_streams_robust,
                                            trimmed_step=optim.lm_iteration_streams_trimmed)
    assert _same(eager, direct)
    solve = tms.make_multistream_local_ba(device="cpu", graphs=True)
    assert _same(solve(*args), direct) and _same(solve(*args), direct)
    assert [(p["name"], p["calls"]) for f in solve.captured() for p in f.report()] == [
        ("stream_lba_lm_robust", 10), ("stream_lba_lm_trimmed", 20)]
    plain = tms.make_multistream_local_ba(device="cpu")
    assert _same(plain(*args), direct) and plain.captured() == []
    # every index block is as wide as a power of two
    prob = optim.ba_streams_problem(*args[:1], *args[4:8], args[9], args[10])
    for index in (prob.by_pose, prob.by_point, prob.by_pair):
        width = index.shape[1]
        assert width & (width - 1) == 0


def test_stream_ba_solver_runs_on_the_card_by_default(windows):
    """Like every entry point of the port, the solver runs on the card
    unless the caller asks for the CPU: numpy inputs are not sent to the
    CPU quietly, and where CUDA is absent the factory raises."""
    default = inspect.signature(tms.make_multistream_local_ba).parameters["device"].default
    assert default == DEFAULT_DEVICE == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tms.make_multistream_local_ba()
    Kc, args = windows
    res = tms.make_multistream_local_ba(device="cpu")(Kc, *args)
    assert res.R.device.type == "cpu" and res.R.shape == (S, 4, 3, 3)


def test_steps_refuse_another_huber_width(windows):
    """A step passed with a `chi2_th` other than the one its Huber width was
    made for raises, in the batched BA and in the Sim(3) refinement."""
    Kc, args = windows
    args = [T(Kc)] + [T(a) for a in args]
    with pytest.raises(ValueError, match="Huber width"):
        optim.bundle_adjustment_streams(*args, chi2_th=9.0, robust_step=optim.lm_iteration_streams_robust)
    arrays, start = _sim3_live(2)
    with pytest.raises(ValueError, match="Huber width"):
        sim3opt.optimize_sim3(T(K), T(K), *(T(a) for a in arrays), torch.ones(80, dtype=torch.bool),
                              *(T(a) for a in start), chi2_th=9.0, step=sim3opt.sim3_lm_iteration)


def test_stream_ba_matches_jax(windows):
    """Each stream of the staged solve within the bars
    `test_batched_local_ba` holds the port's batch to against the JAX batch:
    camera centres within 5e-3, points within 2e-2."""
    Kc, args = windows
    res_j = jms.make_multistream_local_ba()(jnp.asarray(Kc), *(jnp.asarray(a) for a in args))
    res_t = tms.make_multistream_local_ba(device="cpu", graphs=True)(T(Kc), *(T(a) for a in args))
    for s in range(S):
        cj, ct = _centres(res_j.R[s], res_j.t[s]), _centres(res_t.R[s], res_t.t[s])
        assert np.abs(ct - cj).max() < 5e-3, np.abs(ct - cj).max()
        assert np.abs(res_t.points[s].numpy() - np.asarray(res_j.points[s])).max() < 2e-2


def _sim3_live(seed: int):
    """The matches of `two_view(seed)` with 5 gross ones, numpy at the live
    count, and a perturbed start."""
    (_, _, _), X1, X2, uv1, uv2, w1, w2 = two_view(seed, n=80, noise_px=0.3)
    uv1[:5] += 40.0
    xi0 = XI_TRUE + np.array([0.05, -0.04, 0.06, 0.02, 0.02, -0.02, 0.08], np.float32)
    R0, t0, s0 = (np.asarray(a) for a in jlie.sim3_exp(jnp.asarray(xi0)))
    return (X1, X2, uv1, uv2, w1, w2), (R0, t0, np.float32(s0))


def _jax_loop_closer_padding(arrays):
    """The JAX loop closer's refinement inputs: `bucket(N)` rows, valid
    False, z = 1 and weight 1 on the padding."""
    X1, X2, uv1, uv2, w1, w2 = arrays
    n, nb = len(X1), bucket(len(X1))
    X1, X2 = pad_rows(X1, nb), pad_rows(X2, nb)
    X1[n:, 2] = X2[n:, 2] = 1.0
    return (X1, X2, pad_rows(uv1, nb), pad_rows(uv2, nb), pad_rows(w1, nb, 1), pad_rows(w2, nb, 1),
            np.arange(nb) < n)


def _loop_closer(graphs: bool) -> LoopClosing:
    return LoopClosing(SlamConfig(), Map(), None, device="cpu", graphs=graphs)


@pytest.mark.parametrize("seed", [2, 5])
def test_loop_closer_refinement_matches_jax(seed):
    """`LoopClosing.refine_sim3` at the row capacity: its staged program
    equals graphs=False to the bit, and both agree with the JAX
    `optimize_sim3` at `bucket(N)` rows (s 1e-4, R 1e-5, t 1e-4, equal live
    inliers)."""
    arrays, start = _sim3_live(seed)
    lcs = [_loop_closer(g) for g in (True, False)]
    staged, eager = (lc.refine_sim3(arrays, *(T(a) for a in start), rows=ROWS) for lc in lcs)
    assert _same(staged, eager)
    assert staged.inliers.shape == (ROWS,) and not staged.inliers[80:].any()
    jr = jopt.optimize_sim3(jnp.asarray(K), jnp.asarray(K),
                            *(jnp.asarray(a) for a in _jax_loop_closer_padding(arrays)),
                            *(jnp.asarray(a) for a in start))
    np.testing.assert_allclose(staged.R.numpy(), np.asarray(jr.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(staged.t.numpy(), np.asarray(jr.t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(staged.s), float(jr.s), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(staged.inliers[:80].numpy(), np.asarray(jr.inliers)[:80])
    assert int(staged.n_inliers) == int(jr.n_inliers) >= 70


def test_loop_closer_refinements_share_one_program():
    """Two refinements of different match counts pad to one row count: one
    program, called once an iteration of each; the direct `optimize_sim3`
    of the padded inputs gives the same bits."""
    lc = _loop_closer(True)
    a1, s1 = _sim3_live(2)
    a2, s2 = _sim3_live(5)
    a2 = tuple(a[:60] for a in a2)
    lc.refine_sim3(a1, *(T(a) for a in s1), rows=ROWS)
    res = lc.refine_sim3(a2, *(T(a) for a in s2), rows=ROWS)
    report = lc._sim3_step.report()
    assert [p["calls"] for p in report] == [30] and [ROWS, 3] in report[0]["shapes"]
    padded = [pad_rows(a, ROWS, f) for a, f in zip(a2, (0, 0, 0, 0, 1, 1))]
    padded[0][60:, 2] = padded[1][60:, 2] = 1.0
    direct = sim3opt.optimize_sim3(T(K), T(K), *(T(a) for a in padded), T(np.arange(ROWS) < 60),
                                   *(T(a) for a in s2))
    assert _same(res, direct)


def test_loop_closer_refinement_raises_past_the_capacity():
    """More matches than the row capacity raise; nothing is truncated."""
    arrays, start = _sim3_live(2)
    with pytest.raises(ValueError, match="row capacity"):
        _loop_closer(True).refine_sim3(arrays, *(T(a) for a in start), rows=64)
