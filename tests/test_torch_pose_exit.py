"""The pose solve's exit at convergence (`optim.pose_optimization` under
`graphs.run_if`), on the CPU.

In a captured program each LM iteration is a CUDA-graph IF node on
`(~done).any()`; eagerly every iteration runs under the `done` mask. Here a
host emulation of the IF node (`HostIf`: it skips the `with` body where the
predicate is false) stands in for the replay, so these tests hold:

- the result with the skipped iterations equals the plain call to the bit
  (R, t, inliers, n_inliers, cost and iters): early convergence, a round
  that runs all 25 iterations, and a batch of 3 streams that converge at
  different iterations;
- the loop state (R, t, cost, lam, done) keeps its storage through a round,
  which a captured IF node needs and a host emulation alone cannot see;
- `iters` counts the iterations each round ran before `done`, as the host
  sees them;
- `run_if` on a CPU tensor runs its body and never asks CUDA about capture.

About 3 s on 2 threads.
"""

import sys

import numpy as np
import pytest
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import lie, optim
from ceres_mono_orb_slam2_tpu_torch.utils import graphs

torch.set_num_threads(2)

K = torch.tensor([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]])
STATE = ("R", "t", "cost", "lam", "done")


def _problem(seed: int, n: int = 120, lead: tuple = (), rot: float = 0.01, trans: float = 0.05,
             noise: float = 0.5, outliers: float = 0.1):
    """(R0, t0, pts3d, uv, inv_sigma2, valid): points 4-8 m ahead seen from
    the identity pose, `outliers` of them moved 20-60 px, solved from a
    start `rot` rad and `trans` m off."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, lead + (n,)), rng.uniform(-2, 2, lead + (n,)),
                    rng.uniform(4, 8, lead + (n,))], -1).astype(np.float32)
    uv = pts[..., :2] / pts[..., 2:] * 500.0 + np.float32([320.0, 240.0])
    uv = (uv + rng.standard_normal(uv.shape) * noise).astype(np.float32)
    m = int(n * outliers)
    uv[..., :m, :] += rng.uniform(20, 60, lead + (m, 2)).astype(np.float32)
    R0 = lie.so3_exp(torch.tensor(rng.standard_normal(lead + (3,)) * rot, dtype=torch.float32))
    t0 = torch.tensor(rng.standard_normal(lead + (3,)) * trans, dtype=torch.float32)
    inv_s2 = rng.choice([1.0, 1 / 1.44], lead + (n,)).astype(np.float32)
    return (R0, t0) + tuple(torch.as_tensor(a) for a in (pts, uv, inv_s2, np.ones(lead + (n,), bool)))


def _batch(seeds, **kw):
    return tuple(torch.stack(a) for a in zip(*(_problem(s, **kw) for s in seeds)))


CASES = {
    "converges_early": lambda: _problem(0),
    "round_of_25": lambda: _problem(1, rot=0.05, trans=0.3, noise=2.0, outliers=0.45),
    "batch_of_3": lambda: _batch((0, 3, 5), rot=0.3, trans=0.3),
}


class _Skip(Exception):
    pass


class HostIf:
    """`graphs.run_if` as an IF node on the host: the body runs only where
    `pred` is true (a trace function raises at the body's first line,
    `__exit__` swallows it). Every entry is logged with the solver's round,
    `done` and the storage of its loop state."""

    log: list = []

    def __init__(self, pred):
        self.run = bool(pred)

    def __enter__(self):
        frame = sys._getframe(1)
        loc = frame.f_locals
        self.entry = {"k": loc["k"], "run": self.run, "done": loc["done"].clone(),
                      "ptrs": {name: loc[name].data_ptr() for name in STATE}}
        HostIf.log.append(self.entry)
        self.frame = frame
        if not self.run:
            sys.settrace(lambda *a: None)
            frame.f_trace = self._skip
        return self

    @staticmethod
    def _skip(frame, event, arg):
        raise _Skip

    def __exit__(self, exc_type, exc, tb):
        if not self.run:
            sys.settrace(None)
            self.frame.f_trace = None
        loc = self.frame.f_locals
        self.entry["ptrs_after"] = {name: loc[name].data_ptr() for name in STATE}
        return exc_type is _Skip


@pytest.fixture()
def host_if(monkeypatch):
    HostIf.log = []
    monkeypatch.setattr(graphs, "run_if", HostIf)
    return HostIf.log


def _solve(inputs):
    return optim.pose_optimization(K, *inputs)


@pytest.mark.parametrize("case", list(CASES))
def test_skipped_iterations_equal_the_plain_call(case, monkeypatch):
    inputs = CASES[case]()
    plain = _solve(inputs)
    HostIf.log = []
    monkeypatch.setattr(graphs, "run_if", HostIf)
    skipped = _solve(inputs)
    log = HostIf.log
    for name, a, b in zip(optim.PoseOptResult._fields, plain, skipped):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert len(log) == 4 * 25 and sum(e["run"] for e in log) == int(plain.iters.sum())
    assert not all(e["run"] for e in log), "no iteration was skipped"
    if case == "round_of_25":
        assert int(plain.iters.max()) == 25
    else:
        assert int(plain.iters.max()) < 25
    if case == "batch_of_3":
        # the round's iteration at which each stream is done, as the host sees it
        finish = [[sum(1 for e in log if e["k"] == k and not bool(e["done"][s])) for s in range(3)]
                  for k in range(4)]
        assert any(len(set(f)) == 3 for f in finish), finish
        assert [max(f) for f in finish] == plain.iters.tolist()


def test_loop_state_is_written_in_place(host_if):
    """R, t, cost, lam and done keep their storage through every iteration
    of a round, run or skipped: an IF node's body must write the state that
    the nodes after it read, not bind new tensors."""
    _solve(CASES["batch_of_3"]())
    assert len(host_if) == 100
    for k in range(4):
        entries = [e for e in host_if if e["k"] == k]
        first = entries[0]["ptrs"]
        for e in entries:
            assert e["ptrs"] == first and e["ptrs_after"] == first, (k, e)


@pytest.mark.parametrize("case", list(CASES))
def test_iters_counts_the_iterations_before_done(case, host_if):
    res = _solve(CASES[case]())
    host = [sum(1 for e in host_if if e["k"] == k and not bool(e["done"].all())) for k in range(4)]
    assert res.iters.dtype == torch.int32 and res.iters.tolist() == host


def test_run_if_on_a_cpu_tensor_runs_its_body(monkeypatch):
    def no_query():
        raise AssertionError("run_if asked CUDA about capture for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", no_query)
    ran = []
    for flag in (True, False):
        with graphs.run_if(torch.tensor(flag)):
            ran.append(flag)
    assert ran == [True, False]
