"""The pose solve's exit at convergence, captured, on one CUDA device.

    python tools/pose_exit_probe.py [--n 2000] [--streams 1,8] [--replays 20]

`optim.pose_optimization` at the tracker's settings (4 rounds of up to 25
LM iterations) on seeded problems of N observations (a small motion from
the true pose, 10% gross outliers; with a stream axis each stream its own
scene), for each stream count S:

- eager: the plain call, which runs all 25 iterations a round under the
  `done` mask;
- "exit": a `graphs.CapturedFunction` of it, whose iterations are
  CUDA-graph IF nodes (`graphs.run_if`), skipped once every problem is done;
- "fixed": the same capture with `run_if` replaced by an unconditional
  block, as the solve was captured before its exit (every iteration
  replayed).

It prints which conditional-node and memory-pool API this torch binds (the
IF nodes come from `csrc/graph_if.cu`, built at first use), checks an IF
node on a one-op program replayed with its flag set and clear, then per S:
whether each
replay equals the eager call to the bit (R, t, inliers, n_inliers, cost,
iters), the iterations each round ran, the ms of one call (CUDA events over
`--replays` calls), the device kernels of one call (torch.profiler), and the
MB of each program's pool (its own owner) with the process's reserved MB
before and after its capture. The last line is one JSON object of all that.
Also a far start (0.3 rad off), whose rounds run more iterations.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_mono_orb_slam2_tpu_torch.ops import lie, optim  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils import graphs  # noqa: E402


def problem(rng, n: int, lead: tuple, rot_err: float):
    """(K, R0, t0, pts3d, uv, inv_sigma2, valid) on the card: points 4-8 m
    ahead, observed from the identity pose with 0.5 px noise and 10%
    outliers, solved from a start `rot_err` rad and 5 cm off."""
    pts = np.stack([rng.uniform(-3, 3, lead + (n,)), rng.uniform(-2, 2, lead + (n,)),
                    rng.uniform(4, 8, lead + (n,))], -1).astype(np.float32)
    uv = pts[..., :2] / pts[..., 2:] * 500.0 + np.float32([620.0, 188.0])
    uv = (uv + rng.standard_normal(uv.shape) * 0.5).astype(np.float32)
    uv[..., : n // 10, :] += rng.uniform(20, 60, lead + (n // 10, 2)).astype(np.float32)
    w = rng.standard_normal(lead + (3,)) * rot_err
    R0 = lie.so3_exp(torch.tensor(w, dtype=torch.float32))
    t0 = torch.tensor(rng.standard_normal(lead + (3,)) * 0.05, dtype=torch.float32)
    inv_s2 = rng.choice([1.0, 1 / 1.44, 1 / 2.07], lead + (n,)).astype(np.float32)
    valid = rng.uniform(size=lead + (n,)) > 0.02
    K = torch.tensor([[500.0, 0, 620.0], [0, 500.0, 188.0], [0, 0, 1.0]])
    return tuple(torch.as_tensor(a).cuda() for a in (K, R0, t0, pts, uv, inv_s2, valid))


def events_ms(fn, calls: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_kernels(fn) -> int:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_type() == cuda for e in prof.profiler.kineto_results.events()
               if not getattr(e, "is_hidden_event", lambda: False)())


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def if_node_check() -> dict:
    """A program of `y = x + 1` under `run_if(flag)`: its first call runs
    eagerly, so the body runs whatever the flag; its replays run the body
    only where the flag is set."""
    def fn(x, flag):
        y = x.clone()
        with graphs.run_if(flag):
            y.add_(1.0)
        return y

    prog = graphs.CapturedFunction(fn, "cuda", name="if_node_check", owner="probe_if_node_check")
    x = torch.zeros(4, device="cuda")
    flags = (False, True, False, True, False)
    got = [float(prog(x, torch.tensor(v, device="cuda"))[0]) for v in flags]
    want = [1.0] + [float(v) for v in flags[1:]]
    print(f"IF node check: flags {flags}, results {got}, expected {want}", flush=True)
    return {"flags": flags, "results": got, "ok": got == want}


def probe(args, S: int, rot_err: float, replays: int) -> dict:
    lead = () if S == 1 else (S,)
    inputs = problem(np.random.default_rng(S), args.n, lead, rot_err)
    eager = optim.PoseOptResult(*optim.pose_optimization(*inputs))
    row = {"S": S, "rot_err": rot_err, "iters": eager.iters.tolist(),
           "eager_ms": events_ms(lambda: optim.pose_optimization(*inputs), 3),
           "eager_kernels": device_kernels(lambda: optim.pose_optimization(*inputs))}
    for mode in ("exit", "fixed"):
        owner = f"probe_{mode}_{S}_{rot_err}"
        before = torch.cuda.memory_reserved() / 1e6
        fn = graphs.CapturedFunction(optim.pose_optimization, "cuda", name=f"pose_{mode}", owner=owner)
        saved = graphs.run_if
        if mode == "fixed":
            graphs.run_if = lambda pred: contextlib.nullcontext()
        try:
            first = optim.PoseOptResult(*fn(*inputs))
        finally:
            graphs.run_if = saved
        replay = optim.PoseOptResult(*fn(*inputs))
        torch.cuda.synchronize()
        row[mode] = {"replay_equals_eager": same(replay, eager), "first_equals_eager": same(first, eager),
                     "ms": events_ms(lambda: fn(*inputs), replays),
                     "kernels": device_kernels(lambda: fn(*inputs)),
                     "pool_mb": fn.pool_bytes() / 1e6, "body_pool_mb": fn.body_pool_bytes() / 1e6,
                     "if_nodes": graphs.if_nodes.get(torch.device("cuda", 0), 0),
                     "reserved_mb_before": before,
                     "reserved_mb_after": torch.cuda.memory_reserved() / 1e6}
    print(f"S={S} start {rot_err} rad: iters a round {row['iters']}; eager {row['eager_ms']:.2f} ms, "
          f"{row['eager_kernels']} kernels; " + "; ".join(
              f"{m}: replay equal {row[m]['replay_equals_eager']}, first call equal "
              f"{row[m]['first_equals_eager']}, {row[m]['ms']:.3f} ms, {row[m]['kernels']} kernels, pool "
              f"{row[m]['pool_mb']:.1f} MB, body pool {row[m]['body_pool_mb']:.1f} MB, IF nodes so far "
              f"{row[m]['if_nodes']}, reserved {row[m]['reserved_mb_before']:.1f} -> "
              f"{row[m]['reserved_mb_after']:.1f} MB" for m in ("exit", "fixed")), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--streams", default="1,8")
    ap.add_argument("--replays", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pose_exit_probe: no CUDA device", file=sys.stderr)
        return 1
    api = {m: hasattr(torch.cuda.CUDAGraph, m) for m in
           ("get_currently_capturing_graph", "begin_capture_to_if_node", "end_capture_to_conditional_node")}
    api.update({m: hasattr(torch.cuda, m) for m in ("MemPool", "use_mem_pool")})
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"conditional-node API {api}", flush=True)
    check = if_node_check()
    rows = [probe(args, int(S), rot_err, args.replays)
            for S in args.streams.split(",") for rot_err in (0.01, 0.3)]
    ok = check["ok"] and all(r[m]["replay_equals_eager"] and r[m]["first_equals_eager"]
                             for r in rows for m in ("exit", "fixed"))
    print(json.dumps({"api": api, "torch": torch.__version__, "if_node_check": check, "rows": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
