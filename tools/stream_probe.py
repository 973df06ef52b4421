"""Which of the mapper's operations wait for the default stream, and what
slows the mapper's host dispatch while a tracker thread runs, on one GPU.

    python tools/stream_probe.py [--busy-ms 100] [--frames 40]

The mapper's device work runs on a non-blocking stream
(`utils/graphs.owner_stream(device, "mapper")`) so that it never waits for
the frame the tracker queued on the default stream. An operation that uses
the legacy default stream inside (a synchronous copy, a library call on
stream 0) or synchronises the whole device breaks that, and then waits for
everything the tracker queued. For each operation a mapping stage calls, at
the shapes the spiral's stages give it, the probe times it on the mapper
stream (host clock, ending in a synchronisation of the mapper stream), once
with the default stream idle and once right after `--busy-ms` of a
one-thread sleep kernel (`torch.cuda._sleep`: it holds the default stream
but not the card's SMs) was queued there. An operation that waits for the
default stream takes about `--busy-ms` more the second time. Each runs once
before it is timed (library handles, lazy module loads). Prints one line a
operation.

Then the dispatch part: a mapper thread runs the triangulation of 20
neighbours x 2048 keypoints on the mapper stream again and again (host ms
of each call, ending in a synchronisation of the mapper stream), alone and
beside a tracker thread in one of these modes, each `--frames` frames: a
CUDA graph of 20,000 tiny kernels (about a replayed frame's count) replayed
on the default stream, then the tracker waits for its result: `.cpu()` (a
copy into pageable memory, as the fused frame's control copy was once
read), `pageable upload` (a host array copied to the card, queued
behind the replay: the copy and its synchronisation, as the tracker's
uploads are), `stream synchronize` (`torch.cuda.Stream.synchronize`), `event`
(an event recorded behind the replay, `Event.synchronize`, which spins
under the default device flags) or `graphs.fetch` (a pinned non-blocking
copy and one event made with `blocking=True`, on which the thread sleeps);
or `Python`: 15 ms of pure Python a frame, holding the GIL, then a 45 ms
sleep. After each call the mapper thread also times a step of pure Python
(it needs the GIL and no CUDA call), which tells a wait that holds the
GIL from one that blocks only CUDA calls. Prints the mapper's calls, median
and p95 ms in each mode, the Python step's, and the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_mono_orb_slam2_tpu_torch.ops import mapping_batch, twoview  # noqa: E402
from ceres_mono_orb_slam2_tpu_torch.utils import graphs  # noqa: E402


def sleep_cycles_per_ms() -> float:
    """Cycles of `torch.cuda._sleep` a millisecond, from two CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def operations(dev):
    """(name, fn) of the operations a mapping stage calls, at the spiral's
    shapes: 20 neighbours x 2000 keypoints (triangulation), a 4096-point
    block into 32 targets (fuse)."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, N, M = 20, 2048, 4096
    A = torch.randn((B * N, 4, 4), device=dev, generator=g)
    AtA = A @ A.transpose(-1, -2)
    H7 = torch.randn((64, 7, 7), device=dev, generator=g)
    H7 = H7 @ H7.transpose(-1, -2) + 7 * torch.eye(7, device=dev)
    v7 = torch.randn((64, 7, 1), device=dev, generator=g)
    host = np.random.default_rng(0).standard_normal((M, 32)).astype(np.float32)
    res = (torch.randn((B, N), device=dev), torch.rand((B, N), device=dev) > 0.5,
           torch.randn((B, N, 3), device=dev))
    K = torch.tensor([[500.0, 0, 620.5], [0, 500.0, 188.0], [0, 0, 1]], device=dev)
    R1, t1 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    R2 = torch.eye(3, device=dev).expand(B, 3, 3).contiguous()
    t2 = torch.randn((B, 3), device=dev, generator=g) * 0.1
    xy1 = torch.rand((N, 2), device=dev, generator=g) * torch.tensor([1241.0, 376.0], device=dev)
    xy2 = (xy1 + torch.randn((B, N, 2), device=dev, generator=g)).contiguous()
    oct1 = torch.randint(0, 8, (N,), device=dev, generator=g, dtype=torch.int32)
    oct2 = oct1.expand(B, N).contiguous()
    ang1 = torch.rand((N,), device=dev, generator=g) * 360
    ang2 = ang1.expand(B, N).contiguous()
    desc1 = torch.randint(0, 256, (N, 32), device=dev, generator=g, dtype=torch.uint8)
    desc2 = desc1.expand(B, N, 32).contiguous()
    free1, free2 = torch.ones(N, dtype=torch.bool, device=dev), torch.ones((B, N), dtype=torch.bool, device=dev)
    ls2 = torch.tensor([1.2 ** (2 * i) for i in range(8)], device=dev)
    sfs = torch.tensor([1.2 ** i for i in range(8)], device=dev)
    return [
        ("eigh, 40,960 4x4 (the triangulation's eigensolver)", lambda: twoview.smallest_eigvecs(AtA)),
        ("triangulate_with_neighbors, 20 x 2048", lambda: mapping_batch.triangulate_with_neighbors(
            K, torch.linalg.inv(K), R1, t1, xy1, oct1, ang1, desc1, free1, R2, t2, xy2, oct2, ang2, desc2,
            free2, ls2, sfs, 1.8)),
        ("solve_ex, 64 7x7", lambda: torch.linalg.solve_ex(H7, v7)),
        ("cholesky_ex, 64 7x7", lambda: torch.linalg.cholesky_ex(H7)),
        ("inv_ex, 64 7x7", lambda: torch.linalg.inv_ex(H7)),
        ("upload of a pageable (4096, 32) float32 array", lambda: torch.as_tensor(host).to(dev)),
        (".cpu() of 3 results, one at a time", lambda: [t.cpu() for t in res]),
        ("graphs.fetch of 3 results", lambda: graphs.fetch(*res)),
        ("torch.rand with a CUDA generator", lambda: torch.rand((256, 300), generator=g, device=dev)),
        ("nonzero", lambda: torch.nonzero(res[1])),
    ]


def tiny_kernel_graph(dev, n: int = 20_000):
    """A CUDA graph of n tiny kernels on a 64-element tensor, and the tensor
    it writes."""
    x = torch.zeros(64, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            x.add_(1.0)
    return g, x


def tracker_loop(mode: str, frames: int, graph, x, stop):
    """The tracker-like thread of the dispatch part (see the module
    docstring)."""
    upload = np.zeros(4096, np.float32)
    for _ in range(frames):
        if stop.is_set():
            return
        if mode == "Python":
            t = time.perf_counter()
            while time.perf_counter() - t < 0.015:
                sum(range(100))
            time.sleep(0.045)
            continue
        graph.replay()
        if mode == ".cpu()":
            x.cpu()
        elif mode == "pageable upload":
            torch.from_numpy(upload).to(x.device)
        elif mode == "stream synchronize":
            torch.cuda.current_stream().synchronize()
        elif mode == "event":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        else:
            graphs.fetch(x)


def dispatch_part(dev, mapper, frames: int):
    import threading

    with torch.cuda.stream(mapper):
        tri = operations(dev)[1][1]
    mapper.synchronize()
    graph, x = tiny_kernel_graph(dev)
    graph.replay()
    torch.cuda.synchronize()
    t = time.perf_counter()
    graph.replay()
    x.cpu()
    print(f"dispatch: one replay of the 20,000-kernel graph and its copy: "
          f"{(time.perf_counter() - t) * 1e3:.2f} ms", flush=True)
    for mode in ("alone", ".cpu()", "pageable upload", "stream synchronize", "event", "graphs.fetch",
                 "Python"):
        stop, calls, python_ms = threading.Event(), [], []
        tracker = None
        if mode != "alone":
            tracker = threading.Thread(target=tracker_loop, args=(mode, frames, graph, x, stop))
            tracker.start()

        def mapper_calls():
            for _ in range(40):
                calls.append(timed(tri, mapper))
                t = time.perf_counter()
                sum(range(100_000))  # pure Python: needs the GIL, no CUDA call
                python_ms.append((time.perf_counter() - t) * 1e3)
                if tracker is not None and not tracker.is_alive():
                    return

        worker = threading.Thread(target=mapper_calls)
        worker.start()
        worker.join()
        stop.set()
        if tracker is not None:
            tracker.join()
        torch.cuda.synchronize()
        print(f"dispatch: triangulation calls beside a tracker thread ({mode}): {len(calls)} calls, median "
              f"{np.median(calls):.2f} ms, p95 {np.percentile(calls, 95):.2f} ms; the pure-Python step after "
              f"each: median {np.median(python_ms):.2f} ms, max {max(python_ms):.2f} ms", flush=True)


def timed(fn, stream) -> float:
    t0 = time.perf_counter()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--busy-ms", type=float, default=100.0)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    mapper = graphs.owner_stream(dev, "mapper")
    cycles = int(args.busy_ms * sleep_cycles_per_ms())
    default = torch.cuda.default_stream(dev)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; the mapper stream "
          f"{graphs.stream_name(mapper)} ({hex(mapper.cuda_stream)}), default stream busy "
          f"{args.busy_ms} ms in each busy run", flush=True)
    with torch.cuda.stream(mapper):
        ops = operations(dev)
    mapper.synchronize()
    waited = []
    for name, fn in ops:
        timed(fn, mapper)  # handles, lazy loads
        idle = min(timed(fn, mapper) for _ in range(3))
        busy = []
        for _ in range(3):
            torch.cuda.synchronize()
            with torch.cuda.stream(default):
                torch.cuda._sleep(cycles)
            busy.append(timed(fn, mapper))
        torch.cuda.synchronize()
        waits = min(busy) - idle > 0.5 * args.busy_ms
        waited += [name] * waits
        print(f"  {name}: idle {idle:.3f} ms, default stream busy {min(busy):.3f} ms (min of 3), "
              f"waits for the default stream: {waits}", flush=True)
    print(f"operations that wait for the default stream: {waited}", flush=True)
    dispatch_part(dev, mapper, args.frames)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
