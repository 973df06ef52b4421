"""Time one gloo all_reduce SUM between local ranks, with and without CUDA.

    python tools/gloo_latency.py [--ranks 4] [--iters 100] [--cpu-only]

Starts `--ranks` processes through `parallel/mesh.spawn` (gloo, a `file://`
store) once per configuration and prints, per configuration, rank 0's mean
ms of one all_reduce of a (1000, 6) and a (100000, 3) float32 tensor, the
(P, 6) and (M, 3) sums of the sharded CG BA at 1000 poses and 100,000
points: ranks without CUDA (2 CPU threads a rank, then torch's default),
ranks on `cuda:0` reducing host tensors, and ranks on `cuda:0` reducing
device tensors (2 threads, then 1). The first two configurations separate
the host's loopback transport from the copies CUDA tensors add, which the
sharded phase of chip_smoke.py cannot tell apart. `--cpu-only` skips the
CUDA configurations.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ceres_mono_orb_slam2_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SHAPES = ((1000, 6), (100000, 3))


def latency(device, where: str, iters: int) -> dict:
    """A rank target of `mesh.spawn`: mean ms of one all_reduce SUM of each
    of SHAPES on `where` ("cpu" or "cuda"), after 5 untimed ones."""
    out = {}
    for shape in SHAPES:
        x = torch.ones(shape, device=device if where == "cuda" else "cpu")
        for _ in range(5):
            dist.all_reduce(x)
        pmesh.synchronize(x.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x)
        pmesh.synchronize(x.device)
        out[str(shape)] = (time.perf_counter() - t0) / iters * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cpu-only", action="store_true")
    args = ap.parse_args()
    configs = [("cpu", "cpu", 2), ("cpu", "cpu", None)]
    if not args.cpu_only:
        configs += [("cuda", "cpu", 2), ("cuda", "cuda", 2), ("cuda", "cuda", 1)]
    for device, where, threads in configs:
        t0 = time.perf_counter()
        ranks = pmesh.spawn(latency, args.ranks, backend="gloo", device=device,
                            args=(where, args.iters), timeout_s=300, num_threads=threads)
        print(f"ranks on {device}, tensors on {where}, threads {threads or 'default'}: "
              f"{ranks[0]} ms ({time.perf_counter() - t0:.1f} s with start-up)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
