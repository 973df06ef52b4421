"""The batched local BA op by op, timed on one CUDA device, from the package
of any checkout.

    python tools/time_stream_ba.py [--root DIR] [--reps 5] [--replayed]

`optim.bundle_adjustment_streams` (5 Huber and 10 trimmed LM iterations) on
chip_smoke's `[multistream]` batch: S=8 windows of P=16 poses, M=2048
points and O=8192 observations (`chip_smoke.ba_window`, seeds 0-7, taken
from this checkout, so every root solves the same data). The package is
imported from `--root` (default: the checkout that holds this script), so
that two commits are compared in one call on one card:

    python tools/time_stream_ba.py --root OTHER; python tools/time_stream_ba.py

`--replayed` also times `make_multistream_local_ba(device="cuda")`, whose
LM iterations replay captured programs (where the root has them). One
warm-up call each, then `--reps` calls, each between two synchronisations
of the device. The last line is one JSON object: the root, the card's name
and power limit, the ms of every call and their median, and the costs of
the last call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--replayed", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from ceres_mono_orb_slam2_tpu_torch.ops import optim
    from ceres_mono_orb_slam2_tpu_torch.parallel import multistream as ms

    spec = importlib.util.spec_from_file_location("smoke_data", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    windows = [smoke.ba_window(s) for s in range(smoke.N_STREAMS)]
    batch = (torch.as_tensor(windows[0][0], device="cuda"),) + tuple(
        torch.as_tensor(np.stack([w[i] for w in windows]), device="cuda") for i in range(1, 11))

    def timing(solve):
        solve()  # warm-up (a capture where there is one)
        ms_all = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            ms_all.append((time.perf_counter() - t0) * 1e3)
        return {"ms": ms_all, "median_ms": float(np.median(ms_all)), "cost": res.cost.tolist()}

    out = {"root": os.path.abspath(args.root),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "op_by_op": timing(lambda: optim.bundle_adjustment_streams(*batch))}
    if args.replayed:
        solver = ms.make_multistream_local_ba(device="cuda")
        out["replayed"] = timing(lambda: solver(*batch))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
