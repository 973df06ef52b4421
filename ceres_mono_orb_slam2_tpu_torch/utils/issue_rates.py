"""The card's f32 min/max and FMA issue rates, and ptxas's report on the
kernels of `csrc/`.

    python -m ceres_mono_orb_slam2_tpu_torch.utils.issue_rates

The FAST score of `csrc/fast_nms.cu` is ~114 f32 min/max instructions
(FMNMX), which do not issue at the data sheet's FMA rate; this measures both
rates with one kernel of 8 independent instruction chains per thread, 132 x 32
blocks of 256 threads over 4096 iterations, 5 launches back to back between
one CUDA-event pair (median of 3). It then compiles each `csrc/*.cu` with
`-Xptxas -v` and prints its registers, shared memory and spills. Needs a
CUDA device and nvcc; builds into `.kernels_build/`.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

# the + 0 * s (an FFMA, on another pipe) keeps max(b, min(a, b)) unfolded
SOURCE = r"""
#include <cuda_runtime.h>
template <bool MINMAX>
__global__ void chains(float* out, int iters, float s) {
  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) { a[j] = threadIdx.x * 0.37f + j; b[j] = blockIdx.x * 0.11f - j; }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (MINMAX) { a[j] = fminf(a[j], b[j]); b[j] = fmaxf(b[j], a[j] + 0.0f * s); }
      else { a[j] = fmaf(a[j], s, b[j]); b[j] = fmaf(b[j], s, a[j]); }
    }
  }
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) r += a[j] + b[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}
extern "C" int run(int minmax, float* out, int blocks, int iters, void* stream) {
  if (minmax) chains<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters, 1.0f);
  else chains<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters, 0.999f);
  return (int)cudaGetLastError();
}
"""
BLOCKS, ITERS, CALLS, REPLAYS = 132 * 32, 4096, 5, 3


def _nvcc(*args: str) -> str:
    out = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *args],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    return out.stdout + out.stderr


def issue_rates() -> dict[str, float]:
    """Thread-level instructions per second: {"minmax": FMNMX, "fma": FFMA}."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "issue_rates.cu"
    lib_path = cuda_build.BUILD_DIR / "issue_rates.so"
    src.write_text(SOURCE)
    _nvcc("-shared", "-o", str(lib_path), str(src))
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty(BLOCKS * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, minmax in (("minmax", 1), ("fma", 0)):
        def launch():
            rc = lib.run(minmax, out.data_ptr(), BLOCKS, ITERS, stream)
            if rc != 0:
                raise RuntimeError(f"issue-rate kernel launch failed: cudaError {rc}")
        launch()
        times = []
        for _ in range(REPLAYS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(CALLS):
                launch()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3 / CALLS)
        rates[name] = BLOCKS * 256 * ITERS * 16 / float(np.median(times))
    return rates


def ptxas_report() -> list[str]:
    """ptxas's entry, register, shared-memory and spill lines of csrc/*.cu."""
    lines = []
    for src in cuda_build.sources():
        obj = cuda_build.BUILD_DIR / f"ptxas_report.{src.stem}.o"
        log = _nvcc("-Xptxas", "-v", "-c", "-o", str(obj), str(src))
        obj.unlink(missing_ok=True)
        lines += [f"{src.name}: {line.strip()}" for line in log.splitlines()
                  if "Compiling entry" in line or "Used" in line or "spill" in line]
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("issue_rates: no CUDA device")
    rates = issue_rates()
    print(f"[issue] {torch.cuda.get_device_name(0)}: thread-level f32 min/max "
          f"{rates['minmax'] / 1e12:.2f} T/s, f32 FMA {rates['fma'] / 1e12:.2f} T/s")
    for line in ptxas_report():
        print(f"[ptxas] {line}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
