// Batched (2r+1)x(2r+1) patch gather around integer keypoint centres, values
// rounded through bfloat16 and returned as float32.
//
// Replaces the Pallas kernel `gather_patches_pallas` in
// ceres_mono_orb_slam2_tpu/ops/orb/kernels.py. Bit-exact to the port's plain
// gather of `img.to(torch.bfloat16).float()` (ops/orb/kernels.py): the bf16
// round-to-nearest-even is part of what the function computes (both JAX
// paths gather bf16), and at pyramid levels >= 1 the raw image is a
// non-integer float, so the IC angle sees bf16-rounded pixels there.
//
// What bounds it on an H100: bytes. At 2000 features the main path gathers
// 2000 * (31^2 + 39^2) = 5.0 M values a frame, 20 MB of f32 written and
// about as much read (the image planes stay in the 50 MB L2), i.e. ~12 us at
// 3.35 TB/s.
//
// Design: a direct gather, one block per (batch, keypoint); the block's
// threads stride over the S*S window so neighbouring threads read
// neighbouring pixels of a row. Coordinates are clamped to the image, which
// the extractor's EDGE margin makes a no-op on the main path. The TPU
// kernel's DMA windows and one-hot matmuls existed only because TPU gathers
// serialise, and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ img,
                                      const int* __restrict__ ys,
                                      const int* __restrict__ xs,
                                      float* __restrict__ out, int H, int W,
                                      int n, int radius) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int S = 2 * radius + 1;
  const int y = ys[(size_t)b * n + k];
  const int x = xs[(size_t)b * n + k];
  const float* im = img + (size_t)b * H * W;
  float* o = out + ((size_t)b * n + k) * S * S;
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    const int r = i / S;
    const int c = i - r * S;
    const int gy = min(max(y - radius + r, 0), H - 1);
    const int gx = min(max(x - radius + c, 0), W - 1);
    o[i] = __bfloat162float(__float2bfloat16_rn(im[(size_t)gy * W + gx]));
  }
}

}  // namespace

// img: (B, H, W) float32; ys, xs: (B, n) int32; out: (B, n, S, S) float32,
// all contiguous on the device. Returns the launch's cudaGetLastError().
extern "C" int gather_patches_launch(const float* img, const int* ys,
                                     const int* xs, float* out, int B, int H,
                                     int W, int n, int radius, void* stream) {
  const dim3 grid(n, B);
  gather_patches_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      img, ys, xs, out, H, W, n, radius);
  return static_cast<int>(cudaGetLastError());
}
