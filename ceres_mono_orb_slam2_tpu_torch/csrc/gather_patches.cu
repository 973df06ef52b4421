// Square patches around integer keypoint centres, for every keypoint of a
// frame batch, every pyramid level and both patch sets, in one launch; the
// values are rounded through bfloat16.
//
// Replaces the Pallas kernel `gather_patches_pallas` in
// ceres_mono_orb_slam2_tpu/ops/orb/kernels.py. Bit-exact to the port's
// plain `gather_pyramid_patches_plain` (ops/orb/kernels.py), and, with one
// level and one float32 set, to `gather_patches_plain`. The bf16
// round-to-nearest-even is part of the function (both JAX paths gather
// bf16); at pyramid levels >= 1 the raw image is a non-integer float.
//
// What bounds it on an H100: bytes. At 2000 KITTI features a frame gathers
// 2000 x (31^2 + 39^2) = 4.96 M values. The 31x31 IC-angle patches are
// written as float32 (7.7 MB); the 39x39 rBRIEF patches as uint8 (3.0 MB):
// their source is the blurred pyramid rounded to the 8-bit grid, so the
// 8-bit value rBRIEF compares (to_u8 of the bf16-rounded value, computed
// here) is the whole information, and its consumer compares it as is. The
// reads are the pixels the patches cover, from the pyramid that the
// extractor has just written and L2 still holds.
//
// Design: one launch for all levels and both sets: blockIdx.y picks the set
// (0: raw pyramid, radius 15, float32; 1: blurred pyramid, radius 19,
// uint8), blockIdx.z the frame, and each warp of a block one keypoint. A
// keypoint's level comes from the prefix of the per-level counts (the
// extractor concatenates keypoints level by level). A warp walks its patch's
// S*S outputs in order, 32 consecutive values per step, so every store of a
// warp is one contiguous run of 128 (float32) or 32 (uint8) bytes;
// coordinates are clamped to the level, which the extractor's EDGE margin
// makes a no-op on the main path. The TPU kernel's DMA windows and one-hot
// matmuls existed only because TPU gathers serialise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;  // MAX_LEVELS of ops/orb/kernels.py
constexpr int WARPS = 4;        // keypoints per block

struct Levels {
  int off[MAX_LEVELS];          // level offset within a frame's row
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int kp0[MAX_LEVELS + 1];      // prefix sum of keypoints per level
  int n;
};

struct PatchSet {
  const float* src;             // (B, batch_stride) packed pyramid
  void* out;                    // (B, N, S, S) float32 or uint8
  int radius;
  int u8;                       // 1: store to_u8 of the value
};

__device__ __forceinline__ void store(float* o, float v) { *o = v; }

// to_u8 of ops/orb/kernels.py: (v + 0.5) clamped to [0, 255], truncated
__device__ __forceinline__ void store(uint8_t* o, float v) {
  *o = static_cast<uint8_t>(fminf(fmaxf(v + 0.5f, 0.0f), 255.0f));
}

template <typename Out>
__device__ __forceinline__ void gather_patch(const float* __restrict__ im, int H, int W, int y0,
                                             int x0, int S, Out* __restrict__ o, int lane) {
  // (r, c) of output i = lane + 32 j, advanced without a loop so that the
  // unrolled iterations' loads can all be in flight together
  int r = lane / S;
  int c = lane - r * S;
  const int dr = 32 / S;
  const int dc = 32 - dr * S;
  const int SS = S * S;
#pragma unroll 4
  for (int i = lane; i < SS; i += 32) {
    const int gy = min(max(y0 + r, 0), H - 1);
    const int gx = min(max(x0 + c, 0), W - 1);
    store(o + i, __bfloat162float(__float2bfloat16_rn(__ldg(im + (size_t)gy * W + gx))));
    c += dc;
    r += dr;
    if (c >= S) {
      c -= S;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
gather_patches_kernel(const PatchSet s0, const PatchSet s1, const Levels lv,
                      const int* __restrict__ ys, const int* __restrict__ xs, const int N,
                      const long long batch_stride) {
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (k >= N) return;
  const int lane = threadIdx.x & 31;
  const PatchSet s = blockIdx.y == 0 ? s0 : s1;
  int l = 0;
  while (l + 1 < lv.n && k >= lv.kp0[l + 1]) ++l;
  const size_t kb = (size_t)blockIdx.z * N + k;
  const int S = 2 * s.radius + 1;
  const float* im = s.src + (size_t)blockIdx.z * batch_stride + lv.off[l];
  const int y0 = ys[kb] - s.radius;
  const int x0 = xs[kb] - s.radius;
  if (s.u8)
    gather_patch(im, lv.h[l], lv.w[l], y0, x0, S, static_cast<uint8_t*>(s.out) + kb * S * S, lane);
  else
    gather_patch(im, lv.h[l], lv.w[l], y0, x0, S, static_cast<float*>(s.out) + kb * S * S, lane);
}

}  // namespace

// Set i (i < n_sets <= 2): src_i a (B, batch_stride) float32 packed
// pyramid, out_i its (B, N, S_i, S_i) output, float32 or (u8_i = 1) uint8.
// ys, xs: (B, N) int32 level-local centres, level-major; table: n_levels x
// (offset, H, W) and counts: n_levels keypoint counts, int32 on the host.
// All device arrays contiguous. Returns the launch's cudaGetLastError().
extern "C" int gather_patches_launch(const float* src0, void* out0, int radius0, int u8_0,
                                     const float* src1, void* out1, int radius1, int u8_1,
                                     int n_sets, const int* ys, const int* xs, int B, int N,
                                     long long batch_stride, const int* table,
                                     const int* counts, int n_levels, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_sets < 1 || n_sets > 2 || B < 0 ||
      B > 65535 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.off[l] = table[3 * l];
    lv.h[l] = table[3 * l + 1];
    lv.w[l] = table[3 * l + 2];
    lv.kp0[l + 1] = lv.kp0[l] + counts[l];
  }
  if (B == 0 || N == 0) return 0;
  const PatchSet s0 = {src0, out0, radius0, u8_0};
  const PatchSet s1 = {src1, out1, radius1, u8_1};
  const dim3 grid((N + WARPS - 1) / WARPS, n_sets, B);
  gather_patches_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      s0, s1, lv, ys, xs, N, batch_stride);
  return static_cast<int>(cudaGetLastError());
}
