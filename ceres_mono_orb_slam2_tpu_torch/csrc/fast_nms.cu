// Fused FAST-9/16 max-threshold corner score + 3x3 non-max suppression.
//
// Replaces the Pallas kernel `fast_nms_pallas` in
// ceres_mono_orb_slam2_tpu/ops/orb/kernels.py. Bit-exact on every pixel to
// the port's plain `nms3(fast_score_map(img))` (ops/orb/kernels.py): the
// score is built from f32 subtractions, mins and maxes only, which are exact
// and order independent.
//
// What bounds it on an H100: neither bytes nor operations. One KITTI level-0
// plane is 376x1241 f32 = 1.9 MB in and 1.9 MB out (about 1 us at 3.35 TB/s),
// and the score is ~300 min/max operations a pixel (~0.14 GFLOP, about 2 us
// of the non-tensor f32 rate). At these sizes launch latency dominates.
//
// Design: one block per 32x8 output tile (one thread per output pixel).
//   1. The tile plus a 4-px halo is loaded into shared memory with the
//      coordinates clamped at the image edge: that clamp IS the edge padding
//      of fast_score_map (radius-3 circle + 1-px NMS ring = 4 px).
//   2. Scores are computed for the tile plus a 1-px ring. Ring pixels outside
//      the image score 0: the zero padding of nms3.
//   3. Each thread suppresses its pixel against the 8 neighbours with the
//      plateau tie-break (strictly greater than the 4 raster-preceding
//      neighbours, >= the 4 following ones) and writes it.
// The TPU kernel's row-band DMA and its clamped NMS border are not carried
// over; the port's plain version defines the border.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;       // tile width (one warp across a row)
constexpr int TH = 8;        // tile height
constexpr int HALO = 4;      // 3 (FAST circle) + 1 (NMS ring)
constexpr int LW = TW + 2 * HALO;
constexpr int LH = TH + 2 * HALO;
constexpr int SW = TW + 2;   // score tile incl. the 1-px ring
constexpr int SH = TH + 2;

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ out, int H, int W) {
  __shared__ float s_img[LH][LW];
  __shared__ float s_sc[SH][SW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const float* im = img + (size_t)b * H * W;
  const int tid = threadIdx.y * TW + threadIdx.x;
  constexpr int NT = TW * TH;

  for (int i = tid; i < LH * LW; i += NT) {
    const int ly = i / LW;
    const int lx = i - ly * LW;
    const int gy = min(max(y0 - HALO + ly, 0), H - 1);
    const int gx = min(max(x0 - HALO + lx, 0), W - 1);
    s_img[ly][lx] = im[(size_t)gy * W + gx];
  }
  __syncthreads();

  // Bresenham circle of radius 3 in (dy, dx), clockwise from straight up:
  // the FAST_CIRCLE table of ops/orb/kernels.py.
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW;
    const int lx = i - ly * SW;
    const int gy = y0 - 1 + ly;
    const int gx = x0 - 1 + lx;
    float s = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int cy = ly + HALO - 1;
      const int cx = lx + HALO - 1;
      const float c = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + DY[k]][cx + DX[k]] - c;
      float best = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k];
        float mx = d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          const float dd = d[(k + j) & 15];
          mn = fminf(mn, dd);
          mx = fmaxf(mx, dd);
        }
        // bright-arc min vs dark-arc min (= -max of the differences)
        const float cand = fmaxf(mn, -mx);
        best = (k == 0) ? cand : fmaxf(best, cand);
      }
      s = fmaxf(best, 0.0f);
    }
    s_sc[ly][lx] = s;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x < W && y < H) {
    const int ly = threadIdx.y + 1;
    const int lx = threadIdx.x + 1;
    const float c = s_sc[ly][lx];
    const float before = fmaxf(fmaxf(s_sc[ly - 1][lx - 1], s_sc[ly - 1][lx]),
                               fmaxf(s_sc[ly - 1][lx + 1], s_sc[ly][lx - 1]));
    const float after = fmaxf(fmaxf(s_sc[ly][lx + 1], s_sc[ly + 1][lx - 1]),
                              fmaxf(s_sc[ly + 1][lx], s_sc[ly + 1][lx + 1]));
    out[(size_t)b * H * W + (size_t)y * W + x] =
        (c > before && c >= after) ? c : 0.0f;
  }
}

}  // namespace

// img, out: (B, H, W) contiguous float32 on the device. Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int fast_nms_launch(const float* img, float* out, int B, int H,
                               int W, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
