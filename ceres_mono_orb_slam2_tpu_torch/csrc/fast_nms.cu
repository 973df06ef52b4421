// Fused FAST-9/16 max-threshold corner score + 3x3 non-max suppression over
// every level of a packed image pyramid, in one launch.
//
// Replaces the Pallas kernel `fast_nms_pallas` in
// ceres_mono_orb_slam2_tpu/ops/orb/kernels.py. Bit-exact on every pixel to
// the port's plain `fast_nms_pyramid_plain` (ops/orb/kernels.py):
// zero_margin(nms3(fast_score_map(level)), edge) per level.
//
// What bounds it on an H100: bytes, closely followed by operations. A KITTI
// frame (8 levels from 376x1241, 1,444,097 pixels) with the extractor's
// 19-px margin reads the 4.9 MB its scores need and writes 5.8 MB, 3.2 us
// at 3.35 TB/s; the score below costs ~120 f32 min/max/sub a pixel, ~2.2 us
// at the 67 TFLOP/s f32 rate for the pixels scored. In practice the min/max
// instructions of the scores set its time (PERF.md). A launch per level
// with 32x8 tiles (a 2.5x halo, a 33% score ring) and 16x8 independent mins
// and maxes per score reached neither bound by far.
//
// Design:
//   * One launch for the whole (B, total) pyramid. The grid walks the
//     concatenated tile list of all levels (blockIdx.x) and frames
//     (blockIdx.y); a block finds its level in the prefix table of tiles
//     passed by value. No tile straddles two levels.
//   * 64x32 output tiles of 256 threads: the 72x40 image tile (4-px halo,
//     1.4x the output) is staged in shared memory with its coordinates
//     clamped at the level's edge, which IS the edge padding of
//     fast_score_map; scores are computed once each for the tile and its
//     1-px NMS ring (66x34, 9.6% extra) into shared memory; each thread then
//     suppresses and writes 8 pixels, neighbouring threads on neighbouring
//     addresses.
//   * The 9-of-16 arc test as a sliding-window extreme over the circular
//     sequence (van Herk / Gil-Werman, blocks of 9): 57 min/max per
//     direction instead of 16x8. And since x -> fl(x - c) is monotone, the
//     differences to the centre are taken once, after the extremes:
//       score = max(fl(A - c), fl(c - B), 0),
//       A = max over arcs of the arc's min, B = min over arcs of its max,
//     which equals the plain version's max(max_k min(d), max_k min(-d)) of
//     the rounded differences d = fl(p - c) bit for bit (min, max and
//     negation are exact, and rounding commutes with them).
//   * `edge`: outputs less than `edge` px from the level border are 0 (the
//     extractor's keypoint margin); scores that only such outputs would read
//     are not computed, and a tile wholly inside the margin only writes
//     zeros. edge = 0 is the plain nms3(fast_score_map(level)).
// The TPU kernel's row-band DMA and its clamped NMS border are not carried
// over; the port's plain version defines the border (zero NMS padding).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;  // MAX_LEVELS of ops/orb/kernels.py
constexpr int TW = 64;          // output tile width
constexpr int TH = 32;          // output tile height
constexpr int NT = 256;         // threads per block
constexpr int HALO = 4;         // 3 (FAST circle) + 1 (NMS ring)
constexpr int LW = TW + 2 * HALO;
constexpr int LH = TH + 2 * HALO;
constexpr int SW = TW + 2;      // score tile incl. the 1-px ring
constexpr int SH = TH + 2;

struct Levels {
  int off[MAX_LEVELS];          // level offset within a frame's row
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int tile0[MAX_LEVELS + 1];    // prefix sum of tiles per level
  int n;
};

template <bool MIN>
__device__ __forceinline__ float pick(float a, float b) {
  return MIN ? fminf(a, b) : fmaxf(a, b);
}

// MIN: the max over the 16 circular arcs of 9 consecutive values of the
// arc's min. !MIN: the min over the arcs of the arc's max. With q[i] =
// p[i mod 16], arc k is q[k..k+8]; blocks of 9 are [0,8], [9,17], [18,26]:
// suffix extremes s0 (block 0) and s1 (block 1), prefix extremes h1
// (block 1) and h2 (block 2), and arc k = pick(suffix from k, prefix to k+8).
template <bool MIN>
__device__ __forceinline__ float arc_extreme(const float (&p)[16]) {
  float s0[9];  // s0[i] = pick(q[i..8])
  s0[8] = p[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) s0[i] = pick<MIN>(p[i], s0[i + 1]);
  float s1[9];  // s1[i] = pick(q[9+i..17]); q[16] = p[0], q[17] = p[1]
  s1[8] = p[1];
  s1[7] = pick<MIN>(p[0], s1[8]);
#pragma unroll
  for (int i = 6; i >= 0; --i) s1[i] = pick<MIN>(p[9 + i], s1[i + 1]);
  float h1[8];  // h1[i] = pick(q[9..9+i])
  h1[0] = p[9];
#pragma unroll
  for (int i = 1; i < 7; ++i) h1[i] = pick<MIN>(h1[i - 1], p[9 + i]);
  h1[7] = pick<MIN>(h1[6], p[0]);
  float h2[6];  // h2[i] = pick(q[18..18+i]); q[18+i] = p[2+i]
  h2[0] = p[2];
#pragma unroll
  for (int i = 1; i < 6; ++i) h2[i] = pick<MIN>(h2[i - 1], p[2 + i]);
  float best = pick<!MIN>(s0[0], s1[0]);  // arcs 0 and 9
#pragma unroll
  for (int k = 1; k <= 8; ++k) best = pick<!MIN>(best, pick<MIN>(s0[k], h1[k - 1]));
#pragma unroll
  for (int k = 10; k <= 15; ++k) best = pick<!MIN>(best, pick<MIN>(s1[k - 9], h2[k - 10]));
  return best;
}

__global__ void __launch_bounds__(NT)
fast_nms_kernel(const float* __restrict__ pyr, float* __restrict__ out, const Levels lv,
                const long long batch_stride, const int edge) {
  __shared__ float s_img[LH * LW];
  __shared__ float s_sc[SH * SW];

  int t = blockIdx.x;
  int l = 0;
  while (l + 1 < lv.n && t >= lv.tile0[l + 1]) ++l;
  t -= lv.tile0[l];
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int ty = t / lv.tiles_x[l];
  const int x0 = (t - ty * lv.tiles_x[l]) * TW;
  const int y0 = ty * TH;
  const size_t base = (size_t)blockIdx.y * batch_stride + lv.off[l];
  const float* im = pyr + base;
  float* o = out + base;
  const int tid = threadIdx.x;

  if (y0 + TH <= edge || y0 >= H - edge || x0 + TW <= edge || x0 >= W - edge) {
    for (int i = tid; i < TH * TW; i += NT) {
      const int y = y0 + i / TW;
      const int x = x0 + i % TW;
      if (y < H && x < W) o[(size_t)y * W + x] = 0.0f;
    }
    return;
  }

  for (int i = tid; i < LH * LW; i += NT) {
    const int ly = i / LW;
    const int lx = i - ly * LW;
    const int gy = min(max(y0 - HALO + ly, 0), H - 1);
    const int gx = min(max(x0 - HALO + lx, 0), W - 1);
    s_img[i] = im[(size_t)gy * W + gx];
  }
  __syncthreads();

  // Bresenham circle of radius 3 in (dy, dx), clockwise from straight up:
  // the FAST_CIRCLE table of ops/orb/kernels.py.
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  // scores that some unzeroed output reads: rows [edge-1, H-edge], cols
  // [edge-1, W-edge]; ring pixels outside the level score 0 (zero padding)
  const int ylo = max(edge - 1, 0), yhi = min(H - edge, H - 1);
  const int xlo = max(edge - 1, 0), xhi = min(W - edge, W - 1);
  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW;
    const int lx = i - ly * SW;
    const int gy = y0 - 1 + ly;
    const int gx = x0 - 1 + lx;
    float s = 0.0f;
    if (gy >= ylo && gy <= yhi && gx >= xlo && gx <= xhi) {
      const float* q = s_img + (ly + HALO - 1) * LW + (lx + HALO - 1);
      float p[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) p[k] = q[DY[k] * LW + DX[k]];
      const float c = q[0];
      const float a = arc_extreme<true>(p);   // brightest arc's floor
      const float b = arc_extreme<false>(p);  // darkest arc's ceiling
      s = fmaxf(fmaxf(a - c, c - b), 0.0f);
    }
    s_sc[i] = s;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += NT) {
    const int ly = i / TW;
    const int lx = i % TW;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y < H && x < W) {
      float v = 0.0f;
      if (y >= edge && y < H - edge && x >= edge && x < W - edge) {
        const float* c = s_sc + (ly + 1) * SW + (lx + 1);
        const float before = fmaxf(fmaxf(c[-SW - 1], c[-SW]), fmaxf(c[-SW + 1], c[-1]));
        const float after = fmaxf(fmaxf(c[1], c[SW - 1]), fmaxf(c[SW], c[SW + 1]));
        // plateau tie-break: > the 4 raster-preceding, >= the 4 following
        v = (c[0] > before && c[0] >= after) ? c[0] : 0.0f;
      }
      o[(size_t)y * W + x] = v;
    }
  }
}

}  // namespace

// pyr, out: (B, batch_stride) contiguous float32 on the device, one packed
// pyramid per row; table: n_levels x (offset, H, W) int32 on the host.
// Returns the cudaGetLastError() code of the launch (0 on success).
extern "C" int fast_nms_launch(const float* pyr, float* out, int B, long long batch_stride,
                               const int* table, int n_levels, int edge, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || B < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.off[l] = table[3 * l];
    lv.h[l] = table[3 * l + 1];
    lv.w[l] = table[3 * l + 2];
    lv.tiles_x[l] = (lv.w[l] + TW - 1) / TW;
    lv.tile0[l + 1] = lv.tile0[l] + lv.tiles_x[l] * ((lv.h[l] + TH - 1) / TH);
  }
  if (lv.tile0[n_levels] == 0 || B == 0) return 0;
  const dim3 grid(lv.tile0[n_levels], B);
  fast_nms_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(pyr, out, lv,
                                                                     batch_stride, edge);
  return static_cast<int>(cudaGetLastError());
}
