// The strip body of the fused SAD + winner-take-all kernels for Hopper
// (sm_90a), shared by sad_wta.cu (the whole disparity range -> disparities)
// and sad_wta_key.cu (a runtime range [d_start, d_start + count) -> keys).
//
// For each d of the range it computes the fused formula exactly:
//   diff(y, x)  = |L(y, x) - R(y, x - d)|, rows outside the image are 0;
//   v(y, x)     = sum over |y' - y| <= r of diff(y', x), then
//   v(y, x)     = 255 * (2r + 1) where x < d, d the global disparity;
//   SAD(y, x)   = sum over |x' - x| <= r, 0 <= x' < W of v(y, x');
// and keeps per pixel the minimum of the keys (SAD << 16) | d, that is the
// smallest SAD and, among equal SADs, the smallest d. What leaves the kernel
// is the template parameter `Out` applied to that key: sad_wta.cu stores its
// low half, sad_wta_key.cu widens it to SAD * total + d.
//
// It serves r = 1..7 (255 * (2r + 1)^2 < 2^16: a SAD fits a half word) and
// disparities below 65536 (d, and an odd count's d + 1, fit the other half).
// About 4 integer instructions per pixel and disparity:
//   - A block of 160 threads owns 32 rows by 128 output columns. The right
//     tile is staged once in shared memory as 4-row words ([row / 4][column],
//     four vertically adjacent pixels a word) over 128 + 2r + count - 1
//     columns, the first serving the largest d of the range and the last the
//     smallest, so any column at any d is a word-aligned load and shared
//     memory shrinks with the range; each thread keeps its own left column's
//     words in registers for the whole loop.
//   - Two disparities a step share every 32-bit word: the low half carries d,
//     the high half d + 1. No half can overflow into the other: every half
//     is a true sum of at most (2r + 1)^2 <= 225 absolute differences, so it
//     stays under 2^16, and a word of two such halves is exact under 32-bit
//     adds and subtracts whatever the order. An odd count runs its last step
//     with the high half held at the invalid constant and d + 1 = d_start +
//     count in its key: the largest SAD a window can have beside a d above
//     every d of the range, so it can tie and never win.
//   - Vertical pass, one thread a column: per 4 rows two loads and two
//     __vabsdiffu4 give eight absolute differences, each computed once; byte
//     permutes spread them into (d, d + 1) halves, and one add-subtract per
//     row slides both sums down the column into a double-buffered array.
//   - Horizontal pass, after one barrier: thread t takes row t % 32 and the
//     strip of 32 outputs t / 32, reads the strip and its 2r columns of halo
//     as 16-byte loads (the row stride is an odd number of 16-byte chunks, so
//     the eight rows of a quarter warp hit eight bank groups), slides the
//     window sum in a register, and keeps one key per output: a three-way
//     unsigned minimum per pair of disparities is the whole (min, argmin)
//     update.
//   - The tile is 128 columns wide so that 1920 and 1280 divide into whole
//     tiles and a 1080p frame is 510 blocks, one wave at 4 blocks an SM.
//   - Results leave through the free sums buffer, rows coalesced.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsm_strips {

constexpr size_t kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

constexpr int kStripMaxR = 7;       // 255 * (2r + 1)^2 < 2^16: a SAD fits a half word
constexpr int kMaxDisparity = 65535;  // d, and an odd count's d + 1, fit the other half
constexpr int kStripH = 32;         // rows of a tile
constexpr int kTileW = 128;         // output columns of a tile
constexpr int kStripW = 32;         // outputs of a strip: 4 strips a row
constexpr int kHThreads = kStripH * (kTileW / kStripW);  // threads of the horizontal pass
constexpr int kStripThreads = 160;  // >= kTileW + 2 * kStripMaxR columns, whole warps

// 4-row words per staged column, and 16-byte loads per strip and its halo.
__host__ __device__ constexpr int strip_words(int r) { return (kStripH + 2 * r + 3) / 4; }
__host__ __device__ constexpr int strip_loads(int r) { return (kStripW + 2 * r + 3) / 4; }

// Row stride of the vertical sums, in words: room for the last strip's
// 16-byte loads, and an odd number of 16-byte chunks, so that the eight
// threads of a quarter warp (eight rows of one strip) hit eight bank groups.
__host__ __device__ constexpr int strip_vstride(int r) {
  const int chunks = (kTileW - kStripW) / 4 + strip_loads(r);
  return 4 * (chunks % 2 ? chunks : chunks + 1);
}

// Dynamic shared memory of a block over `count` disparities: the
// double-buffered sums and the right tile.
inline size_t strip_smem(int count, int r) {
  return sizeof(uint32_t) * (2 * kStripH * strip_vstride(r) +
                             (size_t)strip_words(r) * (kTileW + 2 * r + count - 1));
}

// Whether a range of `count` of `total` disparities at radius r runs the
// strip body: its radii, disparities that fit the key's low half, and tiles
// that fit shared memory.
inline bool takes_strips(int count, int total, int r) {
  if (r < 1 || r > kStripMaxR || total > kMaxDisparity) return false;
  return strip_smem(count, r) <= kMaxSmem;
}

// Vertical pass for one column: the packed sums of d0 (low half) and d0 + 1
// (high half) down the tile's rows, into v[i * VS]. `lw` are the column's
// left words, `rp` the right tile's words at d0's column (d0 + 1's is one
// to the left). With kBoth both disparities are valid for the column;
// without, a half whose disparity is not (ok0, ok1) loads and sums nothing
// and stays at the invalid constant that `fix` starts it from.
template <int R, int VS, bool kBoth>
__device__ __forceinline__ void pair_column(const uint32_t* lw, const uint32_t* rp, int rw,
                                            bool ok0, bool ok1, uint32_t fix, uint32_t* v) {
  constexpr int K = 2 * R + 1, HQ = strip_words(R);
  uint32_t pair[HQ * 4];  // staged row j: |diff at d0| low, |diff at d0 + 1| high
#pragma unroll
  for (int q = 0; q < HQ; ++q) {
    uint32_t a0, a1;  // four rows' absolute differences at d0 and at d0 + 1
    if (kBoth) {
      a0 = __vabsdiffu4(lw[q], rp[q * rw]);
      a1 = __vabsdiffu4(lw[q], rp[q * rw - 1]);
    } else {
      a0 = ok0 ? __vabsdiffu4(lw[q], rp[q * rw]) : 0u;
      a1 = ok1 ? __vabsdiffu4(lw[q], rp[q * rw - 1]) : 0u;
    }
    const uint32_t c01 = __byte_perm(a0, a1, 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
    const uint32_t c23 = __byte_perm(a0, a1, 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
    pair[4 * q + 0] = __byte_perm(c01, 0, 0x4140);       // a0.b0 0 a1.b0 0
    pair[4 * q + 1] = __byte_perm(c01, 0, 0x4342);
    pair[4 * q + 2] = __byte_perm(c23, 0, 0x4140);
    pair[4 * q + 3] = __byte_perm(c23, 0, 0x4342);
  }
  uint32_t s = fix;
#pragma unroll
  for (int j = 0; j < K; ++j) s += pair[j];
  v[0] = s;
#pragma unroll
  for (int i = 1; i < kStripH; ++i) {
    s += pair[i + 2 * R] - pair[i - 1];
    v[i * VS] = s;
  }
}

// (B, H, W) uint8 pairs -> (B, H, W) int32, `store` applied to each pixel's
// smallest key (SAD << 16) | d over d_start <= d < d_start + count.
template <int R, class Out>
__global__ void __launch_bounds__(kStripThreads, 4) strip_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int d_start, int count, Out store) {
  constexpr int K = 2 * R + 1;
  constexpr int CW = kTileW + 2 * R;  // columns of the vertical pass
  constexpr int HQ = strip_words(R);
  constexpr int VS = strip_vstride(R);
  constexpr int NW = strip_loads(R);
  constexpr uint32_t kInvalid = 255 * K;

  extern __shared__ __align__(16) unsigned char smem[];
  const int rw = CW + count - 1;  // staged columns of the right tile
  const int d_end = d_start + count;
  uint32_t* vs = reinterpret_cast<uint32_t*>(smem);  // [2][kStripH][VS]
  uint32_t* r4 = vs + 2 * kStripH * VS;               // [HQ][rw]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;   // first output column
  const int y0 = blockIdx.y * kStripH;  // first output row
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* lf = left + frame;
  const uint8_t* rf = right + frame;

  // Word q of a staged column packs staged rows 4q..4q+3, staged row j being
  // image row y0 - R + j; outside the image: 0. The right tile's staged
  // column col is image column x0 - R - (d_end - 1) + col. A thread gathers
  // all of a column's words before it stores any, so that its loads are in
  // flight together.
  for (int col = tid; col < rw; col += kStripThreads) {
    const int gx = x0 - R - (d_end - 1) + col;
    uint32_t words[HQ];
#pragma unroll
    for (int q = 0; q < HQ; ++q) {
      uint32_t word = 0;
      if (gx >= 0 && gx < W) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gy = y0 - R + 4 * q + b;
          if (gy >= 0 && gy < H) word |= (uint32_t)rf[(size_t)gy * W + gx] << (8 * b);
        }
      }
      words[q] = word;
    }
#pragma unroll
    for (int q = 0; q < HQ; ++q) r4[q * rw + col] = words[q];
  }

  // Vertical pass: thread tid owns image column xc, whose left words stay in
  // registers for the whole loop.
  const int xc = x0 - R + tid;
  const bool has_col = tid < CW;
  const bool in_image = xc >= 0 && xc < W;
  uint32_t lw[HQ];
#pragma unroll
  for (int q = 0; q < HQ; ++q) {
    uint32_t word = 0;
    if (has_col && in_image) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int gy = y0 - R + 4 * q + b;
        if (gy >= 0 && gy < H) word |= (uint32_t)lf[(size_t)gy * W + xc] << (8 * b);
      }
    }
    lw[q] = word;
  }
  __syncthreads();

  // Horizontal pass: thread tid < kHThreads owns row hrow, outputs
  // strip * kStripW .. + kStripW - 1, and one key (SAD << 16) | d for each.
  const int hrow = tid % kStripH;
  const int strip = tid / kStripH;
  uint32_t best[kStripW];
#pragma unroll
  for (int j = 0; j < kStripW; ++j) best[j] = 0xffffffffu;

  int buffer = 0;
  for (int d0 = d_start; d0 < d_end; d0 += 2) {
    const int d1 = d0 + 1;
    // Double buffer: a buffer is written again only after every thread has
    // passed the barrier of the step between, so its reads are done.
    uint32_t* v = vs + buffer * kStripH * VS;
    buffer ^= 1;
    if (has_col) {
      // Columns outside the image sum 0; a disparity past the column
      // (x < d), or the d1 = d_end of an odd count, holds the invalid
      // constant.
      const bool ok0 = in_image && xc >= d0;
      const bool ok1 = in_image && xc >= d1 && d1 < d_end;
      if (!ok0 && !ok1) {
        const uint32_t fill = in_image ? kInvalid * 0x10001u : 0u;
#pragma unroll
        for (int i = 0; i < kStripH; ++i) v[i * VS + tid] = fill;
      } else {
        const uint32_t* rp = r4 + tid + (d_end - 1 - d0);
        if (ok0 && ok1) {
          pair_column<R, VS, true>(lw, rp, rw, true, true, 0u, v + tid);
        } else {
          const uint32_t fix = (ok0 ? 0u : kInvalid) | (ok1 ? 0u : kInvalid << 16);
          pair_column<R, VS, false>(lw, rp, rw, ok0, ok1, fix, v + tid);
        }
      }
    }
    __syncthreads();
    if (tid < kHThreads) {
      // Output j of the strip sums columns j..j+2R of its row of v.
      const uint4* p = reinterpret_cast<const uint4*>(v + hrow * VS + strip * kStripW);
      uint32_t w[NW * 4];
#pragma unroll
      for (int m = 0; m < NW; ++m) {
        const uint4 t = p[m];
        w[4 * m + 0] = t.x;
        w[4 * m + 1] = t.y;
        w[4 * m + 2] = t.z;
        w[4 * m + 3] = t.w;
      }
      uint32_t s = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) s += w[j];
#pragma unroll
      for (int j = 0; j < kStripW; ++j) {
        if (j > 0) s += w[j + 2 * R] - w[j - 1];
        // The low half's key as one multiply-add (the high half shifts out).
        best[j] = __vimin3_u32(best[j], s * 65536u + (uint32_t)d0,
                               (s & 0xffff0000u) | (uint32_t)d1);
      }
    }
  }

  // Out through the free sums buffer, so that rows are written coalesced.
  __syncthreads();
  if (tid < kHThreads) {
    uint4* p = reinterpret_cast<uint4*>(vs + hrow * VS + strip * kStripW);
#pragma unroll
    for (int m = 0; m < kStripW / 4; ++m)
      p[m] = make_uint4(store(best[4 * m]), store(best[4 * m + 1]), store(best[4 * m + 2]),
                        store(best[4 * m + 3]));
  }
  __syncthreads();
  for (int i = tid; i < kStripH * kTileW; i += kStripThreads) {
    const int row = i / kTileW, col = i % kTileW;
    if (y0 + row < H && x0 + col < W)
      out[frame + (size_t)(y0 + row) * W + x0 + col] = (int32_t)vs[row * VS + col];
  }
}

// Launches the strip body at radius R, or with `occupancy` only asks how
// many of its blocks an SM holds at once for this range.
template <int R, class Out>
cudaError_t launch_strips(const uint8_t* left, const uint8_t* right, int32_t* out, int B, int H,
                          int W, int d_start, int count, Out store, cudaStream_t stream,
                          int* occupancy) {
  const size_t smem = strip_smem(count, R);
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<R, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(strip_kernel<R, Out>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, strip_kernel<R, Out>,
                                                         kStripThreads, smem);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kStripH - 1) / kStripH, B);
  strip_kernel<R, Out><<<grid, kStripThreads, smem, stream>>>(left, right, out, H, W, d_start,
                                                             count, store);
  return cudaGetLastError();
}

// The strip body at a runtime radius 1..kStripMaxR.
template <class Out>
cudaError_t run_strips(int r, const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H,
                       int W, int d_start, int count, Out store, cudaStream_t s,
                       int* occupancy) {
  switch (r) {
    case 1: return launch_strips<1>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
    case 2: return launch_strips<2>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
    case 3: return launch_strips<3>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
    case 4: return launch_strips<4>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
    case 5: return launch_strips<5>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
    case 6: return launch_strips<6>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
    case 7: return launch_strips<7>(l, rt, o, B, H, W, d_start, count, store, s, occupancy);
  }
  return cudaErrorInvalidValue;
}

// The first five fields of a launch plan {body, tile rows, tile columns,
// threads, blocks, blocks per SM, SMs}; the occupancy query fills the sixth.
inline void fill_plan(int* plan, bool strips, int tile_h, int tile_w, int threads, int B, int H,
                      int W) {
  plan[0] = strips;
  plan[1] = tile_h;
  plan[2] = tile_w;
  plan[3] = threads;
  plan[4] = B * ((H + tile_h - 1) / tile_h) * ((W + tile_w - 1) / tile_w);
}

// The SM count of the current device, a plan's last field.
inline cudaError_t device_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace gsm_strips
