// The strip body of the block-matching kernels for Hopper (sm_90a), shared by
// sad_wta.cu (the whole disparity range -> disparities), sad_wta_key.cu (a
// runtime range [d_start, d_start + count) -> keys) and split_phase.cu (the
// SAD volume itself, every disparity's plane). sad_wta_mma.cu, whose
// window sums run on the tensor cores, shares its tile and its launch
// helpers.
//
// For each d of the range it computes
//   diff(y, x)  = |L(y, x) - R(y, x - d)|, rows outside the image are 0;
//   v(y, x)     = sum over |y' - y| <= r of diff(y', x), then, where x < d
//                 (d the global disparity), the invalid cost of the column;
//   SAD(y, x)   = sum over |x' - x| <= r, 0 <= x' < W of v(y, x');
// and hands each step's sums to a policy, its template parameter:
//   - KeepMinKey<Out> (the fused formula: an invalid column costs the
//     full-window constant 255 * (2r + 1) at every row) keeps per pixel the
//     minimum of the keys (SAD << 16) | d, that is the smallest SAD and,
//     among equal SADs, the smallest d, and applies `Out` to that key once
//     after the loop: sad_wta.cu stores its low half, sad_wta_key.cu widens
//     it to SAD * total + d;
//   - a policy with kClipped (the unfused formula: an invalid column costs
//     `invalid` times the rows of the window that lie inside the image)
//     emits both halves of every step: split_phase.cu writes them to the
//     planes d and d + 1 of the volume.
//
// It serves r = 1..7 (255 * (2r + 1)^2 < 2^16: a SAD fits a half word) and,
// where keys are kept, disparities below 65536 (d, and an odd count's d + 1,
// fit the other half).
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
//     every d of the range, so it can tie and never win. (A policy that
//     emits every step simply does not store that half.)
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
//   - The keys leave through the free sums buffer, rows coalesced.
//   - A clipped policy's invalid half is fed, in place of the absolute
//     differences, a word that holds `invalid` for each staged row inside the
//     image and 0 for the rest, so the sliding sum is invalid * cnt(y) by
//     construction.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// double-buffered sums, the policy's `extra_words` and the right tile.
inline size_t strip_smem(int count, int r, int extra_words = 0) {
  return sizeof(uint32_t) * (2 * kStripH * strip_vstride(r) + extra_words +
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
// without, a half whose disparity is not (ok0, ok1) loads nothing: it sums
// nothing and stays at the invalid constant that `fix` starts it from, or,
// with kClipped, it sums the words `inv` (the invalid cost in the bytes of
// the staged rows inside the image) from a `fix` of 0.
template <int R, int VS, bool kBoth, bool kClipped>
__device__ __forceinline__ void pair_column(const uint32_t* lw, const uint32_t* rp, int rw,
                                            bool ok0, bool ok1, uint32_t fix,
                                            const uint32_t* inv, uint32_t* v) {
  constexpr int K = 2 * R + 1, HQ = strip_words(R);
  uint32_t pair[HQ * 4];  // staged row j: |diff at d0| low, |diff at d0 + 1| high
#pragma unroll
  for (int q = 0; q < HQ; ++q) {
    uint32_t a0, a1;  // four rows' absolute differences at d0 and at d0 + 1
    if (kBoth) {
      a0 = __vabsdiffu4(lw[q], rp[q * rw]);
      a1 = __vabsdiffu4(lw[q], rp[q * rw - 1]);
    } else {
      const uint32_t idle = kClipped ? inv[q] : 0u;
      a0 = ok0 ? __vabsdiffu4(lw[q], rp[q * rw]) : idle;
      a1 = ok1 ? __vabsdiffu4(lw[q], rp[q * rw - 1]) : idle;
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

// What a policy's hooks see of the block: its thread, tile and range, the
// horizontal pass's row and strip of this thread, the sums buffers and the
// policy's own words of shared memory (16-byte aligned).
struct Tile {
  int tid, x0, y0, hrow, strip, H, W, d_start, d_end;
  uint32_t* vs;
  uint32_t* extra;
};

// Horizontal pass of one step, after the barrier that ends its vertical
// pass: thread tid < kHThreads slides the window sum of row `hrow` along its
// strip of `v` (the packed sums of d0 and d1, VS words a row) and hands
// output j's sum to `p`. Output j of the strip sums columns j..j+2R.
template <int R, int VS, class Policy>
__device__ __forceinline__ void horizontal_pass(const uint32_t* v, const Tile& tile, Policy& p,
                                                int d0, int d1) {
  constexpr int K = 2 * R + 1;
  constexpr int NW = strip_loads(R);
  if (tile.tid >= kHThreads) return;
  const uint4* q = reinterpret_cast<const uint4*>(v + tile.hrow * VS + tile.strip * kStripW);
  uint32_t w[NW * 4];
#pragma unroll
  for (int m = 0; m < NW; ++m) {
    const uint4 t = q[m];
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
    p.sum(j, s, d0, d1);
  }
  p.end_step(tile, d0, d1);
}

// The policy that keeps, per output, the smallest key (SAD << 16) | d of the
// range and stores `store(key)` to `out` (one frame's plane) after the loop.
// Invalid columns cost the fused constant 255 * (2r + 1).
template <class Out>
struct KeepMinKey {
  static constexpr bool kClipped = false;
  static constexpr int kExtraWords = 0;
  Out store;
  int32_t* out;
  uint32_t best[kStripW];

  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int j = 0; j < kStripW; ++j) best[j] = 0xffffffffu;
  }
  __device__ __forceinline__ void before_step(const Tile&, int) {}
  // A three-way unsigned minimum per pair of disparities is the whole
  // (min, argmin) update; the low half's key is one multiply-add (the high
  // half shifts out).
  __device__ __forceinline__ void sum(int j, uint32_t s, int d0, int d1) {
    best[j] = __vimin3_u32(best[j], s * 65536u + (uint32_t)d0, (s & 0xffff0000u) | (uint32_t)d1);
  }
  __device__ __forceinline__ void end_step(const Tile&, int, int) {}
  // Out through the free sums buffer, so that rows are written coalesced.
  template <int VS>
  __device__ __forceinline__ void finish(const Tile& t) {
    __syncthreads();
    if (t.tid < kHThreads) {
      uint4* p = reinterpret_cast<uint4*>(t.vs + t.hrow * VS + t.strip * kStripW);
#pragma unroll
      for (int m = 0; m < kStripW / 4; ++m)
        p[m] = make_uint4(store(best[4 * m]), store(best[4 * m + 1]), store(best[4 * m + 2]),
                          store(best[4 * m + 3]));
    }
    __syncthreads();
    for (int i = t.tid; i < kStripH * kTileW; i += kStripThreads) {
      const int row = i / kTileW, col = i % kTileW;
      if (t.y0 + row < t.H && t.x0 + col < t.W)
        out[(size_t)(t.y0 + row) * t.W + t.x0 + col] = (int32_t)t.vs[row * VS + col];
    }
  }
};

// What the whole-range kernels store for a pixel: the d of its smallest key.
struct StoreDisparity {
  __device__ __forceinline__ uint32_t operator()(uint32_t key) const { return key & 0xffff; }
};

// One block's work: the tile (blockIdx.x, blockIdx.y) of one (H, W) uint8
// pair over the disparities d_start <= d < d_start + count, each step's
// packed sums handed to `p`.
template <int R, class Policy>
__device__ __forceinline__ void strip_body(const uint8_t* __restrict__ lf,
                                           const uint8_t* __restrict__ rf, int H, int W,
                                           int d_start, int count, Policy& p) {
  constexpr int K = 2 * R + 1;
  constexpr int CW = kTileW + 2 * R;  // columns of the vertical pass
  constexpr int HQ = strip_words(R);
  constexpr int VS = strip_vstride(R);
  constexpr uint32_t kInvalid = 255 * K;

  extern __shared__ __align__(16) unsigned char smem[];
  const int rw = CW + count - 1;  // staged columns of the right tile
  const int d_end = d_start + count;
  uint32_t* vs = reinterpret_cast<uint32_t*>(smem);                 // [2][kStripH][VS]
  uint32_t* r4 = vs + 2 * kStripH * VS + Policy::kExtraWords;        // [HQ][rw]
  uint32_t* inv = r4 + HQ * rw;                                      // [HQ], kClipped only

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;   // first output column
  const int y0 = blockIdx.y * kStripH;  // first output row

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
  // What a clipped policy's invalid half sums in place of the absolute
  // differences: `invalid` in the byte of each staged row inside the image.
  if constexpr (Policy::kClipped) {
    if (tid < HQ) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int gy = y0 - R + 4 * tid + b;
        if (gy >= 0 && gy < H) word |= p.invalid << (8 * b);
      }
      inv[tid] = word;
    }
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

  // Horizontal pass: thread tid < kHThreads owns row hrow and the outputs
  // strip * kStripW .. + kStripW - 1 of it.
  const Tile tile = {tid, x0, y0, tid % kStripH, tid / kStripH, H, W, d_start, d_end,
                     vs, vs + 2 * kStripH * VS};
  p.begin();

  int buffer = 0;
  for (int d0 = d_start; d0 < d_end; d0 += 2) {
    const int d1 = d0 + 1;
    p.before_step(tile, d0);
    // Double buffer: a buffer is written again only after every thread has
    // passed the barrier of the step between, so its reads are done.
    uint32_t* v = vs + buffer * kStripH * VS;
    buffer ^= 1;
    if (has_col) {
      // Columns outside the image sum 0; a disparity past the column
      // (x < d), or the d1 = d_end of an odd count, holds the invalid cost.
      const bool ok0 = in_image && xc >= d0;
      const bool ok1 = in_image && xc >= d1 && d1 < d_end;
      bool constant = !ok0 && !ok1;  // the whole column is one known value
      if constexpr (Policy::kClipped) constant = !in_image;
      if (constant) {
        const uint32_t fill = in_image ? kInvalid * 0x10001u : 0u;
#pragma unroll
        for (int i = 0; i < kStripH; ++i) v[i * VS + tid] = fill;
      } else {
        const uint32_t* rp = r4 + tid + (d_end - 1 - d0);
        if (ok0 && ok1) {
          pair_column<R, VS, true, false>(lw, rp, rw, true, true, 0u, inv, v + tid);
        } else {
          const uint32_t fix = Policy::kClipped
                                   ? 0u
                                   : (ok0 ? 0u : kInvalid) | (ok1 ? 0u : kInvalid << 16);
          pair_column<R, VS, false, Policy::kClipped>(lw, rp, rw, ok0, ok1, fix, inv, v + tid);
        }
      }
    }
    __syncthreads();
    horizontal_pass<R, VS>(v, tile, p, d0, d1);
  }
  p.template finish<VS>(tile);
}

// (B, H, W) uint8 pairs -> (B, H, W) int32, `store` applied to each pixel's
// smallest key (SAD << 16) | d over d_start <= d < d_start + count.
template <int R, class Out>
__global__ void __launch_bounds__(kStripThreads, 4) strip_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int d_start, int count, Out store) {
  const size_t frame = (size_t)blockIdx.z * H * W;
  KeepMinKey<Out> keep = {store, out + frame};
  strip_body<R>(left + frame, right + frame, H, W, d_start, count, keep);
}

// Launches `kernel`, a __global__ function around strip_body (or another
// body of `kThreads` threads a block), over `grid` with `smem` bytes of
// dynamic shared memory, or with `occupancy` only asks how many of its
// blocks an SM holds at once.
template <int kThreads = kStripThreads, class... Params, class... Args>
cudaError_t launch_body(void (*kernel)(Params...), size_t smem, dim3 grid, cudaStream_t stream,
                        int* occupancy, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, kThreads, smem);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The tiles of an (H, W) image, `depth` deep.
inline dim3 strip_grid(int H, int W, int depth) {
  return dim3((W + kTileW - 1) / kTileW, (H + kStripH - 1) / kStripH, depth);
}

// f(std::integral_constant<int, r>()) for a runtime radius 1..kStripMaxR.
template <class F>
cudaError_t for_radius(int r, F f) {
  switch (r) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
  }
  return cudaErrorInvalidValue;
}

// The key-keeping strip kernel at a runtime radius 1..kStripMaxR.
template <class Out>
cudaError_t run_strips(int r, const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H,
                       int W, int d_start, int count, Out store, cudaStream_t s,
                       int* occupancy) {
  return for_radius(r, [&](auto radius) {
    constexpr int R = decltype(radius)::value;
    return launch_body(strip_kernel<R, Out>, strip_smem(count, R), strip_grid(H, W, B), s,
                       occupancy, l, rt, o, H, W, d_start, count, store);
  });
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
