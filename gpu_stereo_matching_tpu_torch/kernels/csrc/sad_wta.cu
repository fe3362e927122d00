// Fused SAD + winner-take-all block matching for Hopper (sm_90a).
//
// Replaces the TPU kernels in gpu_stereo_matching_tpu/kernels/sad_wta.py:
// fused_block_matching (bodies _packed_kernel and _kernel) and
// fused_block_matching_batched (_packed_batched_kernel and _batched_kernel).
// One entry serves both: a (B, H, W) uint8 pair -> (B, H, W) int32.
//
// It computes the fused TPU kernel's formula exactly, in int32, for each d
// in 0..D-1:
//   diff(y, x)  = |L(y, x) - R(y, x - d)|, rows outside the image are 0;
//   v(y, x)     = sum over |y' - y| <= r of diff(y', x), then
//   v(y, x)     = 255 * (2r + 1) where x < d (the full-window constant, also
//                 at the top and bottom r rows, unlike the unfused ops path);
//   SAD(y, x)   = sum over |x' - x| <= r, 0 <= x' < W of v(y, x');
// and keeps a running (min, argmin) updated on a strict '<' over ascending
// d, so ties go to the smallest d.
//
// What bounds it: at 1080x1920, D=64, r=5 a frame is 4 MB in and 8 MB out,
// a few microseconds of HBM time, and nothing but integer sums per pixel and
// disparity. An SM's integer pipe takes 64 lanes a clock, so the kernel is
// as fast as it has few instructions per pixel and disparity: integer
// throughput bounds it, then the barrier between its two passes.
//
// Two hand-written bodies; gsm_sad_wta_u8 picks one from (D, r) alone and
// gsm_sad_wta_body tells which:
//
// * The strip body, for r = 1..7 and D < 65536 (whose tiles fit shared
//   memory): what the rig, the CLI and the benchmarks run (r = 5). About 4
//   integer instructions per pixel and disparity.
//   - A block of 160 threads owns 32 rows by 128 output columns. The right
//     tile is staged once in shared memory as 4-row words ([row / 4][column],
//     four vertically adjacent pixels a word), so any column at any d is a
//     word-aligned load; each thread keeps its own left column's words in
//     registers for the whole loop.
//   - Two disparities a step share every 32-bit word: the low half carries d,
//     the high half d + 1. No half can overflow into the other: every half
//     is a true sum of at most (2r + 1)^2 <= 225 absolute differences, so it
//     stays under 2^16, and a word of two such halves is exact under 32-bit
//     adds and subtracts whatever the order. An odd D runs its last step with
//     the high half held at the invalid constant, whose key loses every tie.
//   - Vertical pass, one thread a column: per 4 rows two loads and two
//     __vabsdiffu4 give eight absolute differences, each computed once; byte
//     permutes spread them into (d, d + 1) halves, and one add-subtract per
//     row slides both sums down the column into a double-buffered array.
//   - Horizontal pass, after one barrier: thread t takes row t % 32 and the
//     strip of 32 outputs t / 32, reads the strip and its 2r columns of halo
//     as 16-byte loads (the row stride is an odd number of 16-byte chunks, so
//     the eight rows of a quarter warp hit eight bank groups), slides the
//     window sum in a register, and keeps one key (SAD << 16) | d per output:
//     a three-way unsigned minimum per pair of disparities is the whole
//     (min, argmin) update, ties going to the smallest d.
//   - The tile is 128 columns wide so that 1920 and 1280 divide into whole
//     tiles and a 1080p frame is 510 blocks, one wave at 4 blocks an SM. A
//     16-row tile for small launches was measured and did not pay (PERF.md).
//   - Disparities leave through the free sums buffer, rows coalesced.
// * The general body, for every other radius up to 112, r = 0 and D up to W:
//   a block of NT threads owns 32 rows and NT - 2r columns over byte tiles;
//   per d, thread c slides column c's sum down (two absolute differences a
//   row), and after the barrier adds its 2r + 1 neighbours for each row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

// ---------------------------------------------------------------------------
// The strip body: r = 1..kStripMaxR, D < 65536, two disparities a word.
// ---------------------------------------------------------------------------

constexpr int kStripMaxR = 7;       // 255 * (2r + 1)^2 < 2^16: a SAD fits a half word
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

// Dynamic shared memory of a block: the double-buffered sums and the right tile.
size_t strip_smem(int D, int r) {
  return sizeof(uint32_t) * (2 * kStripH * strip_vstride(r) +
                             (size_t)strip_words(r) * (kTileW + 2 * r + D - 1));
}

// Vertical pass for one column: the packed sums of d0 (low half) and d0 + 1
// (high half) down the tile's rows, into v[i * VS]. `lw` are the column's
// left words, `rp` the right tile's words at d0's column (d0 + 1's is one
// to the left). With kBoth both disparities are valid for the column;
// without, a half whose disparity is not (ok0, ok1) sums nothing and stays
// at the invalid constant that `fix` starts it from.
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

template <int R>
__global__ void __launch_bounds__(kStripThreads, 4) strip_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int D) {
  constexpr int K = 2 * R + 1;
  constexpr int CW = kTileW + 2 * R;  // columns of the vertical pass
  constexpr int HQ = strip_words(R);
  constexpr int VS = strip_vstride(R);
  constexpr int NW = strip_loads(R);
  constexpr uint32_t kInvalid = 255 * K;

  extern __shared__ __align__(16) unsigned char smem[];
  const int rw = CW + D - 1;  // staged columns of the right tile
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
  // column col is image column x0 - R - (D - 1) + col.
  for (int q = 0; q < HQ; ++q) {
    for (int col = tid; col < rw; col += kStripThreads) {
      const int gx = x0 - R - (D - 1) + col;
      uint32_t word = 0;
      if (gx >= 0 && gx < W) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gy = y0 - R + 4 * q + b;
          if (gy >= 0 && gy < H) word |= (uint32_t)rf[(size_t)gy * W + gx] << (8 * b);
        }
      }
      r4[q * rw + col] = word;
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

  // Horizontal pass: thread tid < kHThreads owns row hrow, outputs
  // strip * kStripW .. + kStripW - 1, and one key (SAD << 16) | d for each.
  const int hrow = tid % kStripH;
  const int strip = tid / kStripH;
  uint32_t best[kStripW];
#pragma unroll
  for (int j = 0; j < kStripW; ++j) best[j] = 0xffffffffu;

  for (int d0 = 0; d0 < D; d0 += 2) {
    const int d1 = d0 + 1;
    // Double buffer: a buffer is written again only after every thread has
    // passed the barrier of the step between, so its reads are done.
    uint32_t* v = vs + ((d0 >> 1) & 1) * kStripH * VS;
    if (has_col) {
      // Columns outside the image sum 0; a disparity past the column
      // (x < d), or the d1 = D of an odd D, holds the invalid constant.
      const bool ok0 = in_image && xc >= d0;
      const bool ok1 = in_image && xc >= d1 && d1 < D;
      if (!ok0 && !ok1) {
        const uint32_t fill = in_image ? kInvalid * 0x10001u : 0u;
#pragma unroll
        for (int i = 0; i < kStripH; ++i) v[i * VS + tid] = fill;
      } else {
        const uint32_t* rp = r4 + tid + (D - 1 - d0);
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
      p[m] = make_uint4(best[4 * m] & 0xffff, best[4 * m + 1] & 0xffff,
                        best[4 * m + 2] & 0xffff, best[4 * m + 3] & 0xffff);
  }
  __syncthreads();
  for (int i = tid; i < kStripH * kTileW; i += kStripThreads) {
    const int row = i / kTileW, col = i % kTileW;
    if (y0 + row < H && x0 + col < W)
      out[frame + (size_t)(y0 + row) * W + x0 + col] = (int32_t)vs[row * VS + col];
  }
}

// Launches the strip body, or with `occupancy` only asks how many of its
// blocks an SM holds at once.
template <int R>
cudaError_t launch_strips(const uint8_t* left, const uint8_t* right, int32_t* out,
                          int B, int H, int W, int D, cudaStream_t stream, int* occupancy) {
  const size_t smem = strip_smem(D, R);
  cudaError_t err = cudaFuncSetAttribute(
      strip_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(strip_kernel<R>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, strip_kernel<R>,
                                                         kStripThreads, smem);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kStripH - 1) / kStripH, B);
  strip_kernel<R><<<grid, kStripThreads, smem, stream>>>(left, right, out, H, W, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general body: any radius up to 112, r = 0, D up to W.
// ---------------------------------------------------------------------------

constexpr int kTileH = 32;

template <int NT>
__global__ void __launch_bounds__(NT) sad_wta_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int D, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo_rows = kTileH + 2 * r;
  const int rw = NT + D - 1;  // staged width of the right tile
  int32_t* vs = reinterpret_cast<int32_t*>(smem);               // [2][kTileH][NT]
  uint8_t* ls = smem + 2 * kTileH * NT * sizeof(int32_t);       // [halo_rows][NT]
  uint8_t* rs = ls + halo_rows * NT;                            // [halo_rows][rw]

  const int x0 = blockIdx.x * (NT - 2 * r);  // first output column
  const int y0 = blockIdx.y * kTileH;        // first output row
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* lf = left + frame;
  const uint8_t* rf = right + frame;
  const int c = threadIdx.x;

  // Staged column col holds global column x0 - r + col (left) and
  // x0 - r - (D - 1) + col (right); staged row row holds y0 - r + row.
  for (int i = c; i < halo_rows * NT; i += NT) {
    const int row = i / NT, col = i - row * NT;
    const int gy = y0 - r + row, gx = x0 - r + col;
    ls[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? lf[(size_t)gy * W + gx] : 0;
  }
  for (int i = c; i < halo_rows * rw; i += NT) {
    const int row = i / rw, col = i - row * rw;
    const int gy = y0 - r + row, gx = x0 - r - (D - 1) + col;
    rs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? rf[(size_t)gy * W + gx] : 0;
  }
  __syncthreads();

  const int k = 2 * r + 1;
  const int invalid = 255 * k;
  const int xc = x0 - r + c;  // this thread's column
  const bool is_out = c >= r && c < NT - r && xc < W;

  int best[kTileH];
  int best_d[kTileH];
#pragma unroll
  for (int i = 0; i < kTileH; ++i) {
    best[i] = INT_MAX;
    best_d[i] = 0;
  }

  for (int d = 0; d < D; ++d) {
    // Double buffer: a thread writes buffer d & 1 only after every thread
    // has passed iteration d - 1's barrier, so the reads of d - 2 are done.
    int32_t* v = vs + (d & 1) * kTileH * NT;
    if (xc < 0 || xc >= W) {
      for (int i = 0; i < kTileH; ++i) v[i * NT + c] = 0;
    } else if (xc < d) {
      for (int i = 0; i < kTileH; ++i) v[i * NT + c] = invalid;
    } else {
      const uint8_t* lcol = ls + c;
      const uint8_t* rcol = rs + c + (D - 1 - d);
      int s = 0;
      for (int j = 0; j < k; ++j) s += abs((int)lcol[j * NT] - (int)rcol[j * rw]);
      v[c] = s;
      for (int i = 1; i < kTileH; ++i) {
        const int add = i + 2 * r, sub = i - 1;
        s += abs((int)lcol[add * NT] - (int)rcol[add * rw]) -
             abs((int)lcol[sub * NT] - (int)rcol[sub * rw]);
        v[i * NT + c] = s;
      }
    }
    __syncthreads();
    if (is_out) {
#pragma unroll
      for (int i = 0; i < kTileH; ++i) {
        const int32_t* vr = v + i * NT + c - r;
        int s = 0;
        for (int j = 0; j < k; ++j) s += vr[j];
        if (s < best[i]) {
          best[i] = s;
          best_d[i] = d;
        }
      }
    }
  }

  if (is_out) {
#pragma unroll
    for (int i = 0; i < kTileH; ++i) {
      if (y0 + i < H) out[frame + (size_t)(y0 + i) * W + xc] = best_d[i];
    }
  }
}

template <int NT>
cudaError_t launch(const uint8_t* left, const uint8_t* right, int32_t* out,
                   int B, int H, int W, int D, int r, cudaStream_t stream, int* occupancy) {
  const size_t halo_rows = kTileH + 2 * r;
  const size_t smem = 2 * kTileH * NT * sizeof(int32_t) + halo_rows * NT +
                      halo_rows * (NT + D - 1);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sad_wta_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, sad_wta_kernel<NT>, NT, smem);
  const int tw = NT - 2 * r;
  dim3 grid((W + tw - 1) / tw, (H + kTileH - 1) / kTileH, B);
  sad_wta_kernel<NT><<<grid, NT, smem, stream>>>(left, right, out, H, W, D, r);
  return cudaGetLastError();
}

// Whether (D, r) runs the strip body: its radii, a d (and the odd D's d + 1)
// that fits the key's low half, and tiles that fit shared memory.
bool takes_strips(int D, int r) {
  if (r < 1 || r > kStripMaxR || D > 65535) return false;
  return strip_smem(D, r) <= kMaxSmem;
}

// Launches the body that (D, r) takes; with `plan`, launches nothing and
// fills {body, tile rows, tile columns, threads, blocks, blocks per SM}.
cudaError_t run(const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H, int W, int D,
                int r, cudaStream_t s, int* plan) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || D > W || r < 0)
    return cudaErrorInvalidValue;
  int* occupancy = plan ? &plan[5] : nullptr;
  const bool strips = takes_strips(D, r);
  const int nt = strips ? kStripThreads : 2 * r + kTileH <= 128 ? 128 : 256;
  const int tw = strips ? kTileW : nt - 2 * r;
  if (plan) {
    plan[0] = strips;
    plan[1] = strips ? kStripH : kTileH;
    plan[2] = tw;
    plan[3] = nt;
    plan[4] = B * ((H + plan[1] - 1) / plan[1]) * ((W + tw - 1) / tw);
  }
  if (strips) {
    switch (r) {
      case 1: return launch_strips<1>(l, rt, o, B, H, W, D, s, occupancy);
      case 2: return launch_strips<2>(l, rt, o, B, H, W, D, s, occupancy);
      case 3: return launch_strips<3>(l, rt, o, B, H, W, D, s, occupancy);
      case 4: return launch_strips<4>(l, rt, o, B, H, W, D, s, occupancy);
      case 5: return launch_strips<5>(l, rt, o, B, H, W, D, s, occupancy);
      case 6: return launch_strips<6>(l, rt, o, B, H, W, D, s, occupancy);
      case 7: return launch_strips<7>(l, rt, o, B, H, W, D, s, occupancy);
    }
  }
  if (nt == 128) return launch<128>(l, rt, o, B, H, W, D, r, s, occupancy);
  if (2 * r + kTileH <= 256) return launch<256>(l, rt, o, B, H, W, D, r, s, occupancy);
  return cudaErrorInvalidValue;
}

}  // namespace

// Which body (D, r) runs: 1 the strip body, 0 the general one.
extern "C" int gsm_sad_wta_body(int D, int r) { return takes_strips(D, r) ? 1 : 0; }

// How gsm_sad_wta_u8 launches this shape on the current device: plan = {body,
// tile rows, tile columns, threads, blocks, blocks per SM (the occupancy
// query's), SMs}. Launches nothing. Returns the CUDA error code.
extern "C" int gsm_sad_wta_plan(int B, int H, int W, int D, int r, int* plan) {
  int dev = 0;
  cudaError_t err = run(nullptr, nullptr, nullptr, B, H, W, D, r, nullptr, plan);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&plan[6], cudaDevAttrMultiProcessorCount, dev);
}

// (B, H, W) uint8 left/right -> (B, H, W) int32 disparity, launched on
// `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_sad_wta_u8(const void* left, const void* right, void* out,
                              int B, int H, int W, int D, int r, void* stream) {
  return run(static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
             static_cast<int32_t*>(out), B, H, W, D, r, static_cast<cudaStream_t>(stream),
             nullptr);
}
