// Fused SAD + winner-take-all block matching with the vertical window sum on
// the integer tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel body _packed_pair_body_mxu of
// gpu_stereo_matching_tpu/kernels/sad_wta.py: fused_block_matching(...,
// mxu=True), whose vertical sum is a banded 0/1 matrix product on the
// matrix unit (_banded_vertical_matrix). It computes the same function as
// sad_wta.cu, bit for bit: a (B, H, W) uint8 pair -> (B, H, W) int32
// disparity by the fused formula (sad_wta.cu's header), over the packed-pair
// configurations only: D even, 2 <= D <= 256, r = 1..5 (255 * (2r + 1)^2 <
// 2^15).
//
// What bounds it: the same work as sad_wta.cu (integer sums per pixel and
// disparity; a frame's bytes are a few microseconds of HBM time). The
// design moves the vertical sums, half of the strip body's adds, from the
// integer pipe to the tensor cores, and keeps the rest on CUDA cores:
//
// * A block of 160 threads (5 warps) owns 32 rows by 128 output columns, as
//   the strip body's; the vertical pass covers 128 + 2r columns in 8-column
//   n-tiles. Both images are staged once in shared memory as 4-row words,
//   12 a column ([column][12]: 48 staged rows, rows outside the image 0),
//   so that a B fragment register is one word and the 32 lanes' loads of
//   one fragment hit 32 banks.
// * Vertical pass, per disparity and n-tile, one warp: the absolute
//   differences are __vabsdiffu4 of a left word (kept in registers for the
//   whole loop) and a right word, four vertically adjacent pixels of one
//   column: the B fragment of mma.sync.m16n8k32.row.col.s32.u8.u8.s32 as it
//   stands (b0 = K rows 4t..4t+3 of column g, b1 = K rows 16+4t..16+4t+3).
//   A is the 16x32 0/1 band, A[i][j] = 1 for i <= j < i + 2r + 1, in four
//   registers for the whole kernel. The tile's 32 output rows are two
//   m-tiles whose K windows start at staged rows 0 and 16 (word-aligned),
//   each within 32 rows since 15 + 2r < 32: two products a disparity and
//   n-tile, three difference words. The operands are u8 (a difference
//   reaches 255), the sums exact in s32 (at most 255 * 11).
// * Then CUDA cores: the accumulators of d and d + 1 are packed into one
//   word (low half d, high half d + 1), a column x < d takes the invalid
//   constant 255 * (2r + 1) in its half, a column outside the image 0, and
//   the words go to the strip body's double-buffered sums; after one
//   barrier, sad_strips.cuh's horizontal pass and KeepMinKey policy finish
//   the step. A half cannot carry: 255 * (2r + 1)^2 < 2^16.
//
// Plain mma.sync (warp-level, sm_80's instruction) is the first design;
// wgmma, TMA and a redesign of the epilogue are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sad_strips.cuh"

namespace {

using gsm_strips::kMaxSmem;
using gsm_strips::kStripH;
using gsm_strips::kStripThreads;
using gsm_strips::kTileW;
using gsm_strips::StoreDisparity;

constexpr int kMmaMaxR = 5;          // 255 * (2r + 1)^2 < 2^15, the packed-pair rule
constexpr int kMmaMaxD = 256;
constexpr int kWords = 12;           // 4-row words a staged column: 48 rows
constexpr int kWarps = kStripThreads / 32;

// N-tiles of the vertical pass and the columns they cover.
__host__ __device__ constexpr int mma_ntiles(int r) { return (kTileW + 2 * r + 7) / 8; }
__host__ __device__ constexpr int mma_cols(int r) { return 8 * mma_ntiles(r); }

// Dynamic shared memory of a block over D disparities: the double-buffered
// sums, the left tile and the right tile, 12 words a column.
inline size_t mma_smem(int D, int r) {
  return sizeof(uint32_t) * (2 * kStripH * gsm_strips::strip_vstride(r) +
                             (size_t)kWords * (2 * mma_cols(r) + D - 1));
}

inline bool mma_supported(int D, int r) {
  return D % 2 == 0 && D >= 2 && D <= kMmaMaxD && r >= 1 && r <= kMmaMaxR;
}

// D (16x8, s32) = A (16x32, u8, row) * B (32x8, u8, col), C = 0.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// Byte e of the A register that holds row `row`, columns col0..col0+3 of
// the band: 1 where row <= col0 + e < row + K.
__device__ __forceinline__ uint32_t band_word(int row, int col0, int K) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = col0 + e;
    if (j >= row && j < row + K) w |= 1u << (8 * e);
  }
  return w;
}

// Stages `cols` columns of one image as 12 words each, column col being
// image column gx0 + col, word q packing staged rows 4q..4q+3 (staged row j
// is image row y0 - R + j; outside the image 0).
template <int R>
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint8_t* __restrict__ img, int H,
                                            int W, int y0, int gx0, int cols) {
  for (int col = threadIdx.x; col < cols; col += kStripThreads) {
    const int gx = gx0 + col;
    uint32_t words[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      uint32_t word = 0;
      if (gx >= 0 && gx < W) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gy = y0 - R + 4 * q + b;
          if (gy >= 0 && gy < H) word |= (uint32_t)img[(size_t)gy * W + gx] << (8 * b);
        }
      }
      words[q] = word;
    }
    uint4* out = reinterpret_cast<uint4*>(dst + col * kWords);
#pragma unroll
    for (int m = 0; m < kWords / 4; ++m)
      out[m] = make_uint4(words[4 * m], words[4 * m + 1], words[4 * m + 2], words[4 * m + 3]);
  }
}

// The packed word of one column: the sums of d0 (low half) and d1 (high
// half), the invalid constant for a disparity past the column, 0 outside
// the image.
__device__ __forceinline__ uint32_t pack_pair(int s0, int s1, int xc, int W, int d0, int d1,
                                              uint32_t invalid) {
  if (xc < 0 || xc >= W) return 0u;
  const uint32_t lo = xc >= d0 ? (uint32_t)s0 : invalid;
  const uint32_t hi = xc >= d1 ? (uint32_t)s1 : invalid;
  return lo | (hi << 16);
}

template <int R>
__global__ void __launch_bounds__(kStripThreads, 4) sad_wta_mma_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int D) {
  constexpr int K = 2 * R + 1;
  constexpr int NT = mma_ntiles(R);
  constexpr int CP = mma_cols(R);
  constexpr int VS = gsm_strips::strip_vstride(R);
  constexpr int TPW = (NT + kWarps - 1) / kWarps;  // n-tiles a warp
  constexpr uint32_t kInvalid = 255 * K;
  static_assert(15 + K <= 32, "an m-tile's window must fit one k32 slice");
  static_assert(16 + 32 <= 4 * kWords, "the second m-tile's slice must be staged");

  extern __shared__ __align__(16) unsigned char smem[];
  const int rw = CP + D - 1;  // staged columns of the right tile
  uint32_t* vs = reinterpret_cast<uint32_t*>(smem);  // [2][kStripH][VS]
  uint32_t* lt = vs + 2 * kStripH * VS;              // [CP][kWords]
  uint32_t* rt = lt + CP * kWords;                   // [rw][kWords]

  const size_t frame = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kStripH;
  // Vertical-pass column c is image column x0 - R + c (left) and, at
  // disparity d, right staged column c + (D - 1 - d).
  stage_words<R>(lt, left + frame, H, W, y0, x0 - R, CP);
  stage_words<R>(rt, right + frame, H, W, y0, x0 - R - (D - 1), rw);

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // groupID, threadID_in_group
  const uint32_t a[4] = {band_word(g, 4 * t, K), band_word(g + 8, 4 * t, K),
                         band_word(g, 16 + 4 * t, K), band_word(g + 8, 16 + 4 * t, K)};
  __syncthreads();

  // This lane's left words: column 8n + g of each of its warp's n-tiles,
  // words t, 4 + t and 8 + t.
  uint32_t lw[TPW][3];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int n = warp + kWarps * i;
#pragma unroll
    for (int m = 0; m < 3; ++m) lw[i][m] = n < NT ? lt[(8 * n + g) * kWords + 4 * m + t] : 0u;
  }

  const gsm_strips::Tile tile = {tid, x0, y0, tid % kStripH, tid / kStripH, H, W, 0, D,
                                 vs, vs + 2 * kStripH * VS};
  gsm_strips::KeepMinKey<StoreDisparity> keep = {StoreDisparity(), out + frame};
  keep.begin();

  int buffer = 0;
  for (int d0 = 0; d0 < D; d0 += 2) {
    const int d1 = d0 + 1;
    uint32_t* v = vs + buffer * kStripH * VS;
    buffer ^= 1;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int n = warp + kWarps * i;  // the same for the whole warp
      if (n >= NT) continue;
      // d0's right column for this lane's B column; d1's is one to the left.
      const uint32_t* rp = rt + (8 * n + g + (D - 1 - d0)) * kWords + t;
      uint32_t e0[3], e1[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        e0[m] = __vabsdiffu4(lw[i][m], rp[4 * m]);
        e1[m] = __vabsdiffu4(lw[i][m], rp[4 * m - kWords]);
      }
      // Output column 8n + 2t + (k & 1), row 16 mt + g + 8 (k >> 1).
      const int c = 8 * n + 2 * t;
      const int xc = x0 - R + c;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        int s0[4], s1[4];
        mma_u8(s0, a, e0[mt], e0[mt + 1]);
        mma_u8(s1, a, e1[mt], e1[mt + 1]);
        if (c + 1 < VS) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint2 pair =
                make_uint2(pack_pair(s0[2 * h], s1[2 * h], xc, W, d0, d1, kInvalid),
                           pack_pair(s0[2 * h + 1], s1[2 * h + 1], xc + 1, W, d0, d1, kInvalid));
            *reinterpret_cast<uint2*>(v + (16 * mt + g + 8 * h) * VS + c) = pair;
          }
        }
      }
    }
    __syncthreads();
    gsm_strips::horizontal_pass<R, VS>(v, tile, keep, d0, d1);
  }
  keep.template finish<VS>(tile);
}

// Launches the kernel for (D, r), or with `plan` launches nothing and fills
// {body (0), tile rows, tile columns, threads, blocks, blocks per SM}.
cudaError_t run(const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H, int W, int D,
                int r, cudaStream_t s, int* plan) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D > W || !mma_supported(D, r))
    return cudaErrorInvalidValue;
  if (plan) gsm_strips::fill_plan(plan, false, kStripH, kTileW, kStripThreads, B, H, W);
  const size_t smem = mma_smem(D, r);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return gsm_strips::for_radius(r, [&](auto radius) {
    constexpr int R = decltype(radius)::value;
    if constexpr (R > kMmaMaxR) {
      return cudaErrorInvalidValue;
    } else {
      return gsm_strips::launch_body(sad_wta_mma_kernel<R>, smem,
                                     gsm_strips::strip_grid(H, W, B), s,
                                     plan ? &plan[5] : nullptr, l, rt, o, H, W, D);
    }
  });
}

}  // namespace

// How gsm_sad_wta_mma_u8 launches this shape on the current device: plan =
// {body (0, the only one), tile rows, tile columns, threads, blocks, blocks
// per SM (the occupancy query's), SMs}. Launches nothing. Returns the CUDA
// error code.
extern "C" int gsm_sad_wta_mma_plan(int B, int H, int W, int D, int r, int* plan) {
  cudaError_t err = run(nullptr, nullptr, nullptr, B, H, W, D, r, nullptr, plan);
  return err != cudaSuccess ? err : gsm_strips::device_sms(&plan[6]);
}

// (B, H, W) uint8 left/right -> (B, H, W) int32 disparity, the vertical sums
// on the tensor cores, launched on `stream`. Returns the CUDA error code (0
// on success); cudaErrorInvalidValue for a configuration that is not
// packed-pair.
extern "C" int gsm_sad_wta_mma_u8(const void* left, const void* right, void* out, int B, int H,
                                  int W, int D, int r, void* stream) {
  return run(static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
             static_cast<int32_t*>(out), B, H, W, D, r, static_cast<cudaStream_t>(stream),
             nullptr);
}
