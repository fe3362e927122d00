// Fused SAD + winner-take-all block matching with both window sums on the
// integer tensor cores, for Hopper (sm_90a).
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
// What bounds it: the same work as sad_wta.cu, integer sums per pixel and
// disparity (a frame's bytes are a few microseconds of HBM time). Here both
// window sums are m16n8k32 u8 products (mma.sync, IMMA.16832.U8.U8) chained
// in registers; no sum passes through shared memory and no barrier runs in
// the disparity loop. What the loop issues is the bound. Per warp, pair of
// disparities and 32 x 64 outputs at r = 5 the SASS holds 748 instructions
// (chip_smoke.py phase 22 reads them): 104 IMMA (20 vertical and 32
// horizontal a row half), 160 byte permutes, 60 shared loads, 60
// __vabsdiffu4, 64 three-way minima and 293 multiply-adds (128 keys, 40
// shifts, and register moves that line values up as operand pairs and
// quads). The tensor cores are busy a fraction of the kernel's time. The
// warps at the image's left and right edges run the checked loop (846
// instructions) and finish last.
//
// * A block of 64 threads (2 warps) owns 32 rows by 128 output columns
//   (a 1080p frame is 510 blocks, one wave at 4 blocks an SM, so no block
//   stages a next tile); each warp owns 32 rows by 64 columns, both 16-row
//   halves (m-tiles), and walks every disparity alone, its keys in
//   registers (the launch bound of 4 blocks an SM leaves 255 a thread).
// * Staging: the tile's 48 rows (32 + 2r needed, rows outside the image 0)
//   of both images are copied with 16-byte cp.async (zero-filled outside
//   the image) when W % 16 == 0 and both bases are 16-byte aligned, with
//   plain loads otherwise, into a row-major raw area; then laid out once
//   as 4-row words, 12 a column ([column][12]: the 32 lanes' loads of one
//   B fragment hit 32 banks), a thread a column, three 16-byte stores
//   each. Two barriers in all, both before the loop.
// * Vertical products, per disparity and 8-column V n-tile: V = band (16 x
//   32, A[i][k] = 1 for i <= k < i + 2r + 1, four registers for the whole
//   kernel) * diff (32 x 8), where the B registers are __vabsdiffu4 of the
//   lane's left words (in registers for the whole loop) and right words
//   from shared memory. The row halves' K windows start at staged rows 0
//   and 16 and share the middle word: three loads and differences serve
//   both. A warp's 64 outputs need 64 + 2r V columns: 10 n-tiles at r = 5,
//   9 below.
// * The accumulator becomes the next A operand. Lane (g, t) holds V at rows
//   g, g + 8 and columns 2t, 2t + 1 of each n-tile; the u8 A fragment takes
//   rows g, g + 8 and K slots 4t..4t+3, 16+4t..16+4t+3. So from n-tiles n0,
//   n0 + 1 the lane has four columns of each of its rows, and K slot
//   16h + 4t + e stands for V column 8 (n0 + 2h + e / 2) + 2t + e % 2 with
//   no shuffle. The horizontal band (32 V columns x 8 outputs, 1 where slot
//   k's column lies in output j's window) is built with that permutation,
//   once, in registers. K windows start at even n-tiles: output n-tiles
//   2p and 2p + 1 both read V n-tiles 2p..2p+3 (8 + 2r <= 32 - 8), with two
//   band constants, so one set of A registers serves two output tiles. Each
//   pair of V n-tiles is packed into alternate halves of those registers,
//   so output pair p reads pairs p and p + 1 where they lie: for odd p
//   with its K halves swapped, against the band's B registers swapped.
// * Exact products: V reaches 255 (2r + 1) = 2805, past a byte, so A is two
//   byte planes, V's bytes 0 and 1: four PRMTs pack both planes of four
//   values. The high byte is at most 10, so its packed word shifted left 4
//   bits is a byte plane of 16 hi, and against the band times 16 it chains
//   after the low plane's product in one accumulator: SAD = lo + 256 hi
//   comes out of the second product, and the key SAD << 16 | d is one
//   multiply-add: one shift per four V values, against a second
//   multiply-add per key for planes kept apart (hi << 24 + lo << 16 + d).
//   7-bit planes against bands of weight 1 and 128 would chain too, but
//   take 4 more instructions per 4 V values to cut than the one shift.
// * A column 0 <= x < d holds the invalid constant 255 (2r + 1) in V at
//   every row, and a column outside the image 0. Both are set in the
//   differences, before the vertical product: the B register of such a
//   column is all 255 (the band's 2r + 1 ones a row then sum to the
//   constant, the border rows included) or 0. A warp whose V columns are
//   all inside the image and at or past D - 1 runs the loop without it;
//   the others spend two masks, made by arithmetic shifts, and one LOP3 a
//   B register, and no branch.
// * Keys: a three-way unsigned minimum over (d, d + 1) per output is the
//   whole (min, argmin) update, ties to the smallest d. The low half of
//   the final key is the disparity; each lane stores two adjacent int32 a
//   row and n-tile, 8 bytes, so a warp's store fills whole 32-byte sectors
//   without a trip through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sad_strips.cuh"

namespace {

using gsm_strips::kMaxSmem;

constexpr int kMmaMaxR = 5;  // 255 * (2r + 1)^2 < 2^15, the packed-pair rule
constexpr int kMmaMaxD = 256;
constexpr int kTileH = gsm_strips::kStripH;  // 32 rows a block
constexpr int kTileW = gsm_strips::kTileW;   // 128 output columns a block
constexpr int kWarpW = 64;                   // output columns of a warp
constexpr int kThreads = 64;                 // 2 warps: column halves, 32 rows each
constexpr int kWords = 12;                   // 4-row words a staged column
constexpr int kRows = 4 * kWords;            // 48 staged rows
constexpr int kVCols = kTileW + 16;          // staged left columns: the last warp's 80
static_assert(kThreads == 32 * (kTileW / kWarpW), "one warp a 32x64 tile");

// V n-tiles of a warp: 64 + 2r columns.
__host__ __device__ constexpr int v_ntiles(int r) { return (kWarpW + 2 * r + 7) / 8; }

// Row pitch of a raw staging area whose first word column lies `lead`
// columns left of the tile: 16-byte chunks from floor16(x0 - lead) to
// x0 + kVCols (x0 is a multiple of 128).
__host__ __device__ constexpr int raw_pitch(int lead) { return kVCols + 16 * ((lead + 15) / 16); }

// Dynamic shared memory of a block over D disparities: the left and right
// words, then both raw areas.
inline size_t mma_smem(int D, int r) {
  return sizeof(uint32_t) * kWords * (2 * (size_t)kVCols + D - 1) +
         (size_t)kRows * (raw_pitch(r) + raw_pitch(r + D - 1));
}

inline bool mma_supported(int D, int r) {
  return D % 2 == 0 && D >= 2 && D <= kMmaMaxD && r >= 1 && r <= kMmaMaxR;
}

// D (16x8, s32) = A (16x32, u8, row) * B (32x8, u8, col), C = 0.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// D = A * B + C, the same shape.
__device__ __forceinline__ void mma_u8_acc(uint32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1, const uint32_t (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]),
        "r"(c[2]), "r"(c[3]));
}

// Byte e of the A register that holds row `row`, K slots k0..k0+3 of the
// vertical band: 1 where row <= k0 + e < row + 2R + 1.
__device__ __forceinline__ uint32_t vband_word(int row, int k0, int R) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + e;
    if (k >= row && k <= row + 2 * R) w |= 1u << (8 * e);
  }
  return w;
}

// Byte e of the B register that holds K slots k0..k0+3 of output column j
// (0..15 from the pair's first V column) of the horizontal band: slot k is
// V column 16 (k / 16) + 8 ((k % 4) / 2) + 2 ((k / 4) % 4) + k % 2, and
// output j sums V columns j..j+2R.
__device__ __forceinline__ uint32_t hband_word(int j, int k0, int R) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = k0 + e;
    const int c = 16 * (k >> 4) + 8 * ((k & 3) >> 1) + 2 * ((k >> 2) & 3) + (k & 1);
    if (c >= j && c <= j + 2 * R) w |= 1u << (8 * e);
  }
  return w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// Raw row j of `raw` (pitch bytes) is image row gy0 + j, byte i image
// column gx0 + i (gx0 a multiple of 16); outside the image 0.
__device__ __forceinline__ void copy_raw(uint8_t* raw, int pitch, const uint8_t* __restrict__ img,
                                         int H, int W, int gy0, int gx0, bool async) {
  if (async) {
    const int chunks = pitch / 16;
    for (int i = threadIdx.x; i < kRows * chunks; i += kThreads) {
      const int j = i / chunks, c = 16 * (i - j * chunks);
      const int gy = gy0 + j, gx = gx0 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;  // a chunk is all in or all out
      cp_async16(raw + j * pitch + c, in ? img + (size_t)gy * W + gx : img, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * pitch / 4; i += kThreads) {
      const int j = 4 * i / pitch, c = 4 * i - j * pitch, gy = gy0 + j;
      uint32_t word = 0;
      if (gy >= 0 && gy < H) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gx = gx0 + c + b;
          if (gx >= 0 && gx < W) word |= (uint32_t)img[(size_t)gy * W + gx] << (8 * b);
        }
      }
      reinterpret_cast<uint32_t*>(raw)[i] = word;
    }
  }
}

// words[c][q] packs raw rows 4q..4q+3 of raw column off + c. A thread
// takes a column and stores its 12 words as three 16-byte stores (the
// 48-byte column pitch puts a quarter warp's on 32 banks).
__device__ __forceinline__ void lay_out(uint32_t* words, int cols, const uint8_t* raw, int pitch,
                                        int off) {
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const uint8_t* p = raw + off + c;
    uint32_t w[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      w[q] = (uint32_t)p[4 * q * pitch] | (uint32_t)p[(4 * q + 1) * pitch] << 8 |
             (uint32_t)p[(4 * q + 2) * pitch] << 16 | (uint32_t)p[(4 * q + 3) * pitch] << 24;
    uint4* dst = reinterpret_cast<uint4*>(words + c * kWords);
#pragma unroll
    for (int m = 0; m < kWords / 4; ++m)
      dst[m] = make_uint4(w[4 * m], w[4 * m + 1], w[4 * m + 2], w[4 * m + 3]);
  }
}

// Both byte planes of four V values of n-tiles n0 (a) and n0 + 1 (b), rows
// g and g + 8, columns 2t, 2t + 1, into half `h` of the A registers of each
// plane: lo[2h], lo[2h + 1] = the low plane of rows g, g + 8; hi[2h],
// hi[2h + 1] = 16 times the high plane; byte e of each = K slot 4t + e.
__device__ __forceinline__ void pack_planes(uint32_t (&lo)[4], uint32_t (&hi)[4], int h,
                                            const uint32_t (&a)[4], const uint32_t (&b)[4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t ta = __byte_perm(a[2 * r], a[2 * r + 1], 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
    const uint32_t tb = __byte_perm(b[2 * r], b[2 * r + 1], 0x5140);
    lo[2 * h + r] = __byte_perm(ta, tb, 0x5410);       // bytes 0
    hi[2 * h + r] = __byte_perm(ta, tb, 0x7632) << 4;  // bytes 1 (at most 10), times 16
  }
}

// The disparity loop of one warp: best[mt][o][i] is the smallest key of
// row half mt, output n-tile o, accumulator element i. `lw` are the lane's
// left words (staged words t, 4 + t, 8 + t of each n-tile's column), `r0`
// the right words of its first n-tile at d = 0, `hb` the horizontal band
// ([output n-tile parity][plane weight 1, 16][B register]), `xv` the image
// column of the warp's V column 0, `g` the lane's groupID. kChecked: some
// n-tile may hold columns x < d or columns outside the image.
template <int R, bool kChecked>
__device__ __forceinline__ void match(uint32_t (&best)[2][8][4], const uint32_t (&lw)[v_ntiles(R)][3],
                                      const uint32_t* r0, const uint32_t (&va)[4],
                                      const uint32_t (&hb)[2][2][2], int D, int xv, int W, int g) {
  constexpr int NV = v_ntiles(R);
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 2) {
    const uint32_t* rd = r0 - d0 * kWords;
    // The A registers of each row half, disparity and plane. V pair m (n-tiles
    // 2m, 2m + 1) is packed into half m % 2, so output pair p reads V pairs
    // p and p + 1 in place: in K order for p even, with the K halves swapped
    // for p odd, where the band's B registers swap too.
    uint32_t a[2][2][2][4];  // [row half][d0, d0 + 1][plane lo, 16 hi][register]
#pragma unroll
    for (int m = 0; m < 5; ++m) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t v[2][2][4];  // [row half][n-tile of the pair][element]
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int n = 2 * m + k;
          if (n >= NV) {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[0][k][i] = v[1][k][i] = 0u;
            continue;
          }
          const uint32_t* rp = rd + (8 * n - s) * kWords;
          uint32_t e0 = __vabsdiffu4(lw[n][0], rp[0]);
          uint32_t e1 = __vabsdiffu4(lw[n][1], rp[4]);
          uint32_t e2 = __vabsdiffu4(lw[n][2], rp[8]);
          if (kChecked) {
            // This lane's B column xb: 255 in every K row where 0 <= xb < d,
            // so the band makes V 255 (2r + 1) at every output row; 0 outside
            // the image.
            const int xb = xv + 8 * n + g;
            const uint32_t past = (uint32_t)((xb - (d0 + s)) >> 31);
            const uint32_t keep = ~(uint32_t)((xb | (W - 1 - xb)) >> 31);
            e0 = (e0 | past) & keep;
            e1 = (e1 | past) & keep;
            e2 = (e2 | past) & keep;
          }
          mma_u8(v[0][k], va, e0, e1);
          mma_u8(v[1][k], va, e1, e2);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          pack_planes(a[mt][s][0], a[mt][s][1], m % 2, v[mt][0], v[mt][1]);
      }
      if (m > 0) {
        const int swap = (m - 1) % 2;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t key[2][4];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              uint32_t lo[4], sad[4];
              mma_u8(lo, a[mt][s][0], hb[q][0][swap], hb[q][0][1 - swap]);
              mma_u8_acc(sad, a[mt][s][1], hb[q][1][swap], hb[q][1][1 - swap], lo);
#pragma unroll
              for (int i = 0; i < 4; ++i) key[s][i] = sad[i] * 65536u + (d0 + s);
            }
            uint32_t (&b)[4] = best[mt][2 * (m - 1) + q];
#pragma unroll
            for (int i = 0; i < 4; ++i) b[i] = __vimin3_u32(b[i], key[0][i], key[1][i]);
          }
        }
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 4) sad_wta_mma_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int D, int async) {
  constexpr int NV = v_ntiles(R);
  extern __shared__ __align__(16) unsigned char smem[];
  const int rcols = kVCols + D - 1;  // right word columns: V column c at d is c + D - 1 - d
  const int lp = raw_pitch(R), rpitch = raw_pitch(R + D - 1);
  uint32_t* lwords = reinterpret_cast<uint32_t*>(smem);                 // [kVCols][kWords]
  uint32_t* rwords = lwords + kVCols * kWords;                          // [rcols][kWords]
  uint8_t* lraw = reinterpret_cast<uint8_t*>(rwords + rcols * kWords);  // [kRows][lp]
  uint8_t* rraw = lraw + kRows * lp;                                    // [kRows][rpitch]

  const size_t frame = (size_t)blockIdx.z * H * W;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  // Raw column 0 is image column x0 + kVCols - pitch; word column 0 is
  // image column x0 - R (left) and x0 - R - (D - 1) (right).
  copy_raw(lraw, lp, left + frame, H, W, y0 - R, x0 + kVCols - lp, async);
  copy_raw(rraw, rpitch, right + frame, H, W, y0 - R, x0 + kVCols - rpitch, async);
  if (async) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();
  lay_out(lwords, kVCols, lraw, lp, lp - kVCols - R);
  lay_out(rwords, rcols, rraw, rpitch, rpitch - kVCols - R - (D - 1));
  __syncthreads();

  const int half = threadIdx.x / 32, lane = threadIdx.x % 32;  // column half
  const int g = lane / 4, t = lane % 4;                         // groupID, threadID_in_group
  const int xw = x0 + kWarpW * half;
  if (xw >= W) return;

  // This lane's B column is V column 8n + g of each n-tile: row half mt's
  // K rows 4t.. and 16 + 4t.. are staged rows 16 mt + 4t.., words 4 mt + t
  // and 4 mt + 4 + t.
  const int word = (kWarpW * half + g) * kWords + t;
  uint32_t lw[NV][3];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int j = 0; j < 3; ++j) lw[n][j] = lwords[word + 8 * n * kWords + 4 * j];
  const uint32_t va[4] = {vband_word(g, 4 * t, R), vband_word(g + 8, 4 * t, R),
                          vband_word(g, 16 + 4 * t, R), vband_word(g + 8, 16 + 4 * t, R)};
  uint32_t hb[2][2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hb[q][0][h] = hband_word(8 * q + g, 16 * h + 4 * t, R);
      hb[q][1][h] = 16u * hb[q][0][h];
    }
  uint32_t best[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int o = 0; o < 8; ++o)
#pragma unroll
      for (int i = 0; i < 4; ++i) best[mt][o][i] = 0xffffffffu;

  const uint32_t* r0 = rwords + word + (D - 1) * kWords;
  const int xv = xw - R;
  if (xv >= D - 1 && xv + 8 * NV <= W)
    match<R, false>(best, lw, r0, va, hb, D, xv, W, g);
  else
    match<R, true>(best, lw, r0, va, hb, D, xv, W, g);

  // Element i of output n-tile o: row 16 mt + g + 8 (i / 2), column 8o +
  // 2t + i % 2.
  int32_t* o_frame = out + frame;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int x = xw + 8 * o + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = y0 + 16 * mt + g + 8 * h;
        if (y >= H || x >= W) continue;
        const int32_t d0 = best[mt][o][2 * h] & 0xffff, d1 = best[mt][o][2 * h + 1] & 0xffff;
        int32_t* p = o_frame + (size_t)y * W + x;
        if (x + 1 < W && W % 2 == 0) {
          *reinterpret_cast<int2*>(p) = make_int2(d0, d1);
        } else {
          p[0] = d0;
          if (x + 1 < W) p[1] = d1;
        }
      }
    }
}

// Launches the kernel for (D, r), or with `plan` launches nothing and fills
// {body (0), tile rows, tile columns, threads, blocks, blocks per SM, -,
// dynamic shared bytes a block}.
cudaError_t run(const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H, int W, int D,
                int r, cudaStream_t s, int* plan) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D > W || !mma_supported(D, r))
    return cudaErrorInvalidValue;
  if (plan) gsm_strips::fill_plan(plan, false, kTileH, kTileW, kThreads, B, H, W);
  const size_t smem = mma_smem(D, r);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (plan) plan[7] = (int)smem;
  // 16-byte copies need every row's first byte 16-byte aligned.
  const int async = W % 16 == 0 && reinterpret_cast<uintptr_t>(l) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(rt) % 16 == 0;
  return gsm_strips::for_radius(r, [&](auto radius) {
    constexpr int R = decltype(radius)::value;
    if constexpr (R > kMmaMaxR) {
      return cudaErrorInvalidValue;
    } else {
      return gsm_strips::launch_body<kThreads>(sad_wta_mma_kernel<R>, smem,
                                               gsm_strips::strip_grid(H, W, B), s,
                                               plan ? &plan[5] : nullptr, l, rt, o, H, W, D, async);
    }
  });
}

}  // namespace

// How gsm_sad_wta_mma_u8 launches this shape on the current device: plan =
// {body (0, the only one), tile rows, tile columns, threads, blocks, blocks
// per SM (the occupancy query's), SMs, dynamic shared bytes a block}.
// Launches nothing. Returns the CUDA error code.
extern "C" int gsm_sad_wta_mma_plan(int B, int H, int W, int D, int r, int* plan) {
  cudaError_t err = run(nullptr, nullptr, nullptr, B, H, W, D, r, nullptr, plan);
  return err != cudaSuccess ? err : gsm_strips::device_sms(&plan[6]);
}

// (B, H, W) uint8 left/right -> (B, H, W) int32 disparity, both window sums
// on the tensor cores, launched on `stream`. Returns the CUDA error code (0
// on success); cudaErrorInvalidValue for a configuration that is not
// packed-pair.
extern "C" int gsm_sad_wta_mma_u8(const void* left, const void* right, void* out, int B, int H,
                                  int W, int D, int r, void* stream) {
  return run(static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
             static_cast<int32_t*>(out), B, H, W, D, r, static_cast<cudaStream_t>(stream),
             nullptr);
}
