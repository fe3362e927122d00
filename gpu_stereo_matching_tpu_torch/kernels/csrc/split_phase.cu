// Split-phase block matching for Hopper (sm_90a): a materialized SAD volume
// and an argmin over its disparity axis.
//
// Replaces the TPU kernels in gpu_stereo_matching_tpu/kernels/split_phase.py:
// sad_volume (body _sad_volume_kernel) and wta_from_sad (body _wta_kernel).
//
// gsm_sad_volume_u8: a (H, W) uint8 pair -> (D, H, W) int32. For each d:
//   v(y, x)   = sum over |y' - y| <= r, 0 <= y' < H of |L(y', x) - R(y', x - d)|
//               where x >= d, and invalid * cnt(y) where x < d, with cnt(y)
//               the number of image rows in the clipped window at row y;
//   SAD(y, x) = sum over |x' - x| <= r, 0 <= x' < W of v(y, x').
// That is aggregate_cost_volume(ad_cost_volume(L, R, D, invalid), r) of the
// ops path, bit for bit. It is NOT the fused kernel's formula
// (csrc/sad_wta.cu charges invalid * (2r + 1) also at the top and bottom r
// rows), and the two pick different disparities near those rows.
//
// What bounds it: the volume is written once, D*H*W*4 bytes (531 MB at
// 1080x1920, D=64: about 0.16 ms of HBM time at 3.35 TB/s), ten times the
// L2; the sums are the fused kernel's. So the design is the fused kernel's
// arithmetic with a store path that keeps the card's memory busy.
//
// Two hand-written bodies; gsm_sad_volume_u8 picks one from (D, r) alone and
// gsm_sad_volume_body tells which:
//
// * The strip body of sad_strips.cuh, for r = 1..7: what the bm+ path runs
//   (r = 5). Two disparities share every 32-bit word through both passes,
//   so a step leaves each horizontal thread with 32 packed sums of one row:
//   the low halves are plane d, the high halves plane d + 1. Its policy here
//   (EmitVolume) differs from the fused kernels' in two things. An invalid
//   column (x < d) costs `invalid` per row of the window inside the image,
//   not a constant: the body feeds that half a row-masked word in place of
//   the absolute differences. And every step is emitted: the thread writes
//   its packed sums to a tile in shared memory, and after a second barrier
//   all threads copy the tile out before the next step's vertical pass, a
//   warp writing 512 consecutive bytes of one row of one plane as 16-byte
//   streaming stores (st.global.cs: no later step reads them, and the next
//   kernel finds nothing of a 531 MB volume in a 50 MB L2). Chunks past a
//   ragged tile's edge are skipped, and widths that are no multiple of 4
//   store element by element. The dead high half of an odd range is not
//   stored. The kernel has no batch axis, so the range is split across
//   blockIdx.z into even parts of 16 to 64 disparities, as many as fill the
//   last wave of blocks best (volume_steps): at 1080x1920, D=64 three parts,
//   1530 blocks, 3.86 waves at 3 blocks an SM.
//   Measured on an NVIDIA H100 80GB HBM3, 700.00 W, at 1080x1920, D=64, r=5
//   (PERF.md): 0.20 ms a volume back to back, where a plain fill of the
//   same 531 MB takes 0.17 ms and the loop without its global stores 0.11
//   ms; stores straight from the horizontal thread's registers (32 rows of
//   16 bytes a warp instruction) took 0.9 ms, and a second tile in place of
//   the second barrier (2 blocks an SM) was level.
// * The general body, for r = 0 and r = 8..112: a block of NT threads owns
//   kTileH rows and NT - 2r output columns; both images' tiles are staged
//   once in shared memory as bytes with their halos. Per d, thread c slides
//   a vertical sum down column c into a double-buffered shared array; after
//   one barrier each output thread adds its 2r + 1 neighbours for each row
//   and stores the row's value: the stores of a warp are consecutive in x.
//
// wta_kernel has two bodies, chosen by its View template argument.
//
// * The left view (gsm_wta_i32): a (D, N) int32 volume -> (N) int32 argmin
//   over d. One thread per pixel walks d upward and keeps (min, argmin) on a
//   strict '<', so ties go to the smallest d, as torch.argmin. The TPU
//   kernel packs the key SAD * D + d instead; a volume may hold INT32_MAX,
//   and there that key overflows int32, so no key is packed here. What
//   bounds it: reading the volume once (D*N*4 bytes); the loads of a warp
//   are consecutive in N.
// * The right view with the LR check (gsm_wta_lr_i32): the left volume and
//   the left map dl -> the LR-checked left map, int32 or uint8. It replaces
//   the plain torch that models/block_matching.py ran after the left argmin,
//   the port of gpu_stereo_matching_tpu/models/block_matching.py's
//   _right_view_sad (an XLA gather), its second wta_from_sad and
//   ops/postprocess.py's lr_consistency_mask with the where: a gather that
//   wrote a second volume, a fill of it past the edge, a second argmin and a
//   dozen small launches. Here the right view is the left volume read on
//   the diagonal:
//     dr(y, x') = argmin over d < D with x' + d < W of SAD(d, y, x' + d),
//   walked upward on a strict '<' (a real SAD never reaches INT32_MAX, the
//   fill the plain right view puts past the edge, and d = 0 is always inside
//   the image, so the fill never wins); then
//     out(y, x) = dl if dl > 0, x - dl >= 0 and |dl - dr(y, x - dl)| <= max_diff,
//                 else 0,
//   stored as int32, or as uint8 by truncation as .to(torch.uint8) does. A
//   block takes one row and loops over it in chunks of its threads, keeping
//   the row's dr in shared memory (W * 4 bytes) so that the lookup at x - dl
//   stays inside the block; after a barrier the same threads apply the
//   check. What bounds it: reading the volume once (D*H*W*4 bytes, less the
//   triangle x < d that no right-view pixel reads) and dl, and writing the
//   map: 262 MB + 4 MB in and 1 MB out at 800x1280, D=64, about 0.08 ms at
//   3.35 TB/s. So every element is loaded once, as a streaming load
//   (ld.global.cs: no later kernel reads the volume), and a warp's loads of
//   plane d are consecutive in x, offset by d.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sad_strips.cuh"

namespace {

using gsm_strips::kMaxSmem;
using gsm_strips::kStripH;
using gsm_strips::kStripThreads;
using gsm_strips::kStripW;
using gsm_strips::kTileW;

// ---------------------------------------------------------------------------
// The strip body: r = 1..7.
// ---------------------------------------------------------------------------

// The strip body's policy that writes every step's packed sums to the planes
// d (low halves) and d + 1 (high halves) of the (D, H, W) volume `out`,
// through a packed tile in shared memory.
struct EmitVolume {
  static constexpr bool kClipped = true;
  // The row stride of the tile is an odd number of 16-byte chunks, so that
  // the eight rows a quarter warp writes hit eight bank groups.
  static constexpr int kOutStride = kTileW + 4;
  static constexpr int kExtraWords = kStripH * kOutStride;
  static constexpr int kChunks = kStripH * kTileW / 4;  // 16-byte chunks of the tile
  int32_t* out;
  size_t plane;      // H * W
  uint32_t invalid;  // the cost per row of a column x < d
  uint32_t sums[kStripW];

  __device__ __forceinline__ void begin() {}
  // Before step d0's vertical pass the tile holds step d0 - 2: a second
  // barrier separates its horizontal pass from the copy, and the vertical
  // pass's own barrier the copy from the next horizontal pass.
  __device__ __forceinline__ void before_step(const gsm_strips::Tile& t, int d0) {
    if (d0 > t.d_start) {
      __syncthreads();
      drain(t, d0 - 2);
    }
  }
  __device__ __forceinline__ void sum(int j, uint32_t s, int, int) { sums[j] = s; }

  // The horizontal pass of a step is done for this thread: its 32 packed
  // sums go to the tile.
  __device__ __forceinline__ void end_step(const gsm_strips::Tile& t, int, int) {
    uint4* p = reinterpret_cast<uint4*>(t.extra + t.hrow * kOutStride + t.strip * kStripW);
#pragma unroll
    for (int m = 0; m < kStripW / 4; ++m)
      p[m] = make_uint4(sums[4 * m], sums[4 * m + 1], sums[4 * m + 2], sums[4 * m + 3]);
  }
  template <int VS>
  __device__ __forceinline__ void finish(const gsm_strips::Tile& t) {
    __syncthreads();
    drain(t, t.d_start + ((t.d_end - t.d_start - 1) & ~1));
  }

  // Copies the tile, which holds the step that began at d0, to the volume:
  // all threads, 16 bytes each, so a warp writes 512 consecutive bytes of one
  // row of a plane.
  __device__ __forceinline__ void drain(const gsm_strips::Tile& t, int d0) {
    const bool has1 = d0 + 1 < t.d_end;  // else the high half is an odd range's dead one
    const bool vector = (t.W & 3) == 0;  // then a chunk inside the image is whole and aligned
    int32_t* o = out + (size_t)d0 * plane;
#pragma unroll
    for (int k = 0; k < (kChunks + kStripThreads - 1) / kStripThreads; ++k) {
      const int c = t.tid + k * kStripThreads;
      const int row = c / (kTileW / 4), cx = 4 * (c % (kTileW / 4));
      const int gy = t.y0 + row, gx = t.x0 + cx;
      if (c >= kChunks || gy >= t.H || gx >= t.W) continue;
      const uint4 pk = *reinterpret_cast<const uint4*>(t.extra + row * kOutStride + cx);
      int32_t* q = o + (size_t)gy * t.W + gx;
      if (vector) {
        __stcs(reinterpret_cast<uint4*>(q),
               make_uint4(pk.x & 0xffff, pk.y & 0xffff, pk.z & 0xffff, pk.w & 0xffff));
        if (has1)
          __stcs(reinterpret_cast<uint4*>(q + plane),
                 make_uint4(pk.x >> 16, pk.y >> 16, pk.z >> 16, pk.w >> 16));
      } else {
        const uint32_t w4[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gx + e < t.W) {
            q[e] = (int32_t)(w4[e] & 0xffff);
            if (has1) q[plane + e] = (int32_t)(w4[e] >> 16);
          }
        }
      }
    }
  }
};

// (H, W) uint8 pair -> the planes [blockIdx.z * steps, + steps) of the
// (D, H, W) int32 volume.
template <int R>
__global__ void __launch_bounds__(kStripThreads, 3) volume_strip_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int D, int steps, int invalid) {
  const int d_start = blockIdx.z * steps;
  EmitVolume emit = {out, (size_t)H * W, (uint32_t)invalid};
  gsm_strips::strip_body<R>(left, right, H, W, d_start, min(steps, D - d_start), emit);
}

// ---------------------------------------------------------------------------
// The general body: r = 0 and r = 8..112.
// ---------------------------------------------------------------------------

constexpr int kTileH = 32;

template <int NT>
__global__ void __launch_bounds__(NT) sad_volume_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int D, int r, int invalid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo_rows = kTileH + 2 * r;
  const int rw = NT + D - 1;  // staged width of the right tile
  int32_t* vs = reinterpret_cast<int32_t*>(smem);               // [2][kTileH][NT]
  uint8_t* ls = smem + 2 * kTileH * NT * sizeof(int32_t);       // [halo_rows][NT]
  uint8_t* rs = ls + halo_rows * NT;                            // [halo_rows][rw]

  const int x0 = blockIdx.x * (NT - 2 * r);  // first output column
  const int y0 = blockIdx.y * kTileH;        // first output row
  const int c = threadIdx.x;

  // Staged column col holds global column x0 - r + col (left) and
  // x0 - r - (D - 1) + col (right); staged row row holds y0 - r + row.
  // Rows and columns outside the image are 0 in both, so they add 0.
  for (int i = c; i < halo_rows * NT; i += NT) {
    const int row = i / NT, col = i - row * NT;
    const int gy = y0 - r + row, gx = x0 - r + col;
    ls[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? left[(size_t)gy * W + gx] : 0;
  }
  for (int i = c; i < halo_rows * rw; i += NT) {
    const int row = i / rw, col = i - row * rw;
    const int gy = y0 - r + row, gx = x0 - r - (D - 1) + col;
    rs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? right[(size_t)gy * W + gx] : 0;
  }
  __syncthreads();

  const int k = 2 * r + 1;
  const int xc = x0 - r + c;  // this thread's column
  const bool is_out = c >= r && c < NT - r && xc < W;
  const size_t plane = (size_t)H * W;

  for (int d = 0; d < D; ++d) {
    // Double buffer: a thread writes buffer d & 1 only after every thread
    // has passed iteration d - 1's barrier, so the reads of d - 2 are done.
    int32_t* v = vs + (d & 1) * kTileH * NT;
    if (xc < 0 || xc >= W) {
      for (int i = 0; i < kTileH; ++i) v[i * NT + c] = 0;
    } else if (xc < d) {
      // Every row of the clipped window costs `invalid` in this column.
      for (int i = 0; i < kTileH; ++i) {
        const int y = y0 + i;
        v[i * NT + c] = invalid * (min(y, r) + min(max(H - 1 - y, 0), r) + 1);
      }
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
      int32_t* o = out + (size_t)d * plane + (size_t)y0 * W + xc;
      const int rows = min(kTileH, H - y0);
      for (int i = 0; i < rows; ++i) {
        const int32_t* vr = v + i * NT + c - r;
        int s = 0;
        for (int j = 0; j < k; ++j) s += vr[j];
        o[(size_t)i * W] = s;
      }
    }
  }
}

template <int NT>
cudaError_t launch_volume(const uint8_t* left, const uint8_t* right, int32_t* out,
                          int H, int W, int D, int r, int invalid, cudaStream_t stream,
                          int* occupancy) {
  const size_t halo_rows = kTileH + 2 * r;
  const size_t smem = 2 * kTileH * NT * sizeof(int32_t) + halo_rows * NT +
                      halo_rows * (NT + D - 1);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sad_volume_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, sad_volume_kernel<NT>, NT,
                                                         smem);
  const int tw = NT - 2 * r;
  dim3 grid((W + tw - 1) / tw, (H + kTileH - 1) / kTileH);
  sad_volume_kernel<NT><<<grid, NT, smem, stream>>>(left, right, out, H, W, D, r, invalid);
  return cudaGetLastError();
}

// Whether (D, r) runs the strip body: its radii. Any D does, since a block
// takes kMaxSteps disparities at most, whose tiles fit shared memory.
inline bool volume_takes_strips(int /*D*/, int r) {
  return r >= 1 && r <= gsm_strips::kStripMaxR;
}

constexpr int kMinSteps = 16, kMaxSteps = 64;  // disparities of a block

// The disparities a block of the strip body takes. The range is cut into
// equal even parts of kMinSteps..kMaxSteps disparities, as many as leave the
// last wave of blocks fullest when `slots` blocks run at once; among equals
// the fewest, since every part stages its tiles again.
int volume_steps(int tiles, int D, int slots) {
  int best = 0;
  long long best_blocks = 0, best_room = 1;
  for (int parts = (D + kMaxSteps - 1) / kMaxSteps; parts <= (D + kMinSteps - 1) / kMinSteps;
       ++parts) {
    const int steps = ((D + parts - 1) / parts + 1) & ~1;
    const long long blocks = (long long)tiles * ((D + steps - 1) / steps);
    const long long room = (blocks + slots - 1) / slots * slots;  // whole waves
    if (blocks * best_room > best_blocks * room) {
      best = steps;
      best_blocks = blocks;
      best_room = room;
    }
  }
  return best;
}

// Shared memory of a block of the strip body over `steps` disparities: the
// body's own, the packed tile and the invalid half's row-masked words.
inline size_t volume_smem(int steps, int r) {
  return gsm_strips::strip_smem(steps, r, EmitVolume::kExtraWords + gsm_strips::strip_words(r));
}

// Launches the strip body; with `plan`, launches nothing and fills its
// fields {blocks, blocks per SM}.
cudaError_t run_volume_strips(const uint8_t* l, const uint8_t* rt, int32_t* o, int H, int W,
                              int D, int r, int invalid, cudaStream_t s, int* plan) {
  return gsm_strips::for_radius(r, [&](auto radius) {
    constexpr int R = decltype(radius)::value;
    // The blocks an SM holds do not change with the part size (the sums and
    // the tile outweigh the right tile's columns), so they are asked once,
    // for the widest part.
    int per_sm = 0, sms = 0;
    cudaError_t err =
        gsm_strips::launch_body(volume_strip_kernel<R>, volume_smem(kMaxSteps, R), dim3(), s,
                                &per_sm, l, rt, o, H, W, D, 0, invalid);
    if (err == cudaSuccess) err = gsm_strips::device_sms(&sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const dim3 tiles = gsm_strips::strip_grid(H, W, 1);
    const int steps = volume_steps(tiles.x * tiles.y, D, per_sm * sms);
    const dim3 grid = gsm_strips::strip_grid(H, W, (D + steps - 1) / steps);
    if (plan) {
      plan[4] = grid.x * grid.y * grid.z;
      plan[5] = per_sm;
      return cudaSuccess;
    }
    return gsm_strips::launch_body(volume_strip_kernel<R>, volume_smem(steps, R), grid, s,
                                   nullptr, l, rt, o, H, W, D, steps, invalid);
  });
}

// Launches the body that (D, r) takes; with `plan`, launches nothing and
// fills {body, tile rows, tile columns, threads, blocks, blocks per SM}.
cudaError_t run_volume(const uint8_t* l, const uint8_t* rt, int32_t* o, int H, int W, int D,
                       int r, int invalid, cudaStream_t s, int* plan) {
  if (H < 1 || W < 1 || D < 1 || D > W || r < 0 || invalid < 0 || invalid > 255)
    return cudaErrorInvalidValue;
  int* occupancy = plan ? &plan[5] : nullptr;
  const bool strips = volume_takes_strips(D, r);
  const int nt = strips ? kStripThreads : 2 * r + kTileH <= 128 ? 128 : 256;
  if (plan)
    gsm_strips::fill_plan(plan, strips, strips ? kStripH : kTileH, strips ? kTileW : nt - 2 * r,
                          nt, 1, H, W);
  if (strips) return run_volume_strips(l, rt, o, H, W, D, r, invalid, s, plan);
  if (nt == 128) return launch_volume<128>(l, rt, o, H, W, D, r, invalid, s, occupancy);
  if (2 * r + kTileH <= 256) return launch_volume<256>(l, rt, o, H, W, D, r, invalid, s, occupancy);
  return cudaErrorInvalidValue;
}

constexpr int kWtaThreads = 256;
// Shared memory a block can hold: the right-view body keeps W int32 there.
constexpr int kWtaMaxSmem = 232448;

enum WtaView { kLeftView, kRightViewLr };

// The right view's argmins of row blockIdx.x into shared memory, then the
// LR check of the left map dl against them into `out`.
template <typename OutT>
__device__ __forceinline__ void right_view_lr_body(
    const int32_t* __restrict__ sad, OutT* __restrict__ out, int D, int n,
    const int32_t* __restrict__ dl, int W, int max_diff) {
  extern __shared__ int32_t row_dr[];
  const size_t row = (size_t)blockIdx.x * W;
  const size_t diagonal = (size_t)n + 1;  // from (d, y, x' + d) to (d + 1, y, x' + d + 1)
  for (int x = threadIdx.x; x < W; x += kWtaThreads) {
    const int32_t* col = sad + row + x;
    const int d_end = min(D, W - x);
    int best = __ldcs(col);
    int best_d = 0;
#pragma unroll 8
    for (int d = 1; d < d_end; ++d) {
      const int s = __ldcs(col + d * diagonal);
      if (s < best) {
        best = s;
        best_d = d;
      }
    }
    row_dr[x] = best_d;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += kWtaThreads) {
    const int d = dl[row + x];
    const int src = x - d;
    const bool ok = d > 0 && src >= 0 && abs(d - row_dr[src]) <= max_diff;
    out[row + x] = static_cast<OutT>(ok ? d : 0);
  }
}

template <int View, typename OutT>
__global__ void __launch_bounds__(kWtaThreads) wta_kernel(
    const int32_t* __restrict__ sad, OutT* __restrict__ out, int D, int n,
    const int32_t* __restrict__ dl, int W, int max_diff) {
  if constexpr (View == kLeftView) {
    const int p = blockIdx.x * kWtaThreads + threadIdx.x;
    if (p >= n) return;
    const int32_t* col = sad + p;
    int best = col[0];
    int best_d = 0;
#pragma unroll 8
    for (int d = 1; d < D; ++d) {
      const int s = col[(size_t)d * n];
      if (s < best) {
        best = s;
        best_d = d;
      }
    }
    out[p] = best_d;
  } else {
    right_view_lr_body(sad, out, D, n, dl, W, max_diff);
  }
}

template <typename OutT>
cudaError_t launch_right_view_lr(const int32_t* sad, const int32_t* dl, OutT* out, int D,
                                 int H, int W, int max_diff, cudaStream_t stream) {
  const size_t smem = (size_t)W * sizeof(int32_t);
  if (smem > kWtaMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(wta_kernel<kRightViewLr, OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  wta_kernel<kRightViewLr, OutT><<<H, kWtaThreads, smem, stream>>>(sad, out, D, H * W, dl, W,
                                                                   max_diff);
  return cudaGetLastError();
}

}  // namespace

// Which body (D, r) runs: 1 the strip body, 0 the general one.
extern "C" int gsm_sad_volume_body(int D, int r) { return volume_takes_strips(D, r) ? 1 : 0; }

// How gsm_sad_volume_u8 launches this shape on the current device: plan =
// {body, tile rows, tile columns, threads, blocks (tiles times the parts of
// the disparity range), blocks per SM (the occupancy query's), SMs}.
// Launches nothing. Returns the CUDA error code.
extern "C" int gsm_sad_volume_plan(int H, int W, int D, int r, int* plan) {
  cudaError_t err = run_volume(nullptr, nullptr, nullptr, H, W, D, r, 0, nullptr, plan);
  return err != cudaSuccess ? err : gsm_strips::device_sms(&plan[6]);
}

// (H, W) uint8 left/right -> (D, H, W) int32 SAD volume on `stream`;
// `invalid` is the per-pixel cost of columns x < d. Returns the CUDA error
// code (0 on success).
extern "C" int gsm_sad_volume_u8(const void* left, const void* right, void* out,
                                 int H, int W, int D, int r, int invalid,
                                 void* stream) {
  return run_volume(static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
                    static_cast<int32_t*>(out), H, W, D, r, invalid,
                    static_cast<cudaStream_t>(stream), nullptr);
}

// (D, n) int32 volume -> (n) int32 argmin over d (ties to the smallest d),
// on `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_wta_i32(const void* sad, void* out, int D, int n, void* stream) {
  if (D < 1 || n < 1) return cudaErrorInvalidValue;
  const int blocks = (n + kWtaThreads - 1) / kWtaThreads;
  wta_kernel<kLeftView, int32_t><<<blocks, kWtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sad), static_cast<int32_t*>(out), D, n, nullptr, 0, 0);
  return cudaGetLastError();
}

// The (D, H, W) int32 left volume and the (H, W) int32 left map -> the
// (H, W) LR-checked left map (uint8 if out_u8, else int32), on `stream`:
// the right view's argmin read on the volume's diagonal, then the check
// with tolerance max_diff. W int32 must fit a block's shared memory.
// Returns the CUDA error code (0 on success).
extern "C" int gsm_wta_lr_i32(const void* sad, const void* disp_left, void* out, int D, int H,
                              int W, int max_diff, int out_u8, void* stream) {
  if (D < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const int32_t* s = static_cast<const int32_t*>(sad);
  const int32_t* dl = static_cast<const int32_t*>(disp_left);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_u8)
    return launch_right_view_lr(s, dl, static_cast<uint8_t*>(out), D, H, W, max_diff, st);
  return launch_right_view_lr(s, dl, static_cast<int32_t*>(out), D, H, W, max_diff, st);
}
