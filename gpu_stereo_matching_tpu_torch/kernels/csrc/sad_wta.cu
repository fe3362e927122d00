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
// * The strip body of sad_strips.cuh, for r = 1..7 and D < 65536 (whose
//   tiles fit shared memory): what the rig, the CLI and the benchmarks run
//   (r = 5). Here it runs over the whole range, d_start = 0 and count = D,
//   and stores the low half of each pixel's smallest key (SAD << 16) | d,
//   the disparity. A 16-row tile for small launches was measured and did not
//   pay (PERF.md).
// * The general body, for every other radius up to 112, r = 0 and D up to W:
//   a block of NT threads owns 32 rows and NT - 2r columns over byte tiles;
//   per d, thread c slides column c's sum down (two absolute differences a
//   row), and after the barrier adds its 2r + 1 neighbours for each row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sad_strips.cuh"

namespace {

using gsm_strips::kMaxSmem;
using gsm_strips::kStripH;
using gsm_strips::kStripThreads;
using gsm_strips::kTileW;
using gsm_strips::StoreDisparity;

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

// Launches the body that (D, r) takes; with `plan`, launches nothing and
// fills {body, tile rows, tile columns, threads, blocks, blocks per SM}.
cudaError_t run(const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H, int W, int D,
                int r, cudaStream_t s, int* plan) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 1 || D > W || r < 0)
    return cudaErrorInvalidValue;
  int* occupancy = plan ? &plan[5] : nullptr;
  const bool strips = gsm_strips::takes_strips(D, D, r);
  const int nt = strips ? kStripThreads : 2 * r + kTileH <= 128 ? 128 : 256;
  if (plan)
    gsm_strips::fill_plan(plan, strips, strips ? kStripH : kTileH, strips ? kTileW : nt - 2 * r,
                          nt, B, H, W);
  if (strips)
    return gsm_strips::run_strips(r, l, rt, o, B, H, W, 0, D, StoreDisparity(), s, occupancy);
  if (nt == 128) return launch<128>(l, rt, o, B, H, W, D, r, s, occupancy);
  if (2 * r + kTileH <= 256) return launch<256>(l, rt, o, B, H, W, D, r, s, occupancy);
  return cudaErrorInvalidValue;
}

}  // namespace

// Which body (D, r) runs: 1 the strip body, 0 the general one.
extern "C" int gsm_sad_wta_body(int D, int r) {
  return gsm_strips::takes_strips(D, D, r) ? 1 : 0;
}

// How gsm_sad_wta_u8 launches this shape on the current device: plan = {body,
// tile rows, tile columns, threads, blocks, blocks per SM (the occupancy
// query's), SMs}. Launches nothing. Returns the CUDA error code.
extern "C" int gsm_sad_wta_plan(int B, int H, int W, int D, int r, int* plan) {
  cudaError_t err = run(nullptr, nullptr, nullptr, B, H, W, D, r, nullptr, plan);
  return err != cudaSuccess ? err : gsm_strips::device_sms(&plan[6]);
}

// (B, H, W) uint8 left/right -> (B, H, W) int32 disparity, launched on
// `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_sad_wta_u8(const void* left, const void* right, void* out,
                              int B, int H, int W, int D, int r, void* stream) {
  return run(static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
             static_cast<int32_t*>(out), B, H, W, D, r, static_cast<cudaStream_t>(stream),
             nullptr);
}
