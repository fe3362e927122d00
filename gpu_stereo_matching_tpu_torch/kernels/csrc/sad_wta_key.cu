// Partial-range packed-key block matching for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_block_matching_key in
// gpu_stereo_matching_tpu/kernels/sad_wta.py (bodies _key_kernel and
// _packed_key_kernel, which give the same integers). It is what one shard of
// a disparity-sharded mesh runs: (B, H, W) uint8 pairs and a range
// [d_start, d_start + count) of the D_total disparities -> (B, H, W) int32
// keys,
//   key(y, x) = min over d in the range of SAD(d, y, x) * D_total + d,
// so that an elementwise minimum over the shards' keys, taken mod D_total,
// is the global argmin with ties to the smallest d.
//
// SAD follows the fused formula of sad_wta.cu exactly, in int32:
//   diff(y, x)  = |L(y, x) - R(y, x - d)|, rows outside the image are 0;
//   v(y, x)     = sum over |y' - y| <= r of diff(y', x), then
//   v(y, x)     = 255 * (2r + 1) where x < d, d the GLOBAL disparity;
//   SAD(y, x)   = sum over |x' - x| <= r, 0 <= x' < W of v(y, x').
// The image's own top and bottom are its borders: a caller that passes a
// slab with halo rows crops them itself.
//
// What bounds it: at 1080x1920 a frame is 4 MB in and 8 MB of keys out, a
// few microseconds of HBM time; the work is `count` disparities times a few
// integer sums per pixel, so integer issue bounds it, and its time falls
// with `count`.
//
// Two hand-written bodies; gsm_sad_key_u8 picks one from (count, D_total, r)
// alone and gsm_sad_key_body tells which:
//
// * The strip body of sad_strips.cuh, for r = 1..7 and D_total < 65536
//   (whose tiles fit shared memory): what the sharded steps run (r = 5). The
//   loop keeps the same 16:16 key as sad_wta.cu, (SAD << 16) | d with the
//   global d, because for d < D_total < 2^16 and SAD < 2^16 it orders the
//   pairs (SAD, d) exactly as SAD * D_total + d does; each pixel's smallest
//   key is widened once, on the way out.
// * The general body, for every other radius up to 112 and r = 0: a block
//   of NT threads owns kTileH output rows and NT - 2r output columns and
//   stages both tiles once in shared memory as bytes. The right tile holds
//   NT + count - 1 columns: its first column serves the largest shift,
//   d_start + count - 1, its last the smallest, d_start. Per d, thread c
//   slides a vertical running sum down column c into a double-buffered
//   shared array; after one barrier each output thread adds its 2r + 1
//   neighbours for each of its rows and keeps the running minimum key of
//   those rows in registers.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sad_strips.cuh"

namespace {

using gsm_strips::kMaxSmem;
using gsm_strips::kStripH;
using gsm_strips::kStripThreads;
using gsm_strips::kTileW;

// What the strip body stores for a pixel: its smallest key (SAD << 16) | d
// widened to SAD * total + d.
struct StoreKey {
  uint32_t total;
  __device__ __forceinline__ uint32_t operator()(uint32_t key) const {
    return (key >> 16) * total + (key & 0xffff);
  }
};

// ---------------------------------------------------------------------------
// The general body: any radius up to 112, r = 0.
// ---------------------------------------------------------------------------

constexpr int kTileH = 32;

template <int NT>
__global__ void __launch_bounds__(NT) sad_key_kernel(
    const uint8_t* __restrict__ left, const uint8_t* __restrict__ right,
    int32_t* __restrict__ out, int H, int W, int d_start, int count, int total,
    int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo_rows = kTileH + 2 * r;
  const int rw = NT + count - 1;  // staged width of the right tile
  const int d_last = d_start + count - 1;
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
  // x0 - r - d_last + col (right); staged row row holds y0 - r + row.
  for (int i = c; i < halo_rows * NT; i += NT) {
    const int row = i / NT, col = i - row * NT;
    const int gy = y0 - r + row, gx = x0 - r + col;
    ls[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? lf[(size_t)gy * W + gx] : 0;
  }
  for (int i = c; i < halo_rows * rw; i += NT) {
    const int row = i / rw, col = i - row * rw;
    const int gy = y0 - r + row, gx = x0 - r - d_last + col;
    rs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? rf[(size_t)gy * W + gx] : 0;
  }
  __syncthreads();

  const int k = 2 * r + 1;
  const int invalid = 255 * k;
  const int xc = x0 - r + c;  // this thread's column
  const bool is_out = c >= r && c < NT - r && xc < W;

  int best[kTileH];
#pragma unroll
  for (int i = 0; i < kTileH; ++i) best[i] = INT_MAX;

  for (int n = 0; n < count; ++n) {
    const int d = d_start + n;  // the global disparity
    // Double buffer: a thread writes buffer n & 1 only after every thread
    // has passed iteration n - 1's barrier, so the reads of n - 2 are done.
    int32_t* v = vs + (n & 1) * kTileH * NT;
    if (xc < 0 || xc >= W) {
      for (int i = 0; i < kTileH; ++i) v[i * NT + c] = 0;
    } else if (xc < d) {
      for (int i = 0; i < kTileH; ++i) v[i * NT + c] = invalid;
    } else {
      const uint8_t* lcol = ls + c;
      const uint8_t* rcol = rs + c + (d_last - d);  // global column xc - d
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
        best[i] = min(best[i], s * total + d);
      }
    }
  }

  if (is_out) {
#pragma unroll
    for (int i = 0; i < kTileH; ++i) {
      if (y0 + i < H) out[frame + (size_t)(y0 + i) * W + xc] = best[i];
    }
  }
}

template <int NT>
cudaError_t launch(const uint8_t* left, const uint8_t* right, int32_t* out,
                   int B, int H, int W, int d_start, int count, int total, int r,
                   cudaStream_t stream, int* occupancy) {
  const size_t halo_rows = kTileH + 2 * r;
  const size_t smem = 2 * kTileH * NT * sizeof(int32_t) + halo_rows * NT +
                      halo_rows * (NT + count - 1);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sad_key_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, sad_key_kernel<NT>, NT, smem);
  const int tw = NT - 2 * r;
  dim3 grid((W + tw - 1) / tw, (H + kTileH - 1) / kTileH, B);
  sad_key_kernel<NT><<<grid, NT, smem, stream>>>(left, right, out, H, W, d_start,
                                                count, total, r);
  return cudaGetLastError();
}

// Launches the body that (count, total, r) takes; with `plan`, launches
// nothing and fills {body, tile rows, tile columns, threads, blocks, blocks
// per SM}. A key must fit int32: 255 * (2r + 1)^2 * total + total < 2^31.
cudaError_t run(const uint8_t* l, const uint8_t* rt, int32_t* o, int B, int H, int W,
                int d_start, int count, int total, int r, cudaStream_t s, int* plan) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || r < 0 || count < 1 || d_start < 0 ||
      total < 1 || total > W || d_start > total - count)
    return cudaErrorInvalidValue;
  const long long worst = 255LL * (2 * r + 1) * (2 * r + 1) * total + total;
  if (worst > INT_MAX) return cudaErrorInvalidValue;
  int* occupancy = plan ? &plan[5] : nullptr;
  const bool strips = gsm_strips::takes_strips(count, total, r);
  const int nt = strips ? kStripThreads : 2 * r + kTileH <= 128 ? 128 : 256;
  if (plan)
    gsm_strips::fill_plan(plan, strips, strips ? kStripH : kTileH, strips ? kTileW : nt - 2 * r,
                          nt, B, H, W);
  if (strips)
    return gsm_strips::run_strips(r, l, rt, o, B, H, W, d_start, count,
                                  StoreKey{(uint32_t)total}, s, occupancy);
  if (nt == 128) return launch<128>(l, rt, o, B, H, W, d_start, count, total, r, s, occupancy);
  if (2 * r + kTileH <= 256)
    return launch<256>(l, rt, o, B, H, W, d_start, count, total, r, s, occupancy);
  return cudaErrorInvalidValue;
}

}  // namespace

// Which body a range of `count` of `total` disparities runs at radius r: 1
// the strip body, 0 the general one.
extern "C" int gsm_sad_key_body(int count, int total, int r) {
  return gsm_strips::takes_strips(count, total, r) ? 1 : 0;
}

// How gsm_sad_key_u8 launches this shape and range on the current device:
// plan = {body, tile rows, tile columns, threads, blocks, blocks per SM (the
// occupancy query's, asked for this count's shared memory), SMs}. Launches
// nothing. Returns the CUDA error code.
extern "C" int gsm_sad_key_plan(int B, int H, int W, int count, int total, int r, int* plan) {
  cudaError_t err = run(nullptr, nullptr, nullptr, B, H, W, 0, count, total, r, nullptr, plan);
  return err != cudaSuccess ? err : gsm_strips::device_sms(&plan[6]);
}

// (B, H, W) uint8 left/right -> (B, H, W) int32 keys over the disparities
// [d_start, d_start + count) of `total`, launched on `stream`. Refuses a
// radius and total whose largest key does not fit int32. Returns the CUDA
// error code (0 on success).
extern "C" int gsm_sad_key_u8(const void* left, const void* right, void* out,
                              int B, int H, int W, int d_start, int count,
                              int total, int r, void* stream) {
  return run(static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
             static_cast<int32_t*>(out), B, H, W, d_start, count, total, r,
             static_cast<cudaStream_t>(stream), nullptr);
}
