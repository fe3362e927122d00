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
// 1080x1920, D=64: about 0.16 ms of HBM time at 3.35 TB/s). The arithmetic
// is the fused kernel's: a vertical running sum and a (2r + 1)-tap
// horizontal sum per pixel per disparity, out of shared memory.
// Design: the fused kernel's tiling. A block of NT threads owns kTileH rows
// and NT - 2r output columns; both images' tiles are staged once in shared
// memory with their halos, so the disparity loop reads no device memory.
// Per d, thread c slides a vertical sum down column c into a double-buffered
// shared array; after one barrier each output thread adds its 2r + 1
// neighbours for each row and stores the row's value: the stores of a warp
// are consecutive in x.
//
// gsm_wta_i32: a (D, N) int32 volume -> (N) int32 argmin over d. One thread
// per pixel walks d upward and keeps (min, argmin) on a strict '<', so ties
// go to the smallest d, as torch.argmin. The TPU kernel packs the key
// SAD * D + d instead; the right-view volume holds INT32_MAX where x + d is
// past the image, and there that key overflows int32, so no key is packed
// here. What bounds it: reading the volume once (D*N*4 bytes); the loads of
// a warp are consecutive in N.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr size_t kMaxSmem = 232448;  // opt-in shared memory per block on sm_90

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
                          int H, int W, int D, int r, int invalid, cudaStream_t stream) {
  const size_t halo_rows = kTileH + 2 * r;
  const size_t smem = 2 * kTileH * NT * sizeof(int32_t) + halo_rows * NT +
                      halo_rows * (NT + D - 1);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sad_volume_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tw = NT - 2 * r;
  dim3 grid((W + tw - 1) / tw, (H + kTileH - 1) / kTileH);
  sad_volume_kernel<NT><<<grid, NT, smem, stream>>>(left, right, out, H, W, D, r, invalid);
  return cudaGetLastError();
}

constexpr int kWtaThreads = 256;

__global__ void __launch_bounds__(kWtaThreads) wta_kernel(
    const int32_t* __restrict__ sad, int32_t* __restrict__ out, int D, int n) {
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
}

}  // namespace

// (H, W) uint8 left/right -> (D, H, W) int32 SAD volume on `stream`;
// `invalid` is the per-pixel cost of columns x < d. Returns the CUDA error
// code (0 on success).
extern "C" int gsm_sad_volume_u8(const void* left, const void* right, void* out,
                                 int H, int W, int D, int r, int invalid,
                                 void* stream) {
  if (H < 1 || W < 1 || D < 1 || D > W || r < 0 || invalid < 0 || invalid > 255)
    return cudaErrorInvalidValue;
  const uint8_t* l = static_cast<const uint8_t*>(left);
  const uint8_t* rt = static_cast<const uint8_t*>(right);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (2 * r + 32 <= 128) return launch_volume<128>(l, rt, o, H, W, D, r, invalid, s);
  if (2 * r + 32 <= 256) return launch_volume<256>(l, rt, o, H, W, D, r, invalid, s);
  return cudaErrorInvalidValue;
}

// (D, n) int32 volume -> (n) int32 argmin over d (ties to the smallest d),
// on `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_wta_i32(const void* sad, void* out, int D, int n, void* stream) {
  if (D < 1 || n < 1) return cudaErrorInvalidValue;
  const int blocks = (n + kWtaThreads - 1) / kWtaThreads;
  wta_kernel<<<blocks, kWtaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sad), static_cast<int32_t*>(out), D, n);
  return cudaGetLastError();
}
