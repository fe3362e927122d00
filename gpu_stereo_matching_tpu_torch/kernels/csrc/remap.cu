// Bilinear remap of uint8 images through float32 maps, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_stereo_matching_tpu/kernels/remap.py::
// remap_bilinear_u8_planned (bodies _remap_kernel_tiled and _remap_kernel).
// The TPU kernel sweeps a host-built offset plan because the TPU has no
// per-pixel gather; Hopper gathers directly, so there is no plan: one thread
// per output pixel reads its four taps.
//
// Per pixel, op for op as gpu_stereo_matching_tpu/ops/remap.py:
//   x0f = floor(map_x), fx = map_x - x0f (and the same in y);
//   valid iff x0 >= 0, y0 >= 0, x0 + 1 <= W - 1, y0 + 1 <= H - 1 (strict);
//   top = (1 - fy) * ((1 - fx) * q11 + fx * q12);
//   bot = fy * ((1 - fx) * q21 + fx * q22);
//   out = clamp(rint(top + bot), 0, 255), or 0 where invalid.
// Every product and sum is an explicit round-to-nearest intrinsic, so no
// multiply-add is contracted into an FMA: one ulp can flip the
// round-half-even cast, and the reference rounds after each operation.
//
// What bounds it: per output pixel it reads 8 bytes of maps and about 1
// new byte of source (the four taps share cache lines with the
// neighbours'), writes 1 byte, and does a dozen float operations: it is
// bound by device-memory bandwidth, and at one 720p frame by launch
// latency. Times are in PERF.md.
// Design: coalesced map reads and output writes along a row; the taps of
// neighbouring threads fall in the same or adjacent cache lines because
// rectification maps are smooth. A batch is one launch (grid.y = frame),
// so the maps are fetched once per frame from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void remap_kernel(const uint8_t* __restrict__ src,
                             const float* __restrict__ map_x,
                             const float* __restrict__ map_y,
                             uint8_t* __restrict__ out, int Hs, int Ws, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t b = blockIdx.y;
  const float mx = map_x[p];
  const float my = map_y[p];
  const float x0f = floorf(mx);
  const float y0f = floorf(my);
  uint8_t res = 0;
  // x0 + 1 <= Ws - 1 is x0 <= Ws - 2 for an integer x0; comparing the
  // floats also keeps NaN and out-of-int32-range maps invalid.
  if (x0f >= 0.0f && y0f >= 0.0f && x0f <= (float)(Ws - 2) && y0f <= (float)(Hs - 2)) {
    const uint8_t* t = src + b * Hs * Ws + (size_t)(int)y0f * Ws + (int)x0f;
    const float q11 = t[0], q12 = t[1], q21 = t[Ws], q22 = t[Ws + 1];
    const float fx = __fsub_rn(mx, x0f);
    const float fy = __fsub_rn(my, y0f);
    const float gx = __fsub_rn(1.0f, fx);
    const float gy = __fsub_rn(1.0f, fy);
    const float top = __fmul_rn(gy, __fadd_rn(__fmul_rn(gx, q11), __fmul_rn(fx, q12)));
    const float bot = __fmul_rn(fy, __fadd_rn(__fmul_rn(gx, q21), __fmul_rn(fx, q22)));
    const float v = rintf(__fadd_rn(top, bot));
    res = (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
  }
  out[b * n + p] = res;
}

}  // namespace

// (B, Hs, Ws) uint8 sources and (Ho, Wo) float32 maps -> (B, Ho, Wo) uint8,
// launched on `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_remap_bilinear_u8(const void* src, const void* map_x,
                                     const void* map_y, void* out, int B, int Hs,
                                     int Ws, int Ho, int Wo, void* stream) {
  if (B < 1 || B > 65535 || Hs < 2 || Ws < 2 || Ho < 1 || Wo < 1)
    return cudaErrorInvalidValue;
  const long long n = (long long)Ho * Wo;
  if (n > INT32_MAX - 256) return cudaErrorInvalidValue;
  const int threads = 256;
  dim3 grid((unsigned)((n + threads - 1) / threads), B);
  remap_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(map_x),
      static_cast<const float*>(map_y), static_cast<uint8_t*>(out), Hs, Ws, (int)n);
  return cudaGetLastError();
}
