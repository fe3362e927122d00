// Gray conversion of uint8 images of three channels, for Hopper (sm_90a).
//
// No TPU kernel: the port's kernel for the JAX package's XLA stage
// gpu_stereo_matching_tpu/ops/color.py::grayscale_u8, a float32 tensordot
// that runs inside the rig's jitted frame step. The arithmetic is gray.cuh's
// device function, which the rig's front end (remap.cu) also applies at
// every bilinear tap.
//
// What bounds it: bytes. A pixel reads 3 bytes and writes 1, and costs about
// a dozen instructions, none on the conversion pipe (gray.cuh); 4 bytes a
// pixel at 3.35 TB/s is 2.5 us for a 1080x1920 image. Design: a thread owns
// 16 adjacent pixels, read as three 16-byte loads and written as one
// 16-byte store, so a warp moves 1536
// contiguous bytes in and 512 out. A thread whose 16 pixels pass the end of
// the image (the tail), and every thread when a base is not 16-byte aligned,
// runs the scalar body: one byte load a channel and one byte store a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gray.cuh"

namespace {

using gsm::GrayWeights;
using gsm::Rounding;

constexpr int kPixels = 16;   // adjacent pixels a thread owns
constexpr int kThreads = 256;

template <Rounding Mode, bool Vec>
__global__ void __launch_bounds__(kThreads)
gray_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, long long n,
            GrayWeights w) {
  const long long p0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPixels;
  if (p0 >= n) return;
  if (Vec && p0 + kPixels <= n) {
    const uint4* in4 = reinterpret_cast<const uint4*>(src + 3 * p0);
    uint32_t in[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 v = in4[i];
      in[4 * i] = v.x;
      in[4 * i + 1] = v.y;
      in[4 * i + 2] = v.z;
      in[4 * i + 3] = v.w;
    }
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kPixels; ++i) {
      // Byte 3i + c of the 48 loaded bytes is channel c of pixel i.
      const int b = 3 * i;
      const float c0 = gsm::byte_to_float(in[b >> 2], b & 3);
      const float c1 = gsm::byte_to_float(in[(b + 1) >> 2], (b + 1) & 3);
      const float c2 = gsm::byte_to_float(in[(b + 2) >> 2], (b + 2) & 3);
      o[i >> 2] |= gsm::gray_byte<Mode>(c0, c1, c2, w) << (8 * (i & 3));
    }
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(o[0], o[1], o[2], o[3]);
    return;
  }
  const long long end = p0 + kPixels < n ? p0 + kPixels : n;
  for (long long p = p0; p < end; ++p) {
    out[p] = static_cast<uint8_t>(gsm::gray_byte<Mode>(gsm::u8_to_float(src[3 * p]),
                                                        gsm::u8_to_float(src[3 * p + 1]),
                                                        gsm::u8_to_float(src[3 * p + 2]), w));
  }
}

template <Rounding Mode>
void launch(const uint8_t* src, uint8_t* out, long long n, GrayWeights w, bool vec,
            unsigned blocks, cudaStream_t stream) {
  if (vec) {
    gray_kernel<Mode, true><<<blocks, kThreads, 0, stream>>>(src, out, n, w);
  } else {
    gray_kernel<Mode, false><<<blocks, kThreads, 0, stream>>>(src, out, n, w);
  }
}

}  // namespace

// Which body a launch of gsm_gray_u8 runs with these bases: 1 for 16-byte
// loads and stores (the tail still scalar), 0 for the scalar body.
extern "C" int gsm_gray_body(const void* src, const void* out) {
  return ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

// (n, 3) uint8 pixels -> (n,) uint8 gray, g = fma(c2, w2, fma(c1, w1, c0 * w0))
// rounded half to even (half_up = 0) or half up (half_up = 1) and saturated,
// launched on `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_gray_u8(const void* src, void* out, long long n, float w0, float w1,
                           float w2, int half_up, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long blocks = (n + kPixels * kThreads - 1) / (kPixels * kThreads);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const bool vec = gsm_gray_body(src, out) != 0;
  const GrayWeights w = {w0, w1, w2};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint8_t*>(out);
  if (half_up) {
    launch<Rounding::kHalfUp>(in, o, n, w, vec, (unsigned)blocks, s);
  } else {
    launch<Rounding::kHalfEven>(in, o, n, w, vec, (unsigned)blocks, s);
  }
  return cudaGetLastError();
}
