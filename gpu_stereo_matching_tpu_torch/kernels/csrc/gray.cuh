// The gray value of one uint8 pixel of three channels, shared by the gray
// kernel (gray.cu) and the rig's front end (remap.cu), which applies it at
// every bilinear tap; and the exact float <-> byte helpers both use.
//
// g = fma(c2, w2, fma(c1, w1, c0 * w0)) over the stored channel order, each
// step rounded to float32 once: the chain XLA evaluates for the JAX
// package's float32 tensordot (gpu_stereo_matching_tpu/ops/color.py), which
// the port's plain twin (ops/color.py) emulates in float64. Every multiply
// and add is an explicit round-to-nearest intrinsic: the library is built
// with -fmad=false, which leaves an explicit __fmaf_rn alone but would round
// a bare a * b + c twice. Then g saturates to [0, 255] and rounds to an
// integer, half to even or half up (floor(g + 0.5) in float32); rounding
// and saturating commute here, since 0 and 255 are integers.
//
// Conversions between integers and floats, and rintf, run on the SMs'
// conversion pipe at 16 a clock, an eighth of the FMA pipe's rate: at 12
// channel conversions and 5 roundings a pixel and frame the front end took
// 11-18% longer with them. The helpers below spell each one with a byte
// permute or a bitwise or and a float add instead, exact over the ranges
// they are used on.

#pragma once

#include <stdint.h>

namespace gsm {

enum class Rounding { kHalfEven, kHalfUp };

struct GrayWeights {
  float w0, w1, w2;
};

// The block-matching convention: the Rec.601 weights applied to (B, G, R)
// in storage order, rounded half to even.
__host__ __device__ __forceinline__ GrayWeights block_matching_weights() {
  return {0.299f, 0.587f, 0.114f};
}

constexpr float kTwo23 = 8388608.0f;         // 2^23: float32's ulp is 1 from here
constexpr float kRoundMagic = 12582912.0f;   // 1.5 * 2^23

// Byte k of w as a float, exactly: the bits of 2^23 + byte, minus 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t w, uint32_t k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | k)), kTwo23);
}

// A byte (0..255) as a float, exactly.
__device__ __forceinline__ float u8_to_float(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), kTwo23);
}

// x in [0, 255] rounded half to even, as the low byte of the sum's bits:
// 1.5 * 2^23 + x lands where the ulp is 1, so the add rounds x to the
// nearest integer, ties to even, and the integer sits in the low mantissa
// bits (0x4B400000 + round(x)).
__device__ __forceinline__ uint32_t round_to_byte(float x) {
  return __float_as_uint(__fadd_rn(x, kRoundMagic)) & 0xffu;
}

// x in [0, 255] rounded half to even, as a float (exact: the subtraction
// of 1.5 * 2^23 from an integer-valued sum below 2^24).
__device__ __forceinline__ float round_half_even(float x) {
  return __fsub_rn(__fadd_rn(x, kRoundMagic), kRoundMagic);
}

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 255.0f); }

// The unrounded gray value of channels c0, c1, c2 (integer-valued floats).
__device__ __forceinline__ float gray_sum(float c0, float c1, float c2, const GrayWeights& w) {
  return __fmaf_rn(c2, w.w2, __fmaf_rn(c1, w.w1, __fmul_rn(c0, w.w0)));
}

// The rounded, saturated gray value as a float (an integer in [0, 255]):
// what the rig's front end interpolates.
__device__ __forceinline__ float gray_level_half_even(float c0, float c1, float c2,
                                                      const GrayWeights& w) {
  return round_half_even(saturate(gray_sum(c0, c1, c2, w)));
}

// The rounded, saturated gray value as a byte: what the gray kernel stores.
template <Rounding Mode>
__device__ __forceinline__ uint32_t gray_byte(float c0, float c1, float c2,
                                              const GrayWeights& w) {
  const float g = gray_sum(c0, c1, c2, w);
  if constexpr (Mode == Rounding::kHalfEven) {
    return round_to_byte(saturate(g));
  } else {
    return round_to_byte(saturate(floorf(__fadd_rn(g, 0.5f))));
  }
}

}  // namespace gsm
