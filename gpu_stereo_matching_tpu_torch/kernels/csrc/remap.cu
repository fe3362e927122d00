// Bilinear remap of uint8 images through float32 maps, for Hopper (sm_90a),
// and the rig's front end: BGR -> gray -> remap for both views in one launch.
//
// Replaces the TPU kernel gpu_stereo_matching_tpu/kernels/remap.py::
// remap_bilinear_u8_planned (bodies _remap_kernel_tiled and _remap_kernel).
// The TPU kernel sweeps a host-built offset plan because the TPU has no
// per-pixel gather; Hopper gathers directly, so there is no plan.
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
// One body, with the source format as a policy. GraySource reads 1 byte a
// tap: the TPU kernel's contract, behind gsm_remap_bilinear_u8. BgrSource
// reads 3 bytes a tap (B, G, R) and turns each tap into gray with the gray
// kernel's device function (gray.cuh: the block-matching weights, half to
// even) before the interpolation, which takes (float)gray of each tap as
// the plain path remap(gray(bgr)) does: gsm_rectify_gray_pair writes both
// views' rectified gray batches in one launch, the view being grid.y.
//
// What bounds it: per output pixel the two maps (8 bytes) are read once a
// launch, and per pixel and frame 1 (gray) or 3 (BGR) new source bytes are
// read (the taps share cache lines with the neighbours') and 1 byte is
// written: for the rig's batch of 8 at 720p, both views, 73.7 MB, 0.022 ms
// at 3.35 TB/s. From BGR a pixel and frame also costs about 80 instructions
// (12 tap bytes, their 4 gray values, the interpolation), 0.035 ms at the
// SMs' full instruction rate, which the dependent loads of a thread at half
// occupancy (64 registers) do not reach: instructions and latency bound it,
// not bytes. A single pair (B = 1) is a launch shorter than its enqueue.
//
// Design: a thread owns kPixels output pixels of the flat (Ho * Wo) index,
// in groups of kGroup adjacent ones; a warp's lanes take neighbouring
// groups, so a tap load of the warp spans 32 * kGroup neighbouring pixels.
// It loads their maps once, a group as one vector, works out the taps'
// offset, the weights and the validity once, keeps them in registers and
// then loops over the frames: per frame it gathers the taps and stores a
// group's bytes as one word. So the maps cross device memory once a launch,
// not once a frame, and each call of the rig is one launch, not a gray pass
// and a remap pass per view. No step runs on the conversion pipe (16
// operations a clock an SM): bytes become floats, and floats round and
// become bytes, by the exact float adds of gray.cuh; with rintf and integer
// conversions the front end took 10% longer. Where Ho * Wo is no multiple
// of kGroup or a map or the output is not aligned for the vector accesses,
// the entry runs the scalar body: the same layout with scalar map loads
// and byte stores, masked pixel by pixel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gray.cuh"

namespace {

constexpr int kPixels = 8;  // output pixels a thread owns ...
constexpr int kGroup = 4;   // ... as groups of kGroup adjacent pixels: one float4, one word
constexpr int kThreads = 256;
constexpr int kGroupStride = kThreads * kGroup;  // pixels from a group to the thread's next

// One output pixel's taps and weights, from the maps, for every frame.
struct Tap {
  int off;  // y0 * Ws + x0 of the top-left tap; -1 where any tap is outside
  float fx, fy, gx, gy;
};

__device__ __forceinline__ Tap tap_of(float mx, float my, int Hs, int Ws) {
  const float x0f = floorf(mx);
  const float y0f = floorf(my);
  Tap t;
  // x0 + 1 <= Ws - 1 is x0 <= Ws - 2 for an integer x0; comparing the
  // floats also keeps NaN and out-of-int32-range maps invalid.
  t.off = (x0f >= 0.0f && y0f >= 0.0f && x0f <= (float)(Ws - 2) && y0f <= (float)(Hs - 2))
              ? (int)y0f * Ws + (int)x0f
              : -1;
  t.fx = __fsub_rn(mx, x0f);
  t.fy = __fsub_rn(my, y0f);
  t.gx = __fsub_rn(1.0f, t.fx);
  t.gy = __fsub_rn(1.0f, t.fy);
  return t;
}

// The interpolated byte: clamp(rint(top + bot), 0, 255), with the rounding
// and the conversion spelled by gsm::round_to_byte (clamping first is the
// same, 0 and 255 being integers).
__device__ __forceinline__ uint32_t bilinear(const Tap& t, float q11, float q12, float q21,
                                             float q22) {
  const float top = __fmul_rn(t.gy, __fadd_rn(__fmul_rn(t.gx, q11), __fmul_rn(t.fx, q12)));
  const float bot = __fmul_rn(t.fy, __fadd_rn(__fmul_rn(t.gx, q21), __fmul_rn(t.fx, q22)));
  return gsm::round_to_byte(gsm::saturate(__fadd_rn(top, bot)));
}

// One byte a tap.
struct GraySource {
  static constexpr int kBytes = 1;
  __device__ static __forceinline__ uint32_t pixel(const uint8_t* frame, const Tap& t, int Ws) {
    const uint8_t* p = frame + t.off;
    return bilinear(t, gsm::u8_to_float(p[0]), gsm::u8_to_float(p[1]),
                    gsm::u8_to_float(p[Ws]), gsm::u8_to_float(p[Ws + 1]));
  }
};

// Three bytes a tap, turned into gray before the interpolation.
struct BgrSource {
  static constexpr int kBytes = 3;

  // The gray levels of the BGR pixels at p and p + 3. Six byte loads: they
  // measured faster than the 2 or 3 aligned words that hold the bytes and
  // two __byte_perm, whose address arithmetic costs more instructions than
  // the loads it saves.
  __device__ static __forceinline__ void row_pair(const uint8_t* p, float& left, float& right) {
    const gsm::GrayWeights w = gsm::block_matching_weights();
    left = gsm::gray_level_half_even(gsm::u8_to_float(p[0]), gsm::u8_to_float(p[1]),
                                     gsm::u8_to_float(p[2]), w);
    right = gsm::gray_level_half_even(gsm::u8_to_float(p[3]), gsm::u8_to_float(p[4]),
                                      gsm::u8_to_float(p[5]), w);
  }

  __device__ static __forceinline__ uint32_t pixel(const uint8_t* frame, const Tap& t, int Ws) {
    float q11, q12, q21, q22;
    row_pair(frame + 3 * t.off, q11, q12);
    row_pair(frame + 3 * (t.off + Ws), q21, q22);
    return bilinear(t, q11, q12, q21, q22);
  }
};

// One view: (B, Hs, Ws[, 3]) sources, (Ho, Wo) maps, (B, Ho, Wo) outputs.
struct View {
  const uint8_t* src;
  const float* map_x;
  const float* map_y;
  uint8_t* out;
};

// Thread t of block k owns the pixels k * kThreads * kPixels + t * kGroup +
// i * kGroupStride + g (group i, pixel g of the group): a warp's lanes take
// neighbouring groups, so each tap load of a warp spans 32 * kGroup
// neighbouring pixels' taps. The vector body (whole groups: n a multiple of
// kGroup; aligned maps and output) loads a group's maps as one vector and
// stores its bytes as one word; the scalar body does both pixel by pixel.
template <class Source, bool Vec>
__device__ __forceinline__ void remap_body(const View& view, int B, int Hs, int Ws, int n) {
  const int base = blockIdx.x * (kThreads * kPixels) + threadIdx.x * kGroup;
  if (base >= n) return;
  float mx[kPixels], my[kPixels];
#pragma unroll
  for (int i = 0; i < kPixels / kGroup; ++i) {
    const int p = base + i * kGroupStride;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) mx[i * kGroup + g] = my[i * kGroup + g] = -1.0f;
    if constexpr (Vec) {
      if (p < n) {  // n is a multiple of kGroup: a group is all in or all out
        const float4 x = *reinterpret_cast<const float4*>(view.map_x + p);
        const float4 y = *reinterpret_cast<const float4*>(view.map_y + p);
        const int j = i * kGroup;
        mx[j] = x.x, mx[j + 1] = x.y, mx[j + 2] = x.z, mx[j + 3] = x.w;
        my[j] = y.x, my[j + 1] = y.y, my[j + 2] = y.z, my[j + 3] = y.w;
      }
    } else {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (p + g < n) {
          mx[i * kGroup + g] = view.map_x[p + g];
          my[i * kGroup + g] = view.map_y[p + g];
        }
      }
    }
  }
  // Past n the maps stay -1: invalid, no tap is read and nothing is stored.
  Tap taps[kPixels];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) taps[j] = tap_of(mx[j], my[j], Hs, Ws);

  const size_t frame_bytes = (size_t)Hs * Ws * Source::kBytes;
  for (int b = 0; b < B; ++b) {
    const uint8_t* frame = view.src + b * frame_bytes;
    uint8_t* out = view.out + (size_t)b * n + base;
#pragma unroll
    for (int i = 0; i < kPixels / kGroup; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const Tap& t = taps[i * kGroup + g];
        const uint32_t v = t.off >= 0 ? Source::pixel(frame, t, Ws) : 0u;
        if constexpr (Vec) {
          word |= v << (8 * g);
        } else if (base + i * kGroupStride + g < n) {
          out[i * kGroupStride + g] = static_cast<uint8_t>(v);
        }
      }
      if constexpr (Vec) {
        if (base + i * kGroupStride < n) {
          *reinterpret_cast<uint32_t*>(out + i * kGroupStride) = word;
        }
      }
    }
  }
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads)
remap_u8_kernel(View view, int B, int Hs, int Ws, int n) {
  remap_body<GraySource, Vec>(view, B, Hs, Ws, n);
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads)
front_end_kernel(View left, View right, int B, int Hs, int Ws, int n) {
  // Field by field: selecting a whole parameter struct copies both to the stack.
  const bool r = blockIdx.y != 0;
  const View view = {r ? right.src : left.src, r ? right.map_x : left.map_x,
                     r ? right.map_y : left.map_y, r ? right.out : left.out};
  remap_body<BgrSource, Vec>(view, B, Hs, Ws, n);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The vector body needs whole groups (n a multiple of kGroup, so that every
// frame's output starts aligned too), 16-byte aligned maps and a 4-byte
// aligned output.
bool vector_body(long long n, const View* views, int count) {
  bool ok = n % kGroup == 0;
  for (int v = 0; v < count; ++v) {
    ok = ok && aligned(views[v].map_x, 4 * kGroup) && aligned(views[v].map_y, 4 * kGroup) &&
         aligned(views[v].out, kGroup);
  }
  return ok;
}

bool bad_shape(int B, int Hs, int Ws, int Ho, int Wo, int bytes) {
  return B < 1 || Hs < 2 || Ws < 2 || Ho < 1 || Wo < 1 ||
         (long long)Ho * Wo > INT32_MAX - 2 * kPixels * kThreads ||
         (long long)Hs * Ws * bytes > INT32_MAX;
}

template <class Kernel>
cudaError_t blocks_per_sm(int* per_sm, Kernel kernel) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
}

dim3 grid_of(int Ho, int Wo, int views) {
  const long long n = (long long)Ho * Wo;
  const long long per_block = (long long)kPixels * kThreads;
  return dim3((unsigned)((n + per_block - 1) / per_block), views);
}

}  // namespace

// (B, Hs, Ws) uint8 sources and (Ho, Wo) float32 maps -> (B, Ho, Wo) uint8,
// launched on `stream`; *body (if not null) gets 1 for the vector body and 0
// for the scalar one. Returns the CUDA error code (0 on success).
extern "C" int gsm_remap_bilinear_u8(const void* src, const void* map_x, const void* map_y,
                                     void* out, int B, int Hs, int Ws, int Ho, int Wo,
                                     int* body, void* stream) {
  if (bad_shape(B, Hs, Ws, Ho, Wo, 1)) return cudaErrorInvalidValue;
  const View view = {static_cast<const uint8_t*>(src), static_cast<const float*>(map_x),
                     static_cast<const float*>(map_y), static_cast<uint8_t*>(out)};
  const int n = Ho * Wo;
  const bool vec = vector_body(n, &view, 1);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    remap_u8_kernel<true><<<grid_of(Ho, Wo, 1), kThreads, 0, s>>>(view, B, Hs, Ws, n);
  } else {
    remap_u8_kernel<false><<<grid_of(Ho, Wo, 1), kThreads, 0, s>>>(view, B, Hs, Ws, n);
  }
  if (body) *body = vec;
  return cudaGetLastError();
}

// The rig's front end: (B, Hs, Ws, 3) uint8 BGR batches of the left and the
// right view and each view's (Ho, Wo) float32 maps -> out (2, B, Ho, Wo)
// uint8, out[0] the left view's rectified gray, out[1] the right's; one
// launch on `stream`. *body as for gsm_remap_bilinear_u8.
extern "C" int gsm_rectify_gray_pair(const void* left, const void* right, const void* left_x,
                                     const void* left_y, const void* right_x,
                                     const void* right_y, void* out, int B, int Hs, int Ws,
                                     int Ho, int Wo, int* body, void* stream) {
  if (bad_shape(B, Hs, Ws, Ho, Wo, 3)) return cudaErrorInvalidValue;
  const int n = Ho * Wo;
  auto* o = static_cast<uint8_t*>(out);
  const View views[2] = {
      {static_cast<const uint8_t*>(left), static_cast<const float*>(left_x),
       static_cast<const float*>(left_y), o},
      {static_cast<const uint8_t*>(right), static_cast<const float*>(right_x),
       static_cast<const float*>(right_y), o + (size_t)B * n},
  };
  const bool vec = vector_body(n, views, 2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    front_end_kernel<true><<<grid_of(Ho, Wo, 2), kThreads, 0, s>>>(views[0], views[1], B, Hs,
                                                                   Ws, n);
  } else {
    front_end_kernel<false><<<grid_of(Ho, Wo, 2), kThreads, 0, s>>>(views[0], views[1], B, Hs,
                                                                    Ws, n);
  }
  if (body) *body = vec;
  return cudaGetLastError();
}

// How a launch of either entry runs for these shapes, with aligned
// allocations (a map or output that is not aligned takes the scalar body):
// fields[0] the body (1 vector, 0 scalar), [1] the output pixels a thread
// owns, [2] threads a block, [3] blocks, [4] blocks an SM holds at once,
// [5] the SMs, [6] adjacent pixels a group. `views` is 1
// (gsm_remap_bilinear_u8) or 2 (the front end).
extern "C" int gsm_remap_plan(int views, int B, int Hs, int Ws, int Ho, int Wo, int* fields) {
  if ((views != 1 && views != 2) || bad_shape(B, Hs, Ws, Ho, Wo, views == 2 ? 3 : 1))
    return cudaErrorInvalidValue;
  const long long n = (long long)Ho * Wo;
  const bool vec = n % kGroup == 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = views == 2
              ? blocks_per_sm(&per_sm, vec ? front_end_kernel<true> : front_end_kernel<false>)
              : blocks_per_sm(&per_sm, vec ? remap_u8_kernel<true> : remap_u8_kernel<false>);
  }
  const dim3 grid = grid_of(Ho, Wo, views);
  fields[0] = vec;
  fields[1] = kPixels;
  fields[2] = kThreads;
  fields[3] = (int)(grid.x * grid.y);
  fields[4] = per_sm;
  fields[5] = sms;
  fields[6] = kGroup;
  return err;
}
