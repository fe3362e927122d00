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
// Two kernels. remap_u8_kernel, behind gsm_remap_bilinear_u8 (the TPU
// kernel's contract), reads 1 byte a tap (GraySource). front_end_kernel,
// behind gsm_rectify_gray_pair, reads BGR sources and takes, before the
// interpolation, the gray level of each tap by the gray kernel's device
// function (gray.cuh: the block-matching weights, half to even) as the plain
// path remap(gray(bgr)) does; it writes both views' rectified gray batches,
// the view being grid.y.
//
// remap_u8_kernel: a thread owns kPixels output pixels of the flat (Ho * Wo)
// index, in groups of kGroup adjacent ones; a warp's lanes take
// neighbouring groups, so a tap load of the warp spans 32 * kGroup
// neighbouring pixels. It loads their maps once, a group as one vector,
// works out the taps' offset, weights and validity once, keeps them in
// registers and loops over the frames, gathering the taps and storing a
// group's bytes as one word. Where Ho * Wo is no multiple of kGroup or a map
// or the output is not aligned for the vector accesses, the entry runs the
// scalar body: the same layout with scalar map loads and byte stores.
//
// front_end_kernel: what bounds it. Per output pixel the two maps (8 bytes)
// are read once a launch, and per pixel and frame 3 BGR bytes are read and
// 1 byte written: 147.5 MB for the rig's batch of 16 at 800x1280, both
// views, 44 us at 3.35 TB/s. Gathering, as remap_u8_kernel does, each
// output pixel loads its four taps as 12 bytes and turns each tap into gray:
// every source pixel is loaded and converted about four times, once for
// each output pixel whose taps touch it, some 80 instructions a pixel and
// frame, and the dependent loads leave it at 28% of the byte bound.
//
// So a block owns a tile of kTileRows x kTileCols output pixels of one view
// (a warp two rows, a lane the columns lane + 32 j of each) and works out,
// once a launch, every pixel's taps and the tile's source window: the rows
// and columns its valid taps touch, by a block reduction of their floors.
// Then, per tile:
// - the staged path, where the window fits the staging budget (kWindowRows x
//   kWindowCols source pixels). Per frame the window's BGR rows (each 3 x
//   cols contiguous bytes) are copied into shared memory by 16-byte
//   cp.async into one of two stages, each refilled two frames ahead as soon
//   as its frame is converted; each staged pixel is turned into gray once,
//   by the same gray.cuh function, two adjacent pixels a step, and kept as
//   a float (an exact integer 0..255, the value the gather path computes at
//   a tap); after a barrier each output pixel interpolates four
//   shared-memory floats with the same bilinear arithmetic. A tap that is
//   not valid reads the window's first pixel with weights 0, which gives 0
//   as the gather path's test does. On the rig's maps a 16 x 128 tile reads
//   at most 21 x 130 source pixels, 1.10 a pixel on average.
// - the gather path otherwise (wild or strongly distorted maps, flipped or
//   heavily rotated rigs, a window past the budget, or a tile without a
//   valid tap): the gather of BgrSource::pixel at every tap, as before.
// The choice is the kernel's, per tile, from the maps the call passes;
// gsm_front_end_tiles counts the tiles of each path by the same rule.
// Every store is a byte, a warp's 32 lanes on 32 adjacent bytes; the
// layout needs no alignment of the maps or the output. The frames are split
// into grid.z groups only where the tiles alone would not fill the card.
// Measured on an NVIDIA H100 80GB HBM3 (700 W), device time at 800x1280
// through the rig's maps: B = 16 0.105 ms against the gather design's 0.157
// (42% of the byte bound), B = 8 0.058 against 0.081; B = 1 0.015 against
// 0.0125, the window's copy being a second memory round trip after the
// maps' when a block has one frame. Tried and no faster: 32 x 128 tiles of
// 512 threads, a warp a window row in the conversion, four pixels a step,
// 3 or 5 blocks an SM.
// No step runs on the conversion pipe (16 operations a clock an SM): bytes
// become floats, and floats round and become bytes, by the exact float
// adds of gray.cuh; with rintf and integer conversions the front end took
// 10% longer.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "gray.cuh"

namespace {

constexpr int kPixels = 8;  // output pixels a thread owns ...
constexpr int kGroup = 4;   // ... as groups of kGroup adjacent pixels: one float4, one word
constexpr int kThreads = 256;
constexpr int kGroupStride = kThreads * kGroup;  // pixels from a group to the thread's next

// The front end's tiles: a warp owns two rows of a tile, a lane four columns
// of each, 32 apart; kFrontBlocks blocks an SM at 64 registers a thread.
constexpr int kFrontThreads = 256;
constexpr int kFrontBlocks = 4;
constexpr int kWarps = kFrontThreads / 32;
constexpr int kTileRows = 2 * kWarps;  // 16
constexpr int kTileCols = 4 * 32;      // 128
constexpr int kTilePixels = kTileRows * kTileCols / kFrontThreads;  // 8 a thread
// The staging budget, in source pixels: the rig's maps at 800x1280 need at
// most 21 x 130 for a 16 x 128 tile.
constexpr int kWindowRows = 28;
constexpr int kWindowCols = 160;
// A staged BGR row: 3 * kWindowCols bytes from a 16-byte boundary, up to 15
// bytes before the row's first pixel.
constexpr int kBgrPitch = (15 + 3 * kWindowCols + 15) / 16 * 16;  // 496
constexpr int kStages = 2;

// One output pixel's taps and weights, from the maps, for every frame.
struct Tap {
  int off;  // y0 * Ws + x0 of the top-left tap; -1 where any tap is outside (staged: see staged_tap)
  float fx, fy, gx, gy;
};

// Whether the taps at the floors (x0f, y0f) lie in the source. x0 + 1 <= Ws
// - 1 is x0 <= Ws - 2 for an integer x0; comparing the floats also keeps NaN
// and out-of-int32-range maps invalid.
__device__ __forceinline__ bool in_source(float x0f, float y0f, int Hs, int Ws) {
  return x0f >= 0.0f && y0f >= 0.0f && x0f <= (float)(Ws - 2) && y0f <= (float)(Hs - 2);
}

__device__ __forceinline__ Tap tap_of(float mx, float my, int Hs, int Ws) {
  const float x0f = floorf(mx);
  const float y0f = floorf(my);
  Tap t;
  t.off = in_source(x0f, y0f, Hs, Ws) ? (int)y0f * Ws + (int)x0f : -1;
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

// Three bytes a tap, turned into gray before the interpolation: the front
// end's gather path.
struct BgrSource {
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

// ---- The front end ----------------------------------------------------------

// A tile's source window: rows y0 .. y0 + rows - 1 and columns x0 .. x0 +
// cols - 1, the pixels its valid taps read; rows = 0 where it has none.
struct Window {
  int x0, y0, rows, cols;
  bool staged;  // not empty, and within the staging budget
};

struct Staging {
  uint8_t bgr[kStages][kWindowRows * kBgrPitch];  // BGR rows from 16-byte boundaries
  float gray[kWindowRows * kWindowCols];          // the window's gray levels
};

// Pixel k of the calling thread in its tile: row 2 * warp + (k >> 2),
// column lane + 32 * (k & 3).
__device__ __forceinline__ int tile_row(int k) { return 2 * (threadIdx.x >> 5) + (k >> 2); }
__device__ __forceinline__ int tile_col(int k) { return (threadIdx.x & 31) + 32 * (k & 3); }

// Loads the maps of the thread's pixels of the tile at (row0, col0) (-1, an
// invalid tap, past the output) and reduces the floors of the block's valid
// taps to the tile's window. Every thread of the block calls it once.
__device__ __forceinline__ Window tile_window(const View& view, int Hs, int Ws, int Ho, int Wo,
                                              int row0, int col0, float (&mx)[kTilePixels],
                                              float (&my)[kTilePixels]) {
  __shared__ int bounds[4][kWarps];
  int lo_x = INT_MAX, hi_x = INT_MIN, lo_y = INT_MAX, hi_y = INT_MIN;
#pragma unroll
  for (int k = 0; k < kTilePixels; ++k) {
    const int y = row0 + tile_row(k), x = col0 + tile_col(k);
    mx[k] = my[k] = -1.0f;
    if (y < Ho && x < Wo) {
      mx[k] = view.map_x[(size_t)y * Wo + x];
      my[k] = view.map_y[(size_t)y * Wo + x];
    }
    const float x0f = floorf(mx[k]), y0f = floorf(my[k]);
    if (in_source(x0f, y0f, Hs, Ws)) {
      lo_x = min(lo_x, (int)x0f), hi_x = max(hi_x, (int)x0f);
      lo_y = min(lo_y, (int)y0f), hi_y = max(hi_y, (int)y0f);
    }
  }
  const int warp = threadIdx.x >> 5;
  lo_x = __reduce_min_sync(0xffffffffu, lo_x), hi_x = __reduce_max_sync(0xffffffffu, hi_x);
  lo_y = __reduce_min_sync(0xffffffffu, lo_y), hi_y = __reduce_max_sync(0xffffffffu, hi_y);
  if ((threadIdx.x & 31) == 0) {
    bounds[0][warp] = lo_x, bounds[1][warp] = hi_x, bounds[2][warp] = lo_y,
    bounds[3][warp] = hi_y;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo_x = min(lo_x, bounds[0][w]), hi_x = max(hi_x, bounds[1][w]);
    lo_y = min(lo_y, bounds[2][w]), hi_y = max(hi_y, bounds[3][w]);
  }
  Window win = {lo_x, lo_y, 0, 0, false};
  if (lo_x != INT_MAX) {  // the tap to the right and the one below are in the window too
    win.rows = hi_y - lo_y + 2;
    win.cols = hi_x - lo_x + 2;
    win.staged = win.rows <= kWindowRows && win.cols <= kWindowCols;
  }
  return win;
}

// A tap of the staged path: its offset in the window's gray levels; where
// the tap is not valid the window's first pixel with weights 0, which
// interpolates to 0 exactly.
__device__ __forceinline__ Tap staged_tap(float mx, float my, int Hs, int Ws, const Window& w) {
  Tap t = tap_of(mx, my, Hs, Ws);
  if (t.off < 0) {
    t.off = 0;
    t.fx = t.fy = t.gx = t.gy = 0.0f;
  } else {
    t.off = ((int)floorf(my) - w.y0) * kWindowCols + ((int)floorf(mx) - w.x0);
  }
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most kStages - 1 committed groups of the thread are in
// flight: all but the newest kStages - 1 frames' rows are in.
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// Issues the copy of the window's BGR rows of `frame` (frame_bytes bytes)
// into `dst`: row r from the 16-byte boundary at or before its first byte,
// to kBgrPitch bytes a row; a warp a row, a lane a 16-byte chunk. A chunk
// that is not wholly inside the frame is copied byte by byte, its bytes in
// the frame only.
__device__ __forceinline__ void stage_window(uint8_t* dst, const uint8_t* frame,
                                             size_t frame_bytes, int Ws, const Window& w) {
  const int lane = threadIdx.x & 31;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(frame), hi = lo + frame_bytes;
  for (int r = threadIdx.x >> 5; r < w.rows; r += kWarps) {
    const uintptr_t first = lo + ((size_t)(w.y0 + r) * Ws + w.x0) * 3;
    const uintptr_t base = first & ~(uintptr_t)15;
    const int chunks = (int)((first + 3 * w.cols - base + 15) >> 4);
    if (lane < chunks) {
      const uintptr_t src = base + 16 * lane;
      uint8_t* d = dst + r * kBgrPitch + 16 * lane;
      if (src >= lo && src + 16 <= hi) {
        cp_async16(d, reinterpret_cast<const void*>(src));
      } else {
        for (int i = 0; i < 16; ++i) {
          if (src + i >= lo && src + i < hi) d[i] = *reinterpret_cast<const uint8_t*>(src + i);
        }
      }
    }
  }
}

// A block's walk over the window's pixel pairs (rows x ceil(cols / 2)),
// kFrontThreads pairs apart: the calling thread's first row and pair, and
// its step, worked out once a tile.
struct Walk {
  int row, pair, step_rows, step_pairs, pairs;
};

__device__ __forceinline__ Walk walk_of(const Window& w) {
  Walk k = {0, 0, 0, 0, (w.cols + 1) / 2};
  if (k.pairs > 0) {
    k.row = threadIdx.x / k.pairs, k.pair = threadIdx.x - k.row * k.pairs;
    k.step_rows = kFrontThreads / k.pairs, k.step_pairs = kFrontThreads - k.step_rows * k.pairs;
  }
  return k;
}

// Each staged pixel's gray level, once, two adjacent pixels a step (two
// independent chains; in a window of odd width the last step also converts
// the three bytes past the row's last pixel, inside the stage's row, and
// does not store them). Row r of the stage starts `lead` + r * lead_step
// (mod 16) bytes after its 16-byte boundary.
__device__ __forceinline__ void gray_window(float* gray, const uint8_t* bgr, const Window& w,
                                            Walk k, uint32_t lead, uint32_t lead_step) {
  const gsm::GrayWeights weights = gsm::block_matching_weights();
  while (k.row < w.rows) {
    const int c = 2 * k.pair;
    const uint8_t* p =
        bgr + k.row * kBgrPitch + ((lead + (uint32_t)k.row * lead_step) & 15u) + 3 * c;
    const float g0 = gsm::gray_level_half_even(gsm::u8_to_float(p[0]), gsm::u8_to_float(p[1]),
                                               gsm::u8_to_float(p[2]), weights);
    const float g1 = gsm::gray_level_half_even(gsm::u8_to_float(p[3]), gsm::u8_to_float(p[4]),
                                               gsm::u8_to_float(p[5]), weights);
    float* q = gray + k.row * kWindowCols + c;
    if (c + 1 < w.cols) {
      *reinterpret_cast<float2*>(q) = make_float2(g0, g1);
    } else {
      q[0] = g0;
    }
    k.row += k.step_rows, k.pair += k.step_pairs;
    if (k.pair >= k.pairs) k.pair -= k.pairs, ++k.row;
  }
}

// Both views, every frame: block (tile, view, group of frames).
__global__ void __launch_bounds__(kFrontThreads, kFrontBlocks)
front_end_kernel(View left, View right, int B, int Hs, int Ws, int Ho, int Wo, int tiles_x,
                 int frames_per_block) {
  __shared__ __align__(16) Staging st;
  // Field by field: selecting a whole parameter struct copies both to the stack.
  const bool r = blockIdx.y != 0;
  const View view = {r ? right.src : left.src, r ? right.map_x : left.map_x,
                     r ? right.map_y : left.map_y, r ? right.out : left.out};
  const int row0 = (blockIdx.x / tiles_x) * kTileRows;
  const int col0 = (blockIdx.x % tiles_x) * kTileCols;
  const int b0 = blockIdx.z * frames_per_block, b1 = min(B, b0 + frames_per_block);
  float mx[kTilePixels], my[kTilePixels];
  const Window win = tile_window(view, Hs, Ws, Ho, Wo, row0, col0, mx, my);

  const size_t n = (size_t)Ho * Wo, frame_bytes = (size_t)Hs * Ws * 3;
  // Pixel k's output is at out + (k >> 2) * Wo + 32 * (k & 3) a frame.
  const size_t first = (size_t)(row0 + tile_row(0)) * Wo + col0 + tile_col(0);
  const int rows_in = Ho - row0 - tile_row(0), cols_in = Wo - col0 - tile_col(0);
  Tap taps[kTilePixels];
  if (win.staged) {
#pragma unroll
    for (int k = 0; k < kTilePixels; ++k) taps[k] = staged_tap(mx[k], my[k], Hs, Ws, win);
    const Walk walk = walk_of(win);
    const uint32_t lead_step = (uint32_t)(3 * (size_t)Ws & 15);
    // Frames b0 and b0 + 1 in flight before the loop; once frame b is
    // converted, its stage takes frame b + 2, in flight while b interpolates
    // and b + 1 converts.
    for (int i = 0; i < kStages; ++i) {
      if (b0 + i < b1) {
        stage_window(st.bgr[i], view.src + (b0 + i) * frame_bytes, frame_bytes, Ws, win);
      }
      cp_async_commit();
    }
    for (int b = b0; b < b1; ++b) {
      const int s = (b - b0) % kStages;
      cp_async_wait_all_but_newest();  // frame b's rows are in
      __syncthreads();
      const uintptr_t window0 = reinterpret_cast<uintptr_t>(view.src + b * frame_bytes) +
                                ((size_t)win.y0 * Ws + win.x0) * 3;
      gray_window(st.gray, st.bgr[s], win, walk, (uint32_t)(window0 & 15), lead_step);
      __syncthreads();
      if (b + kStages < b1) {
        stage_window(st.bgr[s], view.src + (b + kStages) * frame_bytes, frame_bytes, Ws, win);
      }
      cp_async_commit();
      uint8_t* out = view.out + b * n + first;
#pragma unroll
      for (int k = 0; k < kTilePixels; ++k) {
        const Tap& t = taps[k];
        const float* g = st.gray + t.off;
        const uint32_t v = bilinear(t, g[0], g[1], g[kWindowCols], g[kWindowCols + 1]);
        if ((k >> 2) < rows_in && 32 * (k & 3) < cols_in) {
          out[(k >> 2) * (size_t)Wo + 32 * (k & 3)] = static_cast<uint8_t>(v);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTilePixels; ++k) taps[k] = tap_of(mx[k], my[k], Hs, Ws);
    for (int b = b0; b < b1; ++b) {
      const uint8_t* frame = view.src + b * frame_bytes;
      uint8_t* out = view.out + b * n + first;
#pragma unroll
      for (int k = 0; k < kTilePixels; ++k) {
        const Tap& t = taps[k];
        const uint32_t v = t.off >= 0 ? BgrSource::pixel(frame, t, Ws) : 0u;
        if ((k >> 2) < rows_in && 32 * (k & 3) < cols_in) {
          out[(k >> 2) * (size_t)Wo + 32 * (k & 3)] = static_cast<uint8_t>(v);
        }
      }
    }
  }
}

// The front end's rule alone: counts[0] += the tiles that take the staged
// path, counts[1] += those that gather.
__global__ void __launch_bounds__(kFrontThreads)
front_end_tiles_kernel(View left, View right, int Hs, int Ws, int Ho, int Wo, int tiles_x,
                       int* counts) {
  const bool r = blockIdx.y != 0;
  const View view = {nullptr, r ? right.map_x : left.map_x, r ? right.map_y : left.map_y,
                     nullptr};
  float mx[kTilePixels], my[kTilePixels];
  const Window win = tile_window(view, Hs, Ws, Ho, Wo, (blockIdx.x / tiles_x) * kTileRows,
                                 (blockIdx.x % tiles_x) * kTileCols, mx, my);
  if (threadIdx.x == 0) atomicAdd(counts + (win.staged ? 0 : 1), 1);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The vector body needs whole groups (n a multiple of kGroup, so that every
// frame's output starts aligned too), 16-byte aligned maps and a 4-byte
// aligned output.
bool vector_body(long long n, const View& view) {
  return n % kGroup == 0 && aligned(view.map_x, 4 * kGroup) && aligned(view.map_y, 4 * kGroup) &&
         aligned(view.out, kGroup);
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

dim3 grid_of(int Ho, int Wo) {
  const long long n = (long long)Ho * Wo;
  const long long per_block = (long long)kPixels * kThreads;
  return dim3((unsigned)((n + per_block - 1) / per_block));
}

// The front end's launch: grid (tiles of a view, 2 views, groups of frames),
// the tiles along a row, the frames of a group, and the occupancy it was
// sized by.
struct FrontEndGrid {
  dim3 grid;
  int tiles_x, frames_per_block, per_sm, sms;
};

// The frames split into groups only where the tiles of both views would
// not fill the card once; the SM count and the occupancy are queried once
// a device.
cudaError_t front_end_grid(int B, int Ho, int Wo, FrontEndGrid* g) {
  constexpr int kDevices = 64;
  static int per_sm_of[kDevices], sms_of[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kDevices && per_sm_of[device] > 0;
  int per_sm = cached ? per_sm_of[device] : 0, sms = cached ? sms_of[device] : 0;
  if (!cached) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, front_end_kernel, kFrontThreads,
                                                          0);
    }
    if (err != cudaSuccess) return err;
    if (device < kDevices) per_sm_of[device] = per_sm, sms_of[device] = sms;
  }
  g->tiles_x = (Wo + kTileCols - 1) / kTileCols;
  const long long tiles = (long long)g->tiles_x * ((Ho + kTileRows - 1) / kTileRows);
  const long long blocks = 2 * tiles, capacity = (long long)per_sm * sms;
  long long groups = std::min<long long>(B, std::max<long long>(1, (capacity + blocks - 1) / blocks));
  g->frames_per_block = (int)((B + groups - 1) / groups);
  groups = (B + g->frames_per_block - 1) / g->frames_per_block;
  g->grid = dim3((unsigned)tiles, 2, (unsigned)groups);
  g->per_sm = per_sm, g->sms = sms;
  return cudaSuccess;
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
  const bool vec = vector_body(n, view);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    remap_u8_kernel<true><<<grid_of(Ho, Wo), kThreads, 0, s>>>(view, B, Hs, Ws, n);
  } else {
    remap_u8_kernel<false><<<grid_of(Ho, Wo), kThreads, 0, s>>>(view, B, Hs, Ws, n);
  }
  if (body) *body = vec;
  return cudaGetLastError();
}

// The rig's front end: (B, Hs, Ws, 3) uint8 BGR batches of the left and the
// right view and each view's (Ho, Wo) float32 maps -> out (2, B, Ho, Wo)
// uint8, out[0] the left view's rectified gray, out[1] the right's; one
// launch on `stream`. Returns the CUDA error code (0 on success).
extern "C" int gsm_rectify_gray_pair(const void* left, const void* right, const void* left_x,
                                     const void* left_y, const void* right_x,
                                     const void* right_y, void* out, int B, int Hs, int Ws,
                                     int Ho, int Wo, void* stream) {
  if (bad_shape(B, Hs, Ws, Ho, Wo, 3)) return cudaErrorInvalidValue;
  FrontEndGrid g;
  const cudaError_t err = front_end_grid(B, Ho, Wo, &g);
  if (err != cudaSuccess) return err;
  auto* o = static_cast<uint8_t*>(out);
  const View views[2] = {
      {static_cast<const uint8_t*>(left), static_cast<const float*>(left_x),
       static_cast<const float*>(left_y), o},
      {static_cast<const uint8_t*>(right), static_cast<const float*>(right_x),
       static_cast<const float*>(right_y), o + (size_t)B * Ho * Wo},
  };
  front_end_kernel<<<g.grid, kFrontThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      views[0], views[1], B, Hs, Ws, Ho, Wo, g.tiles_x, g.frames_per_block);
  return cudaGetLastError();
}

// The front end's rule over the views' (Ho, Wo) float32 maps of (Hs, Ws)
// sources, on `stream`: counts[0] (device memory) gains the tiles of both
// views that take the staged path, counts[1] those that gather.
extern "C" int gsm_front_end_tiles(const void* left_x, const void* left_y, const void* right_x,
                                   const void* right_y, int Hs, int Ws, int Ho, int Wo,
                                   void* counts, void* stream) {
  if (bad_shape(1, Hs, Ws, Ho, Wo, 3)) return cudaErrorInvalidValue;
  FrontEndGrid g;
  const cudaError_t err = front_end_grid(1, Ho, Wo, &g);
  if (err != cudaSuccess) return err;
  const View left = {nullptr, static_cast<const float*>(left_x), static_cast<const float*>(left_y),
                     nullptr};
  const View right = {nullptr, static_cast<const float*>(right_x),
                      static_cast<const float*>(right_y), nullptr};
  front_end_tiles_kernel<<<dim3(g.grid.x, 2), kFrontThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      left, right, Hs, Ws, Ho, Wo, g.tiles_x, static_cast<int*>(counts));
  return cudaGetLastError();
}

// How gsm_remap_bilinear_u8 runs for these shapes, with aligned allocations
// (a map or output that is not aligned takes the scalar body): fields[0] the
// body (1 vector, 0 scalar), [1] the output pixels a thread owns, [2]
// threads a block, [3] blocks, [4] blocks an SM holds at once, [5] the SMs,
// [6] adjacent pixels a group.
extern "C" int gsm_remap_plan(int B, int Hs, int Ws, int Ho, int Wo, int* fields) {
  if (bad_shape(B, Hs, Ws, Ho, Wo, 1)) return cudaErrorInvalidValue;
  const bool vec = (long long)Ho * Wo % kGroup == 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = blocks_per_sm(&per_sm, vec ? remap_u8_kernel<true> : remap_u8_kernel<false>);
  }
  fields[0] = vec;
  fields[1] = kPixels;
  fields[2] = kThreads;
  fields[3] = (int)grid_of(Ho, Wo).x;
  fields[4] = per_sm;
  fields[5] = sms;
  fields[6] = kGroup;
  return err;
}

// How gsm_rectify_gray_pair runs for these shapes: fields[0] the body (0,
// the one), [1] the output pixels a thread owns, [2] threads a block, [3]
// blocks, [4] blocks an SM holds at once, [5] the SMs, [6] a tile's rows,
// [7] its columns, [8] the frames a block runs, [9] the staging budget's
// source rows, [10] its source columns, [11] the block's shared memory.
extern "C" int gsm_front_end_plan(int B, int Hs, int Ws, int Ho, int Wo, int* fields) {
  if (bad_shape(B, Hs, Ws, Ho, Wo, 3)) return cudaErrorInvalidValue;
  FrontEndGrid g;
  const cudaError_t err = front_end_grid(B, Ho, Wo, &g);
  cudaFuncAttributes attr = {};
  const cudaError_t err_attr = cudaFuncGetAttributes(&attr, front_end_kernel);
  fields[0] = 0;
  fields[1] = kTilePixels;
  fields[2] = kFrontThreads;
  fields[3] = (int)(g.grid.x * g.grid.y * g.grid.z);
  fields[4] = g.per_sm;
  fields[5] = g.sms;
  fields[6] = kTileRows;
  fields[7] = kTileCols;
  fields[8] = g.frames_per_block;
  fields[9] = kWindowRows;
  fields[10] = kWindowCols;
  fields[11] = (int)attr.sharedSizeBytes;
  return err != cudaSuccess ? err : err_attr;
}
