// Clipped-window median of uint8 images for Hopper (sm_90a).
//
// Replaces the TPU kernel gpu_stereo_matching_tpu/kernels/ctmf_median.py::
// ctmf_median_u8 (body _ctmf_kernel).
//
// out(y, x) = the (n/2 + 1)-th smallest valid pixel of the clipped
// (2r + 1)^2 window at (y, x), where n is the number of valid pixels in it.
// Pixels outside the image, and pixels whose mask byte is 0, are not in the
// window. A window with n = 0 gives 255, as every JAX path does (the sort
// path's sentinel cast to uint8, the histogram paths' cdf < 1 at all levels).
// Integer arithmetic only.
//
// Two bodies; gsm_median_u8 picks one from r alone.
//
// Rank select (r = 1..kSmallRadius). A block stages a tile of kTileRows x
// 128 output pixels and its r-wide halo in shared memory once, with 16-byte
// loads; a pixel outside the image or the mask is staged as 255, which is
// never below any candidate, so clipped and masked windows need no special
// case. A thread owns 4 adjacent outputs, the 4 byte lanes of one word, in
// kRowsPerThread rows; the window word at column offset dx is a
// __byte_perm of two aligned staged words. The median comes in 8 passes
// from the top bit: every lane tries cand = med | bit, counts the window
// bytes below cand (byte-wise, 3 instructions a window word: an add, a
// LOP3 and a shifted add), and keeps the bit where the count is below the
// rank n/2 + 1 (n from the clipped extents, or a box count of the staged
// mask). An empty window has rank 1 and count 0 at every pass: 255. After
// staging there are no shared-memory writes and no data-dependent branch.
// What bounds it: instruction issue. A pass costs 3 instructions a window
// word and row for the counts, and a __byte_perm and two masks a staged
// word that the thread's rows share: 8 x 3 x (2r + 1)^2 / 4 instructions a
// pixel and the extraction (bench/fused_kernel.py --median counts the
// select loop in the SASS). r <= 7 keeps a count below 256, a byte.
//
// Histogram (every other r up to 127): Huang's running histogram with
// CTMF's two tiers (16 coarse bins over 256 fine bins, as the reference's
// ctmf.c keeps them). One thread owns one output column and walks a run of
// rows downward: per row it adds the window's new bottom row and removes
// its old top row (2(2r + 1) pixels) and selects the median by scanning the
// coarse bins and then the 16 fine bins of one coarse bin. The histograms
// live in shared memory as [bin][thread] uint16 counts, so a warp's updates
// land in distinct words whatever bins they touch (two threads share a
// bank). A count is at most (2r + 1)^2, so the entry takes r <= 127 (65025
// at r = 127); the JAX kernel's contract stops at r = 60. What bounds it:
// shared-memory read-modify-writes, issued one after the other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- Rank-select body -----------------------------------------------------

constexpr int kSmallRadius = 7;    // the largest r of the rank-select body
constexpr int kRowsPerThread = 4;  // output rows a thread selects at once
constexpr int kWarps = 8;          // warps a block; one warp spans the tile's width
constexpr int kTileRows = kWarps * kRowsPerThread;
constexpr int kTileCols = 128;
constexpr int kSelectThreads = 32 * kWarps;
constexpr int kHalo = 16;  // staged columns start 16 left of the tile: 16-byte chunks
constexpr int kStageWords = (kTileCols + 2 * kHalo) / 4;  // 40 words a staged row
constexpr int kChunks = kStageWords / 4;                  // 10 chunks of 16 bytes

constexpr uint32_t kLow7 = 0x7F7F7F7Fu;
constexpr uint32_t kTop = 0x80808080u;
constexpr uint32_t kOnes = 0x01010101u;

// Bit 7 of each byte of the result is (a < c) for that byte, unsigned; the
// other bits are 0. With d = (a & 0x7F) + 0x80 - (c & 0x7F) per byte (no
// carry between bytes), bit 7 of d is (a_lo >= c_lo); where the top bits of
// a and c differ c's decides, else d's. `k` and `ch` depend on c alone.
struct Cand {
  uint32_t k, ch;
};

__device__ __forceinline__ Cand candidate(uint32_t c) {
  return {kTop - (c & kLow7), c & kTop};
}

__device__ __forceinline__ uint32_t below(uint32_t a, Cand c) {
  const uint32_t hi = a | kLow7;  // a's top bit, and ones where c.ch has zeros
  const uint32_t d = (a & kLow7) + c.k;
  // (~(hi ^ ch) & ~d) | (~hi & ch) as one LOP3 of hi, ch and d, written out:
  // left to itself the compiler folds a | 0x7F7F7F7F into two LOP3s per
  // candidate.
  uint32_t f;
  asm("lop3.b32 %0, %1, %2, %3, 0x4D;" : "=r"(f) : "r"(hi), "r"(c.ch), "r"(d));
  return f;
}

// Nonzero bytes of m -> 1, zero bytes -> 0.
__device__ __forceinline__ uint32_t nonzero01(uint32_t m) {
  return (((m & kLow7) + kLow7) | m) >> 7 & kOnes;
}

template <int R>
__global__ void __launch_bounds__(kSelectThreads) rank_select_kernel(
    const uint8_t* __restrict__ img, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ out, int H, int W, int vec) {
  constexpr int kRows = kTileRows + 2 * R;  // staged rows
  constexpr int kSpan = kRowsPerThread + 2 * R;  // staged rows a thread reads
  constexpr int kWL = (R + 3) / 4;  // aligned words each side of the thread's own
  constexpr int kWords = 2 * kWL + 1;
  extern __shared__ uint4 stage4[];
  uint32_t* pix = reinterpret_cast<uint32_t*>(stage4);  // [kRows][kStageWords]
  uint32_t* ok = pix + kRows * kStageWords;             // the same, 0/1 validity (masked only)
  const int x0 = blockIdx.x * kTileCols, y0 = blockIdx.y * kTileRows;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* im = img + frame;

  for (int i = threadIdx.x; i < kRows * kChunks; i += kSelectThreads) {
    const int s = i / kChunks, q = i % kChunks;
    const int yy = y0 - R + s, xs = x0 - kHalo + 16 * q;
    uint4 p, m = {kOnes, kOnes, kOnes, kOnes};
    if (vec && yy >= 0 && yy < H && xs >= 0 && xs + 16 <= W) {
      const size_t at = (size_t)yy * W + xs;
      p = *reinterpret_cast<const uint4*>(im + at);
      if (valid) {
        const uint4 v = *reinterpret_cast<const uint4*>(valid + at);
        m = {nonzero01(v.x), nonzero01(v.y), nonzero01(v.z), nonzero01(v.w)};
        p.x |= ~(m.x * 0xFFu);  // invalid pixels -> 255
        p.y |= ~(m.y * 0xFFu);
        p.z |= ~(m.z * 0xFFu);
        p.w |= ~(m.w * 0xFFu);
      }
    } else {
      uint32_t pw[4] = {0, 0, 0, 0}, mw[4] = {0, 0, 0, 0};
      for (int b = 0; b < 16; ++b) {
        const int xx = xs + b;
        const size_t at = (size_t)yy * W + xx;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W && (!valid || valid[at]);
        pw[b >> 2] |= (in ? im[at] : 255u) << (8 * (b & 3));
        mw[b >> 2] |= (in ? 1u : 0u) << (8 * (b & 3));
      }
      p = {pw[0], pw[1], pw[2], pw[3]};
      m = {mw[0], mw[1], mw[2], mw[3]};
    }
    reinterpret_cast<uint4*>(pix)[s * kChunks + q] = p;
    if (valid) reinterpret_cast<uint4*>(ok)[s * kChunks + q] = m;
  }
  __syncthreads();

  const int t = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRowsPerThread;  // the first staged row it reads
  const int ya = y0 + row0;
  if (ya >= H) return;
  const int xa = x0 + 4 * t;
  // The words of staged row s that hold the thread's windows: w[kWL] is the
  // thread's own word (columns xa..xa+3).
  auto words = [&](const uint32_t* tile, int s, uint32_t (&w)[kWords]) {
    const uint32_t* at = tile + s * kStageWords + t + kHalo / 4 - kWL;
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = at[i];
  };
  // The window word at column offset dx (the bytes of columns xa+dx..xa+dx+3).
  auto window = [&](const uint32_t (&w)[kWords], int dx) -> uint32_t {
    const int o = 4 * kWL + dx, i = o >> 2, sh = o & 3;
    return sh ? __byte_perm(w[i], w[i + 1], 0x3210 + 0x1111 * sh) : w[i];
  };

  // The rank of each output, n / 2 + 1, a byte a lane (n <= 225).
  Cand rank[kRowsPerThread];
  if (valid) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      uint32_t v[kWords] = {};  // column sums of the 2r + 1 rows, <= 15 a byte
#pragma unroll
      for (int s = j; s <= j + 2 * R; ++s) {
        uint32_t w[kWords];
        words(ok, row0 + s, w);
#pragma unroll
        for (int i = 0; i < kWords; ++i) v[i] += w[i];
      }
      uint32_t n = 0;
#pragma unroll
      for (int dx = -R; dx <= R; ++dx) n += window(v, dx);
      rank[j] = candidate(((n >> 1) & kLow7) + kOnes);
    }
  } else {
    uint32_t nx = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = xa + i;
      nx |= (uint32_t)max(min(x + R, W - 1) - max(x - R, 0) + 1, 0) << (8 * i);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int y = ya + j;
      const uint32_t ny = min(y + R, H - 1) - max(y - R, 0) + 1;
      uint32_t rk = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t n = ny * (nx >> (8 * i) & 0xFFu);
        rk |= (n / 2 + 1) << (8 * i);
      }
      rank[j] = candidate(rk);
    }
  }

  uint32_t med[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) med[j] = 0;
#pragma unroll 1
  for (int b = 7; b >= 0; --b) {
    const uint32_t bit = kOnes << b;
    Cand cand[kRowsPerThread];
    uint32_t cnt[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      cand[j] = candidate(med[j] | bit);
      cnt[j] = 0;
    }
#pragma unroll
    for (int s = 0; s < kSpan; ++s) {
      uint32_t w[kWords];
      words(pix, row0 + s, w);
#pragma unroll
      for (int dx = -R; dx <= R; ++dx) {
        const uint32_t a = window(w, dx);
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          if (s >= j && s <= j + 2 * R) cnt[j] += below(a, cand[j]) >> 7;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      // Lanes whose count is below the rank take the bit.
      med[j] |= bit & ((below(cnt[j], rank[j]) >> 7) * 0xFFu);
    }
  }

  uint8_t* o = out + frame;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int y = ya + j;
    if (y >= H) break;
    uint8_t* row = o + (size_t)y * W;
    if (vec && xa + 4 <= W) {
      *reinterpret_cast<uint32_t*>(row + xa) = med[j];
    } else {
      for (int i = 0; i < 4 && xa + i < W; ++i) row[xa + i] = (uint8_t)(med[j] >> (8 * i));
    }
  }
}

using SelectKernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, int, int, int);

// The rank-select instance of radius r (1..kSmallRadius).
SelectKernel rank_select_instance(int r) {
  switch (r) {
    case 1: return rank_select_kernel<1>;
    case 2: return rank_select_kernel<2>;
    case 3: return rank_select_kernel<3>;
    case 4: return rank_select_kernel<4>;
    case 5: return rank_select_kernel<5>;
    case 6: return rank_select_kernel<6>;
    case 7: return rank_select_kernel<7>;
  }
  return nullptr;
}

// Its shared memory: the staged pixels, and the staged validity if masked.
size_t stage_bytes(int r, bool masked) {
  return (size_t)(kTileRows + 2 * r) * kStageWords * 4 * (masked ? 2 : 1);
}

// ---- Histogram body ---------------------------------------------------------

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const uint8_t* __restrict__ img, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ out, int H, int W, int r, int rows_per_block) {
  __shared__ uint16_t fine[256 * kThreads];
  __shared__ uint16_t coarse[16 * kThreads];
  const int t = threadIdx.x;
  const int x = blockIdx.x * kThreads + t;
  if (x >= W) return;  // no barrier below: each thread is on its own
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* im = img + frame;
  uint8_t* o = out + frame;
  uint16_t* f = fine + t;
  uint16_t* cs = coarse + t;
  for (int b = 0; b < 256; ++b) f[b * kThreads] = 0;
  for (int b = 0; b < 16; ++b) cs[b * kThreads] = 0;

  const int xa = max(x - r, 0), xb = min(x + r, W - 1);
  int n = 0;
  // Add (delta = 1) or remove (delta = -1) the window's part of row yy.
  auto update = [&](int yy, int delta) {
    const uint8_t* row = im + (size_t)yy * W;
    const uint8_t* vrow = valid ? valid + (size_t)yy * W : nullptr;
    for (int xx = xa; xx <= xb; ++xx) {
      if (vrow && !vrow[xx]) continue;
      const int v = row[xx];
      f[v * kThreads] += delta;
      cs[(v >> 4) * kThreads] += delta;
      n += delta;
    }
  };

  const int y_begin = blockIdx.y * rows_per_block;
  const int y_end = min(y_begin + rows_per_block, H);
  // The window of row y_begin, less its bottom row y_begin + r.
  for (int yy = max(y_begin - r, 0); yy < min(y_begin + r, H); ++yy) update(yy, 1);
  for (int y = y_begin; y < y_end; ++y) {
    if (y + r < H) update(y + r, 1);
    const int rank = n / 2 + 1;
    int acc = 0;
    int med = 255;
    for (int cb = 0; cb < 16; ++cb) {
      const int cc = cs[cb * kThreads];
      if (acc + cc >= rank) {
        for (int v = cb * 16; v < cb * 16 + 16; ++v) {
          acc += f[v * kThreads];
          if (acc >= rank) {
            med = v;
            break;
          }
        }
        break;
      }
      acc += cc;
    }
    o[(size_t)y * W + x] = (uint8_t)med;
    if (y - r >= 0) update(y - r, -1);
  }
}

// Rows per histogram block: enough that the first window's (2r + 1)^2 adds
// and the 272 bins' zeroing are spread over many outputs, few enough to
// give the card many blocks.
int histogram_rows(int r) {
  const int rows = 4 * (2 * r + 1);
  return rows < 16 ? 16 : (rows > 64 ? 64 : rows);
}

bool rank_select(int r) { return r >= 1 && r <= kSmallRadius; }

bool bad_shape(int B, int H, int W, int r) {
  return B < 1 || B > 65535 || H < 1 || W < 1 || r < 1 || (2 * r + 1) * (2 * r + 1) > 65535;
}

dim3 grid_of(int B, int H, int W, int r) {
  if (rank_select(r))
    return dim3((W + kTileCols - 1) / kTileCols, (H + kTileRows - 1) / kTileRows, B);
  const int rows = histogram_rows(r);
  return dim3((W + kThreads - 1) / kThreads, (H + rows - 1) / rows, B);
}

}  // namespace

// Which body radius r takes: 1 for rank select, 0 for the histogram.
extern "C" int gsm_median_body(int r) { return rank_select(r) ? 1 : 0; }

// (B, H, W) uint8 -> (B, H, W) uint8 clipped-window median of radius r, on
// `stream`. `valid` is a (H, W) uint8 mask shared by the B frames (nonzero =
// the pixel exists), or null for all pixels. Returns the CUDA error code
// (0 on success).
extern "C" int gsm_median_u8(const void* img, const void* valid, void* out,
                             int B, int H, int W, int r, void* stream) {
  if (bad_shape(B, H, W, r)) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, H, W, r);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const uint8_t*>(img);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint8_t*>(out);
  if (rank_select(r)) {
    // 16-byte loads and 4-byte stores where every row starts aligned.
    const int vec = ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(valid) |
                      reinterpret_cast<uintptr_t>(out) | (uintptr_t)W) & 15) == 0;
    const SelectKernel kernel = rank_select_instance(r);
    kernel<<<grid, kSelectThreads, stage_bytes(r, valid != nullptr), s>>>(im, va, o, H, W, vec);
    return cudaGetLastError();
  }
  histogram_kernel<<<grid, kThreads, 0, s>>>(im, va, o, H, W, r, histogram_rows(r));
  return cudaGetLastError();
}

// How gsm_median_u8 launches for (B, H, W) at radius r, unmasked, on the
// current device: fields = {body, tile rows, tile columns, threads a block,
// blocks, blocks an SM holds at once, SMs}.
extern "C" int gsm_median_plan(int B, int H, int W, int r, int* fields) {
  if (bad_shape(B, H, W, r)) return cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, H, W, r);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (rank_select(r)) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rank_select_instance(r),
                                                        kSelectThreads, stage_bytes(r, false));
    fields[1] = kTileRows;
    fields[2] = kTileCols;
    fields[3] = kSelectThreads;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel, kThreads, 0);
    fields[1] = histogram_rows(r);
    fields[2] = kThreads;
    fields[3] = kThreads;
  }
  fields[0] = rank_select(r) ? 1 : 0;
  fields[4] = (int)(grid.x * grid.y * grid.z);
  fields[5] = per_sm;
  fields[6] = sms;
  return err;
}
