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
// Design: Huang's running histogram with CTMF's two tiers (16 coarse bins
// over 256 fine bins, as the reference's ctmf.c keeps them). One thread
// owns one output column and walks a run of rows downward: per row it adds
// the window's new bottom row and removes its old top row (2(2r + 1) pixels)
// and selects the median by scanning the coarse bins and then the 16 fine
// bins of one coarse bin. The TPU kernel builds dense one-hot histograms
// because its vector unit cannot branch per pixel; a thread can, so each
// update touches one fine and one coarse bin. CTMF proper slides column
// histograms along the row for O(1) work per pixel, but that slide is
// sequential in x; here every column runs in parallel and the work is O(r)
// per pixel, 14 updates at the post-filter's r = 3.
// The histograms live in shared memory as [bin][thread] uint16 counts, so
// a warp's updates land in distinct words whatever bins they touch (two
// threads share a bank). A count is at most (2r + 1)^2, so the entry takes
// r <= 127 (65025 at r = 127); the JAX kernel's contract stops at r = 60.
// What bounds it: shared-memory read-modify-writes, issued one after the
// other; the image is read about 2(2r + 1) times per pixel through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) median_kernel(
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

}  // namespace

// (B, H, W) uint8 -> (B, H, W) uint8 clipped-window median of radius r, on
// `stream`. `valid` is a (H, W) uint8 mask shared by the B frames (nonzero =
// the pixel exists), or null for all pixels. Returns the CUDA error code
// (0 on success).
extern "C" int gsm_median_u8(const void* img, const void* valid, void* out,
                             int B, int H, int W, int r, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || r < 1 || (2 * r + 1) * (2 * r + 1) > 65535)
    return cudaErrorInvalidValue;
  // Rows per block: enough that the first window's (2r + 1)^2 adds and the
  // 272 bins' zeroing are spread over many outputs, few enough to give the
  // card many blocks.
  int rows = 4 * (2 * r + 1);
  rows = rows < 16 ? 16 : (rows > 64 ? 64 : rows);
  dim3 grid((W + kThreads - 1) / kThreads, (H + rows - 1) / rows, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  median_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(out), H, W, r, rows);
  return cudaGetLastError();
}
