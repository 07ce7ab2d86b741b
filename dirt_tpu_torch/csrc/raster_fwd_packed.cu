// Packed-engine forward rasterizer for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package on the forward path:
//   * dirt_tpu/ops/raster_fwd.py::_fwd_packed_kernel (the packed forward),
//   * dirt_tpu/ops/raster_fwd.py::flat_subtile_swap_pallas, which the TPU
//     path runs on the background going in and on the three outputs coming
//     out. This kernel reads the background and writes pixels, face ids and
//     depth in image layout, so both swaps disappear: it computes
//     flat_subtile_swap o _fwd_packed_kernel o flat_subtile_swap.
//
// Work decomposition. One thread block per (tile, strip): 8 rows x 128
// columns, one thread per pixel. Pixel (r, c) belongs to lane group
// g = c / 16. The block walks its strip's contiguous run of iterations
// [iter_off, iter_off + strip_iters), clamped to the tile's n_iters, in
// ascending order; iteration i's job for group g is budget row
// (start_block * PACK_ITERS + i) * GROUPS + g of the pre-gathered face rows.
// Ascending order plus the strict z < zbuf test keeps the rule that a depth
// tie goes to the lower face id.
//
// The loop only runs the coverage and depth test and remembers the winning
// row; the perspective reciprocal and the C attribute planes are evaluated
// once per pixel, from the winning row, after the loop. The expressions are
// the TPU kernel's (raster_fwd.py:482-503) with the same operation order;
// built with -fmad=false (no multiply-add contraction) and IEEE division,
// so the kernel matches its plain PyTorch version bit for bit.
//
// What bounds it: the per-pixel iteration count (~20 per strip on the
// 10k-face sphere at 1024^2) times ~20 flops, plus writing the (C + 2)
// output planes once. The 17 coefficients each iteration needs are staged
// in shared memory for STAGE iterations at a time by the whole block with
// coalesced loads, so a face row is read from device memory once per
// strip; every other read is a shared-memory broadcast.

#include <cuda_runtime.h>

namespace {

constexpr int SUB_H = 8;
constexpr int SUB_W = 16;
constexpr int GROUPS = 8;
constexpr int TILE_W = GROUPS * SUB_W;        // 128
constexpr int PACK_ITERS = 64;
constexpr int THREADS = SUB_H * TILE_W;       // 1024
constexpr int NCOEF = 17;                     // geo columns 0..16
constexpr int COL_ID = 17;
constexpr int COL_ATT = 19;
constexpr int STAGE = 32;                     // iterations per smem stage
constexpr float BIG_Z = 3.0e38f;

__global__ void __launch_bounds__(THREADS)
raster_fwd_packed_kernel(
    const float* __restrict__ rows, int width,
    const int* __restrict__ start_block, const int* __restrict__ n_iters,
    const int* __restrict__ iter_off, const int* __restrict__ strip_iters,
    const float* __restrict__ bg, float* __restrict__ pix,
    int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp, int tile_h, int tiles_x) {
  __shared__ float coef[STAGE * GROUPS * NCOEF];

  const int strips = tile_h / SUB_H;
  const int ts = blockIdx.x;                  // t * strips + s
  const int t = ts / strips;
  const int s = ts - t * strips;
  const int tid = threadIdx.x;
  const int r = tid / TILE_W;
  const int c = tid - r * TILE_W;
  const int g = c / SUB_W;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int x = tx * TILE_W + c;
  const int y = ty * tile_h + s * SUB_H + r;
  const float xf = (float)x + 0.5f;
  const float yf = (float)y + 0.5f;

  const int lo = iter_off[ts];
  const int hi = min(lo + strip_iters[ts], n_iters[t]);
  const long long row0 = (long long)start_block[t] * PACK_ITERS;

  float zb = BIG_Z;
  long long best = -1;                        // winning budget row
  for (int i0 = lo; i0 < hi; i0 += STAGE) {
    const int n = min(STAGE, hi - i0);
    __syncthreads();                          // previous stage consumed
    const float* src = rows + (row0 + i0) * GROUPS * (long long)width;
    for (int k = tid; k < n * GROUPS * NCOEF; k += THREADS) {
      const int j = k / NCOEF;
      coef[k] = src[(long long)j * width + (k - j * NCOEF)];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* m = coef + (j * GROUPS + g) * NCOEF;
      const float dx = xf - m[0];
      const float dy = yf - m[1];
      const float e0 = m[2] * dx + m[3] * dy + m[4];
      const float e1 = m[5] * dx + m[6] * dy + m[7];
      const float e2 = m[8] * dx + m[9] * dy + m[10];
      const float zv = m[11] * dx + m[12] * dy + m[13];
      // min(e0, e1, e2) >= 0, NaN-safe like jnp.minimum: any NaN fails.
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zv < zb &&
          zv >= -1.0f && zv <= 1.0f) {
        zb = zv;
        best = (row0 + i0 + j) * GROUPS + g;
      }
    }
  }

  const long long plane = (long long)hp * wp;
  const long long p = (long long)y * wp + x;
  zbuf[p] = zb;
  if (best >= 0) {
    const float* m = rows + best * width;
    const float dx = xf - m[0];
    const float dy = yf - m[1];
    const float den = m[14] * dx + m[15] * dy + m[16];
    const float recip = 1.0f / den;
    fid[p] = (int)m[COL_ID];
    for (int ch = 0; ch < channels; ++ch) {
      const float* a = m + COL_ATT + 3 * ch;
      pix[ch * plane + p] = (a[0] * dx + a[1] * dy + a[2]) * recip;
    }
  } else {
    fid[p] = -1;
    for (int ch = 0; ch < channels; ++ch) {
      pix[ch * plane + p] = bg[ch * plane + p];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; the launch goes on `stream` and does not synchronise. Returns
// the cudaGetLastError() code of the launch (0 on success).
extern "C" int dirt_raster_fwd_packed(
    const float* rows, int width,
    const int* start_block, const int* n_iters,
    const int* iter_off, const int* strip_iters,
    const float* bg, float* pix, int* fid, float* zbuf,
    int channels, int hp, int wp, int tile_h, void* stream) {
  const int tiles_x = wp / TILE_W;
  const int blocks = (hp / tile_h) * tiles_x * (tile_h / SUB_H);
  if (blocks > 0) {
    raster_fwd_packed_kernel<<<blocks, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        rows, width, start_block, n_iters, iter_off, strip_iters, bg, pix,
        fid, zbuf, channels, hp, wp, tile_h, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
