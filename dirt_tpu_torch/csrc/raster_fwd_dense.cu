// Dense whole-tile forward rasterizer for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/raster_fwd.py::_fwd_kernel (called by
// raster_forward): for every image tile, the tile's binned faces
// bins[t, 0 .. counts[t]) are scan-converted in ascending face id with a
// z-buffer: three edge planes >= 0, the depth plane strictly below the
// buffer and inside [-1, 1]; the winner's C attribute planes times the
// perspective reciprocal 1 / den give the pixel.
//
// Work decomposition. The TPU kernel keeps the whole face table resident in
// its fast memory and walks one tile per sequential grid step. Here one
// block takes an 8-row strip of one tile (a 128-column segment of it when
// the tile is wider), one thread per pixel, so a 256^2 image gives 64 blocks
// and a 1024^2 image 1024. The block stages the tile's list in batches: the
// ids first, then the 14 coefficients of each staged face that the coverage
// and depth test needs, by coalesced loads into shared memory; every thread
// then walks the same staged list, so each read in the loop is a
// shared-memory broadcast. The loop runs to counts[t] and never reads the
// sentinel slots behind it, so the result does not depend on the cap.
// Ascending order plus the strict z < zbuf test keeps the rule that a depth
// tie goes to the lower face id.
//
// The loop only remembers the winning face; the reciprocal and the attribute
// planes are evaluated once per pixel from the winner's row afterwards (the
// same expressions as the TPU kernel's loop body, raster_fwd.py:58-77, in
// the same order). Built with -fmad=false and IEEE division, so the kernel
// matches its plain PyTorch version.
//
// What bounds it: operations. Every pixel tests every face binned to its
// tile (~21 flops each); the bytes are small beside that: the table is read
// once per strip through the cache and the C + 2 output planes are written
// once.

#include <cuda_runtime.h>

namespace {

constexpr int STRIP_H = 8;
constexpr int SEG_W = 128;                    // widest segment per block
constexpr int NCOEF = 14;                     // geo columns 0..13
constexpr int COL_ATT = 17;
constexpr int STAGE = 64;                     // faces per smem stage
constexpr float BIG_Z = 3.0e38f;

__global__ void __launch_bounds__(STRIP_H * SEG_W)
raster_fwd_dense_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ bins, const int* __restrict__ counts, int cap,
    const float* __restrict__ bg, float* __restrict__ pix,
    int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp, int tile_h, int tile_w, int seg_w) {
  __shared__ int ids[STAGE];
  __shared__ float coef[STAGE * NCOEF];

  const int strips = tile_h / STRIP_H;
  const int segs = tile_w / seg_w;
  const int tiles_x = wp / tile_w;
  int b = blockIdx.x;                         // (t * strips + s) * segs + q
  const int q = b % segs;
  b /= segs;
  const int s = b % strips;
  const int t = b / strips;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;             // STRIP_H * seg_w
  const int r = tid / seg_w;
  const int c = tid - r * seg_w;
  const int x = (t % tiles_x) * tile_w + q * seg_w + c;
  const int y = (t / tiles_x) * tile_h + s * STRIP_H + r;
  const float xf = (float)x + 0.5f;
  const float yf = (float)y + 0.5f;

  const int count = counts[t];
  const int* list = bins + (long long)t * cap;

  float zb = BIG_Z;
  int best = -1;                              // winning face id
  for (int i0 = 0; i0 < count; i0 += STAGE) {
    const int n = min(STAGE, count - i0);
    __syncthreads();                          // previous stage consumed
    for (int k = tid; k < n; k += threads) ids[k] = list[i0 + k];
    __syncthreads();
    for (int k = tid; k < n * NCOEF; k += threads) {
      const int j = k / NCOEF;
      coef[k] = table[(long long)ids[j] * width + (k - j * NCOEF)];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* m = coef + j * NCOEF;
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
        best = ids[j];
      }
    }
  }

  const long long plane = (long long)hp * wp;
  const long long p = (long long)y * wp + x;
  zbuf[p] = zb;
  fid[p] = best;
  if (best >= 0) {
    const float* m = table + (long long)best * width;
    const float dx = xf - m[0];
    const float dy = yf - m[1];
    const float den = m[14] * dx + m[15] * dy + m[16];
    const float recip = 1.0f / den;
    for (int ch = 0; ch < channels; ++ch) {
      const float* a = m + COL_ATT + 3 * ch;
      pix[ch * plane + p] = (a[0] * dx + a[1] * dy + a[2]) * recip;
    }
  } else {
    for (int ch = 0; ch < channels; ++ch) {
      pix[ch * plane + p] = bg[ch * plane + p];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `table` is [rows, width] f32, `bins` [tiles, cap] int32 and
// `counts` [tiles] int32; tile_h is a multiple of 8 and tile_w at most 128
// or a multiple of 128 (the wrapper checks). The launch goes on `stream`
// and does not synchronise. Returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int dirt_raster_fwd_dense(
    const float* table, int width, const int* bins, const int* counts,
    int cap, const float* bg, float* pix, int* fid, float* zbuf,
    int channels, int hp, int wp, int tile_h, int tile_w, void* stream) {
  const int seg_w = tile_w < SEG_W ? tile_w : SEG_W;
  const int blocks = (hp / tile_h) * (wp / tile_w) * (tile_h / STRIP_H) *
                     (tile_w / seg_w);
  if (blocks > 0) {
    raster_fwd_dense_kernel<<<blocks, STRIP_H * seg_w, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        table, width, bins, counts, cap, bg, pix, fid, zbuf, channels, hp,
        wp, tile_h, tile_w, seg_w);
  }
  return static_cast<int>(cudaGetLastError());
}
