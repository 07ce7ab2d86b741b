// The whole-tile strip walk shared by the forward kernels that scan a tile's
// face list (raster_fwd_dense.cu, raster_fwd_csr.cu): the two differ only in
// where a tile's list lies.
//
// One block takes an 8-row strip of one tile (a 128-column segment of it
// when the tile is wider), one thread per pixel. The block stages the list
// in batches: the ids first, then the 14 coefficients of each staged face
// that the coverage and depth test needs, by coalesced loads into shared
// memory; every thread then walks the same staged list, so each read in the
// loop is a shared-memory broadcast. The loop runs to `count` and never reads
// the slots behind it. Ascending order plus the strict z < zbuf test keeps
// the rule that a depth tie goes to the lower face id.
//
// The loop only remembers the winning face; the reciprocal and the attribute
// planes are evaluated once per pixel from the winner's row afterwards (the
// same expressions as the TPU kernels' loop body, raster_fwd.py:58-77, in
// the same order). Built with -fmad=false and IEEE division, so a kernel
// matches its plain PyTorch version.

#pragma once

#include <cuda_runtime.h>

namespace dirt {

constexpr int STRIP_H = 8;
constexpr int SEG_W = 128;                    // widest segment per block
constexpr int NCOEF = 14;                     // geo columns 0..13
constexpr int COL_ATT = 17;
constexpr int STAGE = 64;                     // faces per smem stage
constexpr float BIG_Z = 3.0e38f;

// Threads of a block: STRIP_H rows of a segment.
__host__ __device__ inline int segment_width(int tile_w) {
  return tile_w < SEG_W ? tile_w : SEG_W;
}

// Blocks of a launch: one per (tile, strip, segment).
inline int strip_blocks(int hp, int wp, int tile_h, int tile_w) {
  return (hp / tile_h) * (wp / tile_w) * (tile_h / STRIP_H) *
         (tile_w / segment_width(tile_w));
}

// The tile of block `b` = (t * strips + s) * segs + q.
__device__ __forceinline__ int strip_tile(int b, int tile_h, int tile_w) {
  return b / ((tile_h / STRIP_H) * (tile_w / segment_width(tile_w)));
}

// Scan-convert list[0 .. count) over the block's strip of tile `t` and write
// the strip's pixels, face ids and depths. Every thread of the block calls
// it with the same list and count (it synchronises the block).
//   table: [rows, width] f32 face table (17 geometry columns, then 3 per
//          channel); bg, pix: [channels, hp, wp]; fid, zbuf: [hp, wp].
__device__ __forceinline__ void raster_strip(
    const float* __restrict__ table, int width, const int* __restrict__ list,
    int count, const float* __restrict__ bg, float* __restrict__ pix,
    int* __restrict__ fid, float* __restrict__ zbuf, int channels, int hp,
    int wp, int tile_h, int tile_w) {
  __shared__ int ids[STAGE];
  __shared__ float coef[STAGE * NCOEF];

  const int seg_w = segment_width(tile_w);
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

}  // namespace dirt
