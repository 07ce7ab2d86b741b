// The two passes of the fused dense backward (fused_bwd.cu over [T, cap]
// bins), which evaluate the cotangent core per pixel and sum the per-pixel
// rows onto faces without atomics, and the shared-memory form of a list
// entry's row that the fused CSR backward (fused_bwd_csr.cu) runs for a
// channel count it has no register instance for. A row is [9 edge | 3 den |
// 3C attribute] floats; a face's row sums the pixels the face owns. (The
// face scatters, and the CSR backward's own passes, are in
// scatter_rows.cuh.)
//
//   pass 1 (warp_partial_row): one warp per listed (tile, face) entry. The
//           warp scans the entry's scan box (scatter_rows.cuh's
//           tile_scan_box: the face's cull box, the forward's
//           raster_tile.cuh::cull_box, clipped to the tile; every pixel a
//           face can own lies inside it), 32 consecutive pixels of a row at
//           a time; a lane whose pixel the face owns calls the per-pixel
//           body, which adds the pixel's 12 + 3C values to the lane's own
//           accumulators in shared memory, in scan order. The body is a
//           template argument: fused_partial_row evaluates
//           cotangent_core.cuh. A fixed xor butterfly then sums the 32
//           lanes, and the warp writes the entry's partial row. A pixel's
//           owner is always in its tile's list, since the forward draws
//           only listed faces, and a face is listed at most once per tile,
//           so every covered pixel is summed exactly once.
//   pass 2 (reduce_face_column): one thread per (face, column) walks the
//           tiles the face's binning box touches in ascending order, finds
//           the face's slot in each tile's ascending list by binary search,
//           and sums the partial rows. A face is listed only in the tiles of
//           its binning box; a face that a cap cut from a tile's list is not
//           found there, and owns no pixel there.
// Both orders are fixed, so two runs give equal bits. Built with
// -fmad=false and IEEE division.

#pragma once

#include <cuda_runtime.h>

#include "cotangent_core.cuh"
#include "scatter_rows.cuh"

namespace dirt {

constexpr int ROW_WARPS = 4;                  // list entries per block
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Dynamic shared memory of a pass-1 block: [ROW_WARPS][k_cols][32] floats.
inline int partial_smem_bytes(int k_cols) {
  return ROW_WARPS * k_cols * 32 * (int)sizeof(float);
}

// What a per-pixel body is handed to add its values with: put(k, v) adds v
// to column k of the lane's accumulators ([k_cols][32] floats per warp).
struct LaneAdd {
  float* acc;
  int lane;
  __device__ __forceinline__ void operator()(int k, float v) const {
    acc[k * 32 + lane] = acc[k * 32 + lane] + v;
  }
};

// Pass 1 for one warp: the partial row of `face` over the scan box `box`
// (x0, y0, width, pixel count), written to dst[0 .. k_cols). `acc` is the
// warp's [k_cols][32] shared accumulator. body(x, y, p, put) is called for
// every pixel (x, y), flat index p, that `face` owns, in scan order, and
// calls put(k, value) for its columns.
template <class Body>
__device__ __forceinline__ void warp_partial_row(
    int face, const int4& box, const int* __restrict__ fid,
    float* __restrict__ dst, float* acc, int lane, int k_cols, int wp,
    Body body) {
  for (int k = 0; k < k_cols; ++k) acc[k * 32 + lane] = 0.0f;
  const LaneAdd put{acc, lane};
  for (int idx = lane; idx < box.w; idx += 32) {
    const int yy = idx / box.z;
    const int x = box.x + (idx - yy * box.z);
    const int y = box.y + yy;
    const long long p = (long long)y * wp + x;
    if (fid[p] != face) continue;
    body(x, y, p, put);
  }
  __syncwarp();
  for (int k = 0; k < k_cols; ++k) {
    float v = acc[k * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = v + __shfl_xor_sync(FULL_MASK, v, off);
    }
    if (lane == 0) dst[k] = v;
  }
}

// Pass 1 of the fused backwards: the body evaluates the cotangent core from
// the owner's 17 geometry columns `m`.
__device__ __forceinline__ void fused_partial_row(
    const float* __restrict__ m_row, int face, const int4& box,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, float* __restrict__ dst, float* acc,
    int lane, int channels, int hp, int wp) {
  float m[17];
#pragma unroll
  for (int k = 0; k < 17; ++k) m[k] = m_row[k];
  const long long plane = (long long)hp * wp;
  warp_partial_row(
      face, box, fid, dst, acc, lane, 12 + 3 * channels, wp,
      [&](int x, int y, long long p, LaneAdd put) {
        const float dx = ((float)x + 0.5f) - m[0];
        const float dy = ((float)y + 0.5f) - m[1];
        pixel_cotangents(m, dx, dy, channels, grad, pix, plane, p, bits[p],
                         sval, put);
      });
}

// Pass 2 for one thread: column `k` of `face`, summed over the tiles of the
// face's binning box in ascending tile order. lists(t, &list, &n) gives
// tile t's ascending face list and its length, and returns the row of
// `partial` that holds the list's first entry.
template <class Lists>
__device__ __forceinline__ float reduce_face_column(
    Lists lists, const int* __restrict__ bbox,
    const float* __restrict__ partial, int face, int k, int k_cols,
    int tiles_x, int tile_h, int tile_w) {
  // The box binning used (clipped to the image; empty when max < min).
  const int* bb = bbox + 4 * (long long)face;
  const int tx0 = bb[0] / tile_w;
  const int tx1 = bb[1] < bb[0] ? -1 : bb[1] / tile_w;
  const int ty0 = bb[2] / tile_h;
  const int ty1 = bb[3] < bb[2] ? -1 : bb[3] / tile_h;
  float sum = 0.0f;
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) {
      const int* list;
      int n;
      const long long row0 = lists(ty * tiles_x + tx, &list, &n);
      int lo = 0, hi = n;
      while (lo < hi) {                       // first slot with id >= face
        const int mid = (lo + hi) >> 1;
        if (list[mid] < face) lo = mid + 1; else hi = mid;
      }
      if (lo < n && list[lo] == face) {
        sum = sum + partial[(row0 + lo) * k_cols + k];
      }
    }
  }
  return sum;
}

}  // namespace dirt
