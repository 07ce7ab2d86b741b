// Fused dense backward for Hopper (sm_90a): per-face cotangent rows.
//
// Replaces dirt_tpu/ops/fused_bwd.py::_fused_kernel (called by
// fused_backward_rows). For every face it sums
// raster_bwd.pixel_cotangents_core over the pixels the face owns
// (fid == face), into out[face] = [9 edge | 3 den | 3C attribute] floats.
//
// What the TPU kernel does that this one does not. The TPU kernel gathers
// each pixel's owning geometry row, and scatters the cotangents back, through
// one-hot matrix products against a pre-gathered [T * cap, 17] table, and
// accumulates serially into a table resident in its fast memory. On Hopper a
// thread reads geo[face] directly, so the pre-gather and both products have
// no counterpart. The neighbor inputs are the packed backward's: the bit
// plane and the four sval planes of packed_prologue.cu (kernel K3), not the
// nfid4 / nz4 / sval4 maps, which saves reading eight planes.
//
// The reduction onto faces, without atomics (deterministic):
//   pass 1: one warp per (tile, slot) of the forward's bins (slot <
//           counts[t]). The warp scans the pixels of its tile inside the
//           face's bounding box (grown by one pixel), 32 consecutive pixels
//           of a row at a time; a lane
//           whose pixel the face owns evaluates the cotangent core
//           (cotangent_core.cuh) and adds the 12 + 3C values to its own
//           accumulators in shared memory, in scan order. A fixed xor
//           butterfly then sums the 32 lanes, and the warp writes
//           partial[t * cap + slot]. A pixel's owner is always in its tile's
//           list, since the forward draws only binned faces, and a face is
//           listed once per tile, so every covered pixel is summed exactly
//           once.
//   pass 2: one thread per (face, column) walks the tiles the face's box
//           touches in ascending order, finds the face's slot in each tile's
//           ascending list by binary search, and sums the partial rows.
// Both orders are fixed, so two runs give equal bits. The plain PyTorch
// version sums in another order (an index_add_ in float64), so kernel and
// plain agree to rounding, not bit for bit.
//
// What bounds it: the scan. Each (tile, slot) warp reads the fid plane over
// its box, so the fid reads are about the summed box areas (a few times the
// image, from the cache); the core runs once per covered pixel and reads the
// 2C + 5 planes once. Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include "cotangent_core.cuh"

namespace {

constexpr int WARPS = 4;                      // (tile, slot) entries per block
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
fused_bwd_partial_kernel(
    const float* __restrict__ geo, int geo_width,
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ bbox, const int* __restrict__ fid,
    const int* __restrict__ bits, const float* __restrict__ sval,
    const float* __restrict__ pix, const float* __restrict__ grad,
    float* __restrict__ partial, int channels, int hp, int wp, int tile_h,
    int tile_w, int cap, long long entries) {
  extern __shared__ float acc_all[];          // [WARPS][k_cols][32]
  const int k_cols = 12 + 3 * channels;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const long long entry = (long long)blockIdx.x * WARPS + warp;
  if (entry >= entries) return;               // warp-uniform; no block sync
  const int t = (int)(entry / cap);
  const int slot = (int)(entry - (long long)t * cap);
  if (slot >= counts[t]) return;
  const int face = bins[entry];

  float* acc = acc_all + warp * k_cols * 32;
  for (int k = 0; k < k_cols; ++k) acc[k * 32 + lane] = 0.0f;

  const int tiles_x = wp / tile_w;
  const int tx = (t % tiles_x) * tile_w, ty = (t / tiles_x) * tile_h;
  const int* bb = bbox + 4 * (long long)face;     // xmin, xmax, ymin, ymax
  const int x0 = max(tx, bb[0] - 1), x1 = min(tx + tile_w - 1, bb[1] + 1);
  const int y0 = max(ty, bb[2] - 1), y1 = min(ty + tile_h - 1, bb[3] + 1);
  if (x0 <= x1 && y0 <= y1) {
    float m[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) m[k] = geo[(long long)face * geo_width + k];
    const long long plane = (long long)hp * wp;
    const int w = x1 - x0 + 1;
    const int n = w * (y1 - y0 + 1);
    for (int idx = lane; idx < n; idx += 32) {
      const int yy = idx / w;
      const int x = x0 + (idx - yy * w);
      const int y = y0 + yy;
      const long long p = (long long)y * wp + x;
      if (fid[p] != face) continue;
      const float dx = ((float)x + 0.5f) - m[0];
      const float dy = ((float)y + 0.5f) - m[1];
      dirt::pixel_cotangents(
          m, dx, dy, channels, grad, pix, plane, p, bits[p], sval,
          [acc, lane](int k, float v) {
            acc[k * 32 + lane] = acc[k * 32 + lane] + v;
          });
    }
  }
  __syncwarp();
  float* dst = partial + entry * k_cols;
  for (int k = 0; k < k_cols; ++k) {
    float v = acc[k * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = v + __shfl_xor_sync(FULL, v, off);
    }
    if (lane == 0) dst[k] = v;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS)
fused_bwd_reduce_kernel(
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ bbox, const float* __restrict__ partial,
    float* __restrict__ out, int num_faces, int k_cols, int cap, int tiles_x,
    int tile_h, int tile_w) {
  const long long task = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (task >= (long long)num_faces * k_cols) return;
  const int face = (int)(task / k_cols);
  const int k = (int)(task - (long long)face * k_cols);
  // The box binning used (clipped to the image; empty when max < min).
  const int* bb = bbox + 4 * (long long)face;
  const int tx0 = bb[0] / tile_w;
  const int tx1 = bb[1] < bb[0] ? -1 : bb[1] / tile_w;
  const int ty0 = bb[2] / tile_h;
  const int ty1 = bb[3] < bb[2] ? -1 : bb[3] / tile_h;
  float sum = 0.0f;
  for (int ty = ty0; ty <= ty1; ++ty) {
    for (int tx = tx0; tx <= tx1; ++tx) {
      const int t = ty * tiles_x + tx;
      const int* list = bins + (long long)t * cap;
      int lo = 0, hi = counts[t];
      const int n = hi;
      while (lo < hi) {                       // first slot with id >= face
        const int mid = (lo + hi) >> 1;
        if (list[mid] < face) lo = mid + 1; else hi = mid;
      }
      if (lo < n && list[lo] == face) {
        sum = sum + partial[((long long)t * cap + lo) * k_cols + k];
      }
    }
  }
  out[task] = sum;
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: geo [>= num_faces, geo_width] f32; bins [tiles, cap] int32
// ascending per tile; counts [tiles] int32 (<= cap); bbox [num_faces, 4]
// int32 (xmin, xmax, ymin, ymax; the boxes the bins were made from); fid,
// bits [hp, wp] int32; sval [4, hp, wp]; pix, grad [C, hp, wp];
// partial [tiles * cap, 12 + 3C] scratch; out [>= num_faces, 12 + 3C],
// whose first num_faces rows are written. Both launches go on `stream` and
// do not synchronise. Returns the first CUDA error code (0 on success).
extern "C" int dirt_fused_bwd(
    const float* geo, int geo_width, const int* bins, const int* counts,
    const int* bbox, const int* fid, const int* bits, const float* sval,
    const float* pix, const float* grad, float* partial, float* out,
    int channels, int hp, int wp, int tile_h, int tile_w, int cap,
    int num_faces, void* stream) {
  const int k_cols = 12 + 3 * channels;
  const int tiles_y = hp / tile_h, tiles_x = wp / tile_w;
  const long long entries = (long long)tiles_y * tiles_x * cap;
  const int smem = WARPS * k_cols * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (entries > 0 && num_faces > 0) {
    const long long blocks = (entries + WARPS - 1) / WARPS;
    fused_bwd_partial_kernel<<<(unsigned)blocks, WARPS * 32, smem, st>>>(
        geo, geo_width, bins, counts, bbox, fid, bits, sval, pix, grad,
        partial, channels, hp, wp, tile_h, tile_w, cap, entries);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tasks = (long long)num_faces * k_cols;
    fused_bwd_reduce_kernel<<<(unsigned)((tasks + REDUCE_THREADS - 1) /
                                         REDUCE_THREADS),
                              REDUCE_THREADS, 0, st>>>(
        bins, counts, bbox, partial, out, num_faces, k_cols, cap, tiles_x,
        tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
