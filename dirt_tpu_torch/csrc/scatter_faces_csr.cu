// Per-face scatter over CSR runs for Hopper (sm_90a): pixel cotangent rows
// -> face rows.
//
// Replaces dirt_tpu/ops/scatter.py::_scatter_csr_kernel and the segment_sum
// behind it (both in scatter_to_faces_csr). For every face it sums the
// per-pixel rows cot[:, y, x] (channels-first planes [K, hp, wp], K = 12 +
// 3C) over the pixels the face owns (fid == face) into out[face]. The tile
// lists are the streaming forward's CSR runs: tile t lists
// entry_face[start_block[t] * 128 + i], i < counts[t], ascending. The
// row-sharded renderer's streaming backward calls it.
//
// What the TPU kernel does that this one does not. The TPU kernel walks a
// grid of (tile, cap / 128) steps; each live step multiplies a one-hot (run
// id == pixel owner) matrix [128, tile pixels] with the tile's cotangents
// and writes 128 per-entry rows in CSR layout (a dead step zeroes its block);
// a segment_sum by entry_face then folds the [n_pad, K] rows onto the faces.
// On Hopper a thread compares fid[p] with its face directly, so the product
// has no counterpart, and no static chunk bound is needed.
//
// The reduction, without atomics (deterministic), is fused_rows.cuh's two
// passes over fused_bwd_csr.cu's addressing. Pass 1 writes the same
// per-entry rows: one warp per row of the CSR array finds its tile by binary
// search in start_block (the last tile that starts at or before the row),
// leaves at once if the row is padding, and else scans its face's box inside
// the tile. Pass 2 takes segment_sum's place: one thread per (face, column)
// walks the face's tiles in ascending order and finds its slot in each run
// by binary search. Rows of padding slots are neither written nor read.
//
// What bounds it: bytes. Every covered pixel's K floats are read once, the
// fid plane about once per listed face's box, the per-entry rows written and
// read once; no arithmetic but the sums.

#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

constexpr int CHUNK = 128;                    // rows per CSR block

__global__ void __launch_bounds__(dirt::ROW_WARPS * 32)
scatter_faces_csr_partial_kernel(
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ bbox,
    const int* __restrict__ fid, const float* __restrict__ cot,
    float* __restrict__ partial, int k_cols, int hp, int wp, int tile_h,
    int tile_w, int tiles, long long n_pad) {
  extern __shared__ float acc_all[];          // [ROW_WARPS][k_cols][32]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const long long row = (long long)blockIdx.x * dirt::ROW_WARPS + warp;
  if (row >= n_pad) return;                   // warp-uniform; no block sync
  const int block = (int)(row / CHUNK);
  int lo = 0, hi = tiles;                     // first tile starting past row
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (start_block[mid] <= block) lo = mid + 1; else hi = mid;
  }
  const int t = lo - 1;                       // start_block[0] == 0, so >= 0
  const long long slot = row - (long long)start_block[t] * CHUNK;
  if (slot >= counts[t]) return;
  dirt::scatter_partial_row(cot, entry_face[row], t, bbox, fid,
                            partial + row * k_cols,
                            acc_all + warp * k_cols * 32, lane, k_cols, hp,
                            wp, tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::REDUCE_THREADS)
scatter_faces_csr_reduce_kernel(
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ bbox,
    const float* __restrict__ partial, float* __restrict__ out,
    int num_faces, int k_cols, int tiles_x, int tile_h, int tile_w) {
  const long long task =
      (long long)blockIdx.x * dirt::REDUCE_THREADS + threadIdx.x;
  if (task >= (long long)num_faces * k_cols) return;
  const int face = (int)(task / k_cols);
  const int k = (int)(task - (long long)face * k_cols);
  out[task] = dirt::reduce_face_column(
      [entry_face, start_block, counts](int t, const int** list, int* n) {
        const long long row0 = (long long)start_block[t] * CHUNK;
        *list = entry_face + row0;
        *n = counts[t];
        return row0;
      },
      bbox, partial, face, k, k_cols, tiles_x, tile_h, tile_w);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: entry_face [n_pad] int32, start_block (in 128-row blocks,
// start_block[0] == 0, non-decreasing) and counts [tiles] int32, the
// forward's CSR bins; bbox [num_faces, 4] int32 (xmin, xmax, ymin, ymax; the
// boxes the bins were made from); fid [hp, wp] int32 (negative = no owner);
// cot [k_cols, hp, wp] f32; partial [n_pad, k_cols] scratch; out
// [>= num_faces, k_cols], whose first num_faces rows are written. Both
// launches go on `stream` and do not synchronise. Returns the first CUDA
// error code (0 on success).
extern "C" int dirt_scatter_faces_csr(
    const int* entry_face, const int* start_block, const int* counts,
    const int* bbox, const int* fid, const float* cot, float* partial,
    float* out, int k_cols, int hp, int wp, int tile_h, int tile_w,
    int n_pad, int num_faces, void* stream) {
  const int tiles_x = wp / tile_w;
  const int tiles = (hp / tile_h) * tiles_x;
  const int smem = dirt::partial_smem_bytes(k_cols);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_faces_csr_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pad > 0 && tiles > 0 && num_faces > 0) {
    const long long blocks =
        ((long long)n_pad + dirt::ROW_WARPS - 1) / dirt::ROW_WARPS;
    scatter_faces_csr_partial_kernel<<<(unsigned)blocks,
                                       dirt::ROW_WARPS * 32, smem, st>>>(
        entry_face, start_block, counts, bbox, fid, cot, partial, k_cols, hp,
        wp, tile_h, tile_w, tiles, n_pad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tasks = (long long)num_faces * k_cols;
    scatter_faces_csr_reduce_kernel<<<
        (unsigned)((tasks + dirt::REDUCE_THREADS - 1) / dirt::REDUCE_THREADS),
        dirt::REDUCE_THREADS, 0, st>>>(
        entry_face, start_block, counts, bbox, partial, out, num_faces,
        k_cols, tiles_x, tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
