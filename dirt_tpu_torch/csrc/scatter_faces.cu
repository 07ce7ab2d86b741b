// Per-face scatter for Hopper (sm_90a): pixel cotangent rows -> face rows.
//
// Replaces dirt_tpu/ops/scatter.py::_scatter_kernel (called by
// scatter_to_faces). For every face it sums the per-pixel rows
// cot[:, y, x] (channels-first planes [K, hp, wp], K = 12 + 3C) over the
// pixels the face owns (fid == face) into out[face]. The row-sharded
// renderer's dense backward calls it: the per-pixel cotangents are made on
// arrays extended by the neighbour slabs' halo rows, sliced back to the
// slab's own rows, and scattered here over the forward's bins.
//
// What the TPU kernel does that this one does not. The TPU kernel walks a
// sequential grid of (tile, 128-slot chunk of the tile's list), multiplies a
// one-hot (list id == pixel owner) matrix [128, tile pixels] with the tile's
// cotangents on the matrix unit, and adds the 128 rows into a face table
// resident in its fast memory by a scalar loop. On Hopper blocks run in
// parallel and nothing carries over between them, and a thread can compare
// fid[p] with its face directly: the product and the resident table have no
// counterpart.
//
// The reduction, without atomics (deterministic), is fused_rows.cuh's two
// passes, shared with the fused backwards: pass 1 gives one warp to each
// (tile, slot) of the forward's bins (slot < counts[t]); the warp scans the
// face's box inside the tile, adds the K values of each pixel the face owns
// and writes partial[t * cap + slot]; pass 2 gives one thread to each (face,
// column) and sums the face's partial rows in tile order. Like the TPU
// kernel, a pixel whose owner its tile's list lacks is dropped; the forward
// lists every owner. The plain PyTorch version sums in another order (an
// index_add_ in float64), so kernel and plain agree to rounding, not bit for
// bit.
//
// What bounds it: bytes. Every covered pixel's K floats are read once (K
// planes at stride hp * wp; the lanes of a step lie along an image row), the
// fid plane about once per listed face's box, and no arithmetic but the
// sums.

#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

__global__ void __launch_bounds__(dirt::ROW_WARPS * 32)
scatter_faces_partial_kernel(
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ bbox, const int* __restrict__ fid,
    const float* __restrict__ cot, float* __restrict__ partial, int k_cols,
    int hp, int wp, int tile_h, int tile_w, int cap, long long entries) {
  extern __shared__ float acc_all[];          // [ROW_WARPS][k_cols][32]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const long long entry = (long long)blockIdx.x * dirt::ROW_WARPS + warp;
  if (entry >= entries) return;               // warp-uniform; no block sync
  const int t = (int)(entry / cap);
  const int slot = (int)(entry - (long long)t * cap);
  if (slot >= counts[t]) return;
  dirt::scatter_partial_row(cot, bins[entry], t, bbox, fid,
                            partial + entry * k_cols,
                            acc_all + warp * k_cols * 32, lane, k_cols, hp,
                            wp, tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::REDUCE_THREADS)
scatter_faces_reduce_kernel(
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ bbox, const float* __restrict__ partial,
    float* __restrict__ out, int num_faces, int k_cols, int cap, int tiles_x,
    int tile_h, int tile_w) {
  const long long task =
      (long long)blockIdx.x * dirt::REDUCE_THREADS + threadIdx.x;
  if (task >= (long long)num_faces * k_cols) return;
  const int face = (int)(task / k_cols);
  const int k = (int)(task - (long long)face * k_cols);
  out[task] = dirt::reduce_face_column(
      [bins, counts, cap](int t, const int** list, int* n) {
        *list = bins + (long long)t * cap;
        *n = counts[t];
        return (long long)t * cap;
      },
      bbox, partial, face, k, k_cols, tiles_x, tile_h, tile_w);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: bins [tiles, cap] int32 ascending per tile; counts [tiles] int32
// (<= cap); bbox [num_faces, 4] int32 (xmin, xmax, ymin, ymax; the boxes the
// bins were made from); fid [hp, wp] int32 (negative = no owner); cot
// [k_cols, hp, wp] f32; partial [tiles * cap, k_cols] scratch; out
// [>= num_faces, k_cols], whose first num_faces rows are written. Both
// launches go on `stream` and do not synchronise. Returns the first CUDA
// error code (0 on success).
extern "C" int dirt_scatter_faces(
    const int* bins, const int* counts, const int* bbox, const int* fid,
    const float* cot, float* partial, float* out, int k_cols, int hp, int wp,
    int tile_h, int tile_w, int cap, int num_faces, void* stream) {
  const int tiles_y = hp / tile_h, tiles_x = wp / tile_w;
  const long long entries = (long long)tiles_y * tiles_x * cap;
  const int smem = dirt::partial_smem_bytes(k_cols);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_faces_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (entries > 0 && num_faces > 0) {
    const long long blocks =
        (entries + dirt::ROW_WARPS - 1) / dirt::ROW_WARPS;
    scatter_faces_partial_kernel<<<(unsigned)blocks, dirt::ROW_WARPS * 32,
                                   smem, st>>>(
        bins, counts, bbox, fid, cot, partial, k_cols, hp, wp, tile_h, tile_w,
        cap, entries);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tasks = (long long)num_faces * k_cols;
    scatter_faces_reduce_kernel<<<
        (unsigned)((tasks + dirt::REDUCE_THREADS - 1) / dirt::REDUCE_THREADS),
        dirt::REDUCE_THREADS, 0, st>>>(
        bins, counts, bbox, partial, out, num_faces, k_cols, cap, tiles_x,
        tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
