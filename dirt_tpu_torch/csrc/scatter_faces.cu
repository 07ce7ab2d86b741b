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
// counterpart. What is kept is its grid: one block per (tile, 128-slot
// chunk), which leaves at once when the chunk starts past the tile's count.
//
// The reduction, without atomics (deterministic), is scatter_rows.cuh's two
// passes: pass 1 gives the warps of a (tile, chunk) block the chunk's live
// slots only (most of a [T, cap] array is empty: the cap is the fullest
// tile's count); a warp scans its face's cull box (the forward's
// raster_tile.cuh::cull_box) inside the tile with a batch of
// columns in flight per pixel and writes partial[t * cap + slot]; pass 2
// gives a block to 32 faces, finds each face's slots once (not once per
// column), sums its partial rows in tile order and writes every output row,
// the zero rows too, so the caller clears nothing.
// Like the TPU kernel, a pixel whose owner its tile's list lacks is dropped;
// the forward lists every owner. The plain PyTorch version sums in another
// order (an index_add_ in float64), so kernel and plain agree to rounding,
// not bit for bit; the first version of this kernel summed in yet another
// order, so its bits differ from this one's too. Two runs of this one agree
// bit for bit.
//
// What bounds it: by count, bytes (every covered pixel's K floats read once,
// K planes at stride hp * wp with the lanes of a step along an image row,
// the fid plane about once per listed face's box); in practice the latency
// of dependent loads and the sectors a gather by face touches, which the
// passes answer with loads in flight and no work for dead slots: see
// scatter_rows.cuh.

#include <cuda_runtime.h>

#include "scatter_rows.cuh"

namespace {

__global__ void __launch_bounds__(dirt::SCATTER_THREADS)
scatter_faces_partial_kernel(
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ cull, const int* __restrict__ fid,
    const float* __restrict__ cot, float* __restrict__ partial, int k_cols,
    int hp, int wp, int tile_h, int tile_w, int cap, int chunks) {
  const int t = blockIdx.x / chunks;
  const int base = (blockIdx.x - t * chunks) * dirt::SCATTER_CHUNK;
  const int live = counts[t] - base;
  if (live <= 0) return;                      // block-uniform: an empty chunk
  const long long row0 = (long long)t * cap + base;
  dirt::scatter_block_rows(bins + row0, min(live, dirt::SCATTER_CHUNK), t,
                           row0, cull, fid, cot, partial, k_cols, hp, wp,
                           tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::SCATTER_REDUCE_THREADS)
scatter_faces_reduce_kernel(
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ bbox, const float* __restrict__ partial,
    float* __restrict__ out, int num_faces, int out_rows, int k_cols, int cap,
    int tiles_x, int tile_h, int tile_w) {
  const long long first_row =
      (long long)blockIdx.x * dirt::SCATTER_REDUCE_FACES;
  dirt::reduce_face_rows(
      [bins, counts, cap](int t, const int** list, int* n) {
        *list = bins + (long long)t * cap;
        *n = counts[t];
        return (long long)t * cap;
      },
      bbox, partial, out, first_row, num_faces, out_rows, k_cols, tiles_x,
      tile_h, tile_w);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: bins [tiles, cap] int32 ascending per tile; counts [tiles] int32
// (<= cap); bbox [num_faces, 4] int32 (xmin, xmax, ymin, ymax; the boxes the
// bins were made from: pass 2 walks their tiles); cull [>= num_faces, 4]
// int32 (the forward's cull boxes: pass 1 scans them), both 16-byte
// aligned; fid [hp, wp] int32 (negative = no
// owner); cot [k_cols, hp, wp] f32; partial [tiles * cap, k_cols] scratch;
// out [out_rows, k_cols], every row of which is written (rows from num_faces
// on with zeros). Both launches go on `stream` and do not synchronise.
// Returns the first CUDA error code (0 on success).
extern "C" int dirt_scatter_faces(
    const int* bins, const int* counts, const int* bbox, const int* cull,
    const int* fid, const float* cot, float* partial, float* out, int k_cols,
    int hp, int wp, int tile_h, int tile_w, int cap, int num_faces,
    int out_rows, void* stream) {
  const int tiles_x = wp / tile_w;
  const int tiles = (hp / tile_h) * tiles_x;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_rows <= 0 || k_cols <= 0) return 0;
  const int chunks = (cap + dirt::SCATTER_CHUNK - 1) / dirt::SCATTER_CHUNK;
  const bool listed = tiles > 0 && chunks > 0;
  if (listed && num_faces > 0) {
    scatter_faces_partial_kernel<<<(unsigned)((long long)tiles * chunks),
                                   dirt::SCATTER_THREADS, 0, st>>>(
        bins, counts, cull, fid, cot, partial, k_cols, hp, wp, tile_h, tile_w,
        cap, chunks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // With no list to read, pass 2 finds no face and writes zeros.
  scatter_faces_reduce_kernel<<<
      (unsigned)(((long long)out_rows + dirt::SCATTER_REDUCE_FACES - 1) /
                 dirt::SCATTER_REDUCE_FACES),
      dirt::SCATTER_REDUCE_THREADS, 0, st>>>(
      bins, counts, bbox, partial, out, listed ? num_faces : 0, out_rows,
      k_cols, cap, tiles_x, tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
