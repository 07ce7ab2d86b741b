// Per-face scatter over CSR runs for Hopper (sm_90a): pixel cotangent rows
// -> face rows.
//
// Replaces dirt_tpu/ops/scatter.py::_scatter_csr_kernel and the segment_sum
// behind it (both in scatter_to_faces_csr). For every face it sums the
// per-pixel rows cot[:, y, x] (channels-first planes [K, hp, wp], K = 12 +
// 3C) over the pixels the face owns (fid == face) into out[face]. The tile
// lists are the streaming forward's CSR runs: tile t lists
// entry_face[start_block[t] * 128 + i], i < counts[t], ascending, each run
// padded to whole 128-row blocks. The row-sharded renderer's streaming
// backward calls it.
//
// What the TPU kernel does that this one does not. The TPU kernel walks a
// grid of (tile, cap / 128) steps; each live step multiplies a one-hot (run
// id == pixel owner) matrix [128, tile pixels] with the tile's cotangents
// and writes 128 per-entry rows in CSR layout (a dead step zeroes its block);
// a segment_sum by entry_face then folds the [n_pad, K] rows onto the faces.
// On Hopper a thread compares fid[p] with its face directly, so the product
// has no counterpart, and no static chunk bound is needed.
//
// The reduction, without atomics (deterministic), is scatter_rows.cuh's two
// passes. Pass 1 writes the same per-entry rows: one block per 128-row block
// of the CSR array. All rows of a block belong to one tile, so the block
// finds its tile once (csr_block_tile: every thread tests one start_block
// entry, a block-wide count gives the last tile that starts at or before
// the block; two rounds of one load each, no serial search), leaves if the
// block holds only padding, and else gives its warps the block's live rows
// only: three quarters of the rows of a padded array are padding and get no
// warp. A warp scans its face's cull box clipped to the tile. Pass 2
// takes segment_sum's place: a block per 32 faces finds each face's slot in
// the runs of the tiles its box touches, once per face and not once per
// column, and writes every output row, so the caller clears nothing. Rows
// of padding slots are neither written nor read.
// The sums are taken in another order than the first version of this kernel
// took them (registers and a transposing butterfly in place of shared-memory
// accumulators), so its bits differ from that version's; two runs of this
// one agree bit for bit.
//
// What bounds it: by count, bytes (every covered pixel's K floats read once,
// the fid plane about once per listed face's box, the per-entry rows written
// and read once; no arithmetic but the sums); in practice the latency of
// dependent loads (list -> box -> owner -> planes) and the sectors a gather
// by face touches, which the passes answer with loads in flight and no work
// for padding rows: see scatter_rows.cuh.

#include <cuda_runtime.h>

#include "scatter_rows.cuh"

namespace {

__global__ void __launch_bounds__(dirt::SCATTER_THREADS)
scatter_faces_csr_partial_kernel(
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ cull,
    const int* __restrict__ fid, const float* __restrict__ cot,
    float* __restrict__ partial, int k_cols, int hp, int wp, int tile_h,
    int tile_w, int tiles) {
  const int block = blockIdx.x;
  const int t = dirt::csr_block_tile<dirt::SCATTER_THREADS>(start_block,
                                                            block, tiles);
  const int live =
      counts[t] - (block - start_block[t]) * dirt::SCATTER_CHUNK;
  if (live <= 0) return;                      // block-uniform: only padding
  const long long row0 = (long long)block * dirt::SCATTER_CHUNK;
  dirt::scatter_block_rows(entry_face + row0,
                           min(live, dirt::SCATTER_CHUNK), t, row0, cull, fid,
                           cot, partial, k_cols, hp, wp, tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::SCATTER_REDUCE_THREADS)
scatter_faces_csr_reduce_kernel(
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ bbox,
    const float* __restrict__ partial, float* __restrict__ out,
    int num_faces, int out_rows, int k_cols, int tiles_x, int tile_h,
    int tile_w) {
  const long long first_row =
      (long long)blockIdx.x * dirt::SCATTER_REDUCE_FACES;
  dirt::reduce_face_rows(
      [entry_face, start_block, counts](int t, const int** list, int* n) {
        const long long row0 =
            (long long)start_block[t] * dirt::SCATTER_CHUNK;
        *list = entry_face + row0;
        *n = counts[t];
        return row0;
      },
      bbox, partial, out, first_row, num_faces, out_rows, k_cols, tiles_x,
      tile_h, tile_w);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: entry_face [n_pad] int32, start_block (in 128-row blocks,
// start_block[0] == 0, non-decreasing) and counts [tiles] int32, the
// forward's CSR bins; bbox [num_faces, 4] int32 (xmin, xmax, ymin, ymax; the
// boxes the bins were made from: pass 2 walks their tiles); cull [>=
// num_faces, 4] int32 (the forward's cull boxes: pass 1 scans them), both
// 16-byte aligned; fid [hp, wp] int32
// (negative = no owner); cot [k_cols, hp, wp] f32; partial [n_pad, k_cols]
// scratch; out [out_rows, k_cols], every row of which is written (rows from
// num_faces on with zeros). Both launches go on `stream` and do not
// synchronise. Returns the first CUDA error code (0 on success).
extern "C" int dirt_scatter_faces_csr(
    const int* entry_face, const int* start_block, const int* counts,
    const int* bbox, const int* cull, const int* fid, const float* cot,
    float* partial, float* out, int k_cols, int hp, int wp, int tile_h,
    int tile_w, int n_pad, int num_faces, int out_rows, void* stream) {
  const int tiles_x = wp / tile_w;
  const int tiles = (hp / tile_h) * tiles_x;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_rows <= 0 || k_cols <= 0) return 0;
  if (n_pad > 0 && tiles > 0 && num_faces > 0) {
    scatter_faces_csr_partial_kernel<<<
        (unsigned)(n_pad / dirt::SCATTER_CHUNK), dirt::SCATTER_THREADS, 0,
        st>>>(entry_face, start_block, counts, cull, fid, cot, partial,
              k_cols, hp, wp, tile_h, tile_w, tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // With no list to read, pass 2 finds no face and writes zeros.
  scatter_faces_csr_reduce_kernel<<<
      (unsigned)(((long long)out_rows + dirt::SCATTER_REDUCE_FACES - 1) /
                 dirt::SCATTER_REDUCE_FACES),
      dirt::SCATTER_REDUCE_THREADS, 0, st>>>(
      entry_face, start_block, counts, bbox, partial, out,
      n_pad > 0 && tiles > 0 ? num_faces : 0, out_rows, k_cols, tiles_x,
      tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
