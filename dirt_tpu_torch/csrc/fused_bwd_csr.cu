// Fused streaming (CSR) backward for Hopper (sm_90a): per-face cotangent rows.
//
// Replaces dirt_tpu/ops/fused_bwd.py::_fused_csr_kernel and the segment_sum
// behind it (both in fused_backward_rows_csr). For every face it sums
// raster_bwd.pixel_cotangents_core over the pixels the face owns
// (fid == face), into out[face] = [9 edge | 3 den | 3C attribute] floats.
// The tile lists are the forward's CSR runs: tile t lists
// entry_face[start_block[t] * 128 + i], i < counts[t], ascending.
//
// What the TPU kernel does that this one does not. The TPU kernel walks a
// grid of (tile, 2 * cap / 128 + 1) steps: it gathers each pixel's owning
// geometry row through one-hot matrix products against a pre-gathered
// [n_pad, 17] table, evaluates the cotangent fields of the tile, and emits
// per-entry rows [n_pad, 12 + 3C] in CSR layout through a second one-hot
// product; a segment_sum by entry_face then folds the rows onto the faces.
// On Hopper a thread reads geo[face] directly, so the pre-gather and both
// products have no counterpart, and the neighbor inputs are the bit plane
// and the four sval planes of packed_prologue.cu, not the nfid4 / nz4 /
// sval4 maps.
//
// The reduction, without atomics (deterministic), is fused_rows.cuh's two
// passes, shared with the dense kernel. Pass 1 writes the same per-entry
// rows in CSR layout: one warp per row of the CSR array. A warp finds its
// row's tile by binary search in start_block (the last tile that starts at
// or before the row; tiles with an empty run share their start with the
// next tile, and the last of them is the one that may hold the row) and
// leaves at once if the row is padding, so the launch covers the n_pad rows
// and not tiles * cap slots. Pass 2 takes segment_sum's place: one thread
// per (face, column) walks the face's tiles in ascending order and finds its
// slot in each run by binary search. Rows of padding slots are neither
// written nor read.
//
// What bounds it: the scan. Each entry's warp reads the fid plane over its
// face's box inside the tile; the core runs once per covered pixel and reads
// the 2C + 5 planes once; the per-entry rows are written and read once.
// Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

constexpr int CHUNK = 128;                    // rows per CSR block

__global__ void __launch_bounds__(dirt::ROW_WARPS * 32)
fused_bwd_csr_partial_kernel(
    const float* __restrict__ geo, int geo_width,
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ bbox,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, float* __restrict__ partial,
    int channels, int hp, int wp, int tile_h, int tile_w, int tiles,
    long long n_pad) {
  extern __shared__ float acc_all[];          // [ROW_WARPS][k_cols][32]
  const int k_cols = 12 + 3 * channels;
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
  dirt::fused_partial_row(geo, geo_width, entry_face[row], t, bbox, fid, bits,
                         sval, pix, grad, partial + row * k_cols,
                         acc_all + warp * k_cols * 32, lane, channels, hp, wp,
                         tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::REDUCE_THREADS)
fused_bwd_csr_reduce_kernel(
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
// pointers: geo [>= num_faces, geo_width] f32; entry_face [n_pad] int32,
// start_block (in 128-row blocks, start_block[0] == 0, non-decreasing) and
// counts [tiles] int32, the forward's CSR bins; bbox [num_faces, 4] int32
// (xmin, xmax, ymin, ymax; the boxes the bins were made from); fid, bits
// [hp, wp] int32; sval [4, hp, wp]; pix, grad [C, hp, wp]; partial [n_pad,
// 12 + 3C] scratch; out [>= num_faces, 12 + 3C], whose first num_faces rows
// are written. Both launches go on `stream` and do not synchronise. Returns
// the first CUDA error code (0 on success).
extern "C" int dirt_fused_bwd_csr(
    const float* geo, int geo_width, const int* entry_face,
    const int* start_block, const int* counts, const int* bbox,
    const int* fid, const int* bits, const float* sval, const float* pix,
    const float* grad, float* partial, float* out, int channels, int hp,
    int wp, int tile_h, int tile_w, int n_pad, int num_faces, void* stream) {
  const int k_cols = 12 + 3 * channels;
  const int tiles_x = wp / tile_w;
  const int tiles = (hp / tile_h) * tiles_x;
  const int smem = dirt::partial_smem_bytes(k_cols);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_csr_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_pad > 0 && tiles > 0 && num_faces > 0) {
    const long long blocks =
        ((long long)n_pad + dirt::ROW_WARPS - 1) / dirt::ROW_WARPS;
    fused_bwd_csr_partial_kernel<<<(unsigned)blocks, dirt::ROW_WARPS * 32,
                                   smem, st>>>(
        geo, geo_width, entry_face, start_block, counts, bbox, fid, bits,
        sval, pix, grad, partial, channels, hp, wp, tile_h, tile_w, tiles,
        n_pad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tasks = (long long)num_faces * k_cols;
    fused_bwd_csr_reduce_kernel<<<
        (unsigned)((tasks + dirt::REDUCE_THREADS - 1) / dirt::REDUCE_THREADS),
        dirt::REDUCE_THREADS, 0, st>>>(
        entry_face, start_block, counts, bbox, partial, out, num_faces,
        k_cols, tiles_x, tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
