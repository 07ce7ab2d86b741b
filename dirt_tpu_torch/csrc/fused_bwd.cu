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
// The reduction onto faces, without atomics (deterministic), is
// fused_rows.cuh's two passes (the streaming kernel, fused_bwd_csr.cu, has
// passes of its own): pass 1 gives
// one warp to each (tile, slot) of the forward's bins (slot < counts[t]) and
// writes partial[t * cap + slot]; pass 2 gives one thread to each (face,
// column). The plain PyTorch version sums in another order (an index_add_ in
// float64), so kernel and plain agree to rounding, not bit for bit.
//
// A warp scans its face's cull box (the forward's raster_tile.cuh::cull_box,
// clipped to the tile): every pixel the face can own lies inside it, which
// the binning box of the face's corners does not bound for a needle whose
// far corners lie far off the image. Pass 2 walks the tiles of the binning
// box, the only ones whose lists name the face.
//
// What bounds it: the scan. Each (tile, slot) warp reads the fid plane over
// its box, so the fid reads are about the summed box areas (a few times the
// image, from the cache); the core runs once per covered pixel and reads the
// 2C + 5 planes once. Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

__global__ void __launch_bounds__(dirt::ROW_WARPS * 32)
fused_bwd_partial_kernel(
    const float* __restrict__ geo, int geo_width,
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ cull, const int* __restrict__ fid,
    const int* __restrict__ bits, const float* __restrict__ sval,
    const float* __restrict__ pix, const float* __restrict__ grad,
    float* __restrict__ partial, int channels, int hp, int wp, int tile_h,
    int tile_w, int cap, long long entries) {
  extern __shared__ float acc_all[];          // [ROW_WARPS][k_cols][32]
  const int k_cols = 12 + 3 * channels;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const long long entry = (long long)blockIdx.x * dirt::ROW_WARPS + warp;
  if (entry >= entries) return;               // warp-uniform; no block sync
  const int t = (int)(entry / cap);
  const int slot = (int)(entry - (long long)t * cap);
  if (slot >= counts[t]) return;
  const int face = bins[entry];
  const int4 box = dirt::tile_scan_box(
      reinterpret_cast<const int4*>(cull)[face], t, wp, tile_h, tile_w);
  dirt::fused_partial_row(geo + (long long)face * geo_width, face, box, fid,
                          bits, sval, pix, grad, partial + entry * k_cols,
                          acc_all + warp * k_cols * 32, lane, channels, hp,
                          wp);
}

__global__ void __launch_bounds__(dirt::REDUCE_THREADS)
fused_bwd_reduce_kernel(
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
// pointers: geo [>= num_faces, geo_width] f32; bins [tiles, cap] int32
// ascending per tile; counts [tiles] int32 (<= cap); bbox [num_faces, 4]
// int32 (xmin, xmax, ymin, ymax; the boxes the bins were made from: pass 2
// walks their tiles); cull [>= num_faces, 4] int32, 16-byte aligned (the
// forward's cull boxes: pass 1 scans them, clipped to the tile); fid,
// bits [hp, wp] int32; sval [4, hp, wp]; pix, grad [C, hp, wp];
// partial [tiles * cap, 12 + 3C] scratch; out [>= num_faces, 12 + 3C],
// whose first num_faces rows are written. Both launches go on `stream` and
// do not synchronise. Returns the first CUDA error code (0 on success).
extern "C" int dirt_fused_bwd(
    const float* geo, int geo_width, const int* bins, const int* counts,
    const int* bbox, const int* cull, const int* fid, const int* bits,
    const float* sval, const float* pix, const float* grad, float* partial,
    float* out, int channels, int hp, int wp, int tile_h, int tile_w,
    int cap, int num_faces, void* stream) {
  const int k_cols = 12 + 3 * channels;
  const int tiles_y = hp / tile_h, tiles_x = wp / tile_w;
  const long long entries = (long long)tiles_y * tiles_x * cap;
  const int smem = dirt::partial_smem_bytes(k_cols);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (entries > 0 && num_faces > 0) {
    const long long blocks =
        (entries + dirt::ROW_WARPS - 1) / dirt::ROW_WARPS;
    fused_bwd_partial_kernel<<<(unsigned)blocks, dirt::ROW_WARPS * 32, smem,
                               st>>>(
        geo, geo_width, bins, counts, cull, fid, bits, sval, pix, grad,
        partial, channels, hp, wp, tile_h, tile_w, cap, entries);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tasks = (long long)num_faces * k_cols;
    fused_bwd_reduce_kernel<<<(unsigned)((tasks + dirt::REDUCE_THREADS - 1) /
                                         dirt::REDUCE_THREADS),
                              dirt::REDUCE_THREADS, 0, st>>>(
        bins, counts, bbox, partial, out, num_faces, k_cols, cap, tiles_x,
        tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
