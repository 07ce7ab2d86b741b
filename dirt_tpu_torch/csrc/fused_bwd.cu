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
// The reduction onto faces, deterministic, is two passes, those of the
// other whole-tile backwards:
//   pass 1: the grid of the dense face scatter (scatter_faces.cu), one block
//           per (tile, chunk of slots) of the [T, cap] bins that leaves at
//           once when the chunk starts past the tile's count (the cap is the
//           fullest tile's count, so most chunks of most tiles are empty),
//           in chunks of 4 slots with a warp each: a dense list is short (a
//           few thousand live slots on the scenes the dense paths run), so
//           every live slot is a warp of its own, and the scans spread over
//           the whole card. The block runs fused_rows.cuh's body, that of the
//           CSR backward (fused_bwd_csr.cu): it stages its live slots' faces,
//           scan boxes and geometry; a warp scans its face's cull box (the
//           forward's raster_tile.cuh::cull_box) clipped to the tile a window
//           of 128 pixels at a time and deals the owned pixels to its lanes,
//           which sum the cotangent core in registers at C = 3 and 9 and
//           in shared memory at any other C; it writes partial[t * cap +
//           slot] with one coalesced store. (The CSR backward's second C = 3
//           instance, for meshes of small faces, gained nothing here.)
//   pass 2: scatter_rows.cuh's reduce_face_rows: a block per 32 faces finds
//           each face's slot in the lists of the tiles its binning box
//           touches (the only lists that name it), once per face and tile,
//           sums the partial rows in tile order and writes every output row,
//           the sentinel's and the padding's zeros too, so the caller clears
//           nothing and no cudaFuncSetAttribute runs at C = 3 or 9.
// Both orders are fixed, so two runs give equal bits. They are other orders
// than those of the first version of this kernel (a warp per (tile, slot),
// accumulators in shared memory, a pixel to the lane that tests it, a
// butterfly per column, a thread per (face, column) in pass 2), so the
// rows' bits differ from that version's. The plain PyTorch version sums in
// yet another order (an index_add_ in float64), so kernel and plain agree
// to rounding, not bit for bit.
//
// What bounds it: by count, bytes (the 2C + 5 planes of every covered pixel
// once, the partial rows written and read once); in practice the latency
// of each slot's scan (owner tests, then the planes of the owned pixels),
// which the windows keep in flight and one warp a slot spreads over the
// SMs: a block of 8 warps taking 64 slots, the CSR backward's, left most
// of the card idle on these lists and was slower than the first version
// (PERF.md section 6). Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

// Tuning constants, what the timings on the H100 chose
// (tools/bench_raster_ab.py --kernels K6, PERF.md): the list slots a pass-1
// block takes and its warps, one slot a warp (a dense list is short, so
// every slot is a warp of its own to spread the scans over the card), and
// the blocks an SM the compile-time instances are built for (128 registers
// a thread; more blocks an SM gained nothing).
constexpr int ROWS = 4;
constexpr int WARPS = 4;
constexpr int BLOCKS = 4;

// Pass 1: one block of W warps per (tile, ROWS-slot chunk), at least MINB
// blocks an SM. C > 0: C channels at compile time; C == 0: `channels` at
// run time, with fused_general_smem() bytes of dynamic shared memory.
template <int C, int W, int MINB>
__global__ void __launch_bounds__(W * 32, MINB)
fused_bwd_partial_kernel(
    const float* __restrict__ geo, int geo_width,
    const int* __restrict__ bins, const int* __restrict__ counts,
    const int* __restrict__ cull, const int* __restrict__ fid,
    const int* __restrict__ bits, const float* __restrict__ sval,
    const float* __restrict__ pix, const float* __restrict__ grad,
    float* __restrict__ partial, int channels, int hp, int wp, int tile_h,
    int tile_w, int cap, int chunks) {
  const int t = blockIdx.x / chunks;
  const int base = (blockIdx.x - t * chunks) * ROWS;
  const int live = counts[t] - base;
  if (live <= 0) return;                      // block-uniform: an empty chunk
  const long long row0 = (long long)t * cap + base;
  dirt::fused_block_rows<C, W, ROWS, false>(
      bins + row0, min(live, ROWS), t, row0, geo, geo_width, cull, fid, bits,
      sval, pix, grad, partial, channels, hp, wp, tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::SCATTER_REDUCE_THREADS)
fused_bwd_reduce_kernel(
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

template <int C, int W, int MINB>
cudaError_t launch_partial(unsigned blocks, int smem, cudaStream_t st,
                           const float* geo, int geo_width, const int* bins,
                           const int* counts, const int* cull,
                           const int* fid, const int* bits,
                           const float* sval, const float* pix,
                           const float* grad, float* partial, int channels,
                           int hp, int wp, int tile_h, int tile_w, int cap,
                           int chunks) {
  if (smem > 48 * 1024) {                     // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        fused_bwd_partial_kernel<C, W, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fused_bwd_partial_kernel<C, W, MINB><<<blocks, W * 32, smem, st>>>(
      geo, geo_width, bins, counts, cull, fid, bits, sval, pix, grad,
      partial, channels, hp, wp, tile_h, tile_w, cap, chunks);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: geo [>= num_faces, geo_width] f32; bins [tiles, cap] int32
// ascending per tile; counts [tiles] int32 (<= cap); bbox [num_faces, 4]
// int32 (xmin, xmax, ymin, ymax; the boxes the bins were made from: pass 2
// walks their tiles) and cull [>= num_faces, 4] int32 (the forward's cull
// boxes: pass 1 scans them, clipped to the tile), both 16-byte aligned;
// fid, bits [hp, wp] int32; sval [4, hp, wp]; pix, grad [C, hp, wp];
// partial [tiles * cap, 12 + 3C] scratch; out [out_rows, 12 + 3C], every
// row of which is written (rows from num_faces on with zeros). Both launches
// go on `stream` and do not synchronise. Returns the first CUDA error code
// (0 on success).
extern "C" int dirt_fused_bwd(
    const float* geo, int geo_width, const int* bins, const int* counts,
    const int* bbox, const int* cull, const int* fid, const int* bits,
    const float* sval, const float* pix, const float* grad, float* partial,
    float* out, int channels, int hp, int wp, int tile_h, int tile_w,
    int cap, int num_faces, int out_rows, void* stream) {
  const int k_cols = 12 + 3 * channels;
  const int tiles_x = wp / tile_w;
  const int tiles = (hp / tile_h) * tiles_x;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_rows <= 0) return 0;
  const int chunks = (cap + ROWS - 1) / ROWS;
  const bool listed = tiles > 0 && chunks > 0;
  if (listed && num_faces > 0) {
    const unsigned blocks = (unsigned)((long long)tiles * chunks);
    const auto args = [&](auto launch, int smem) {
      return launch(blocks, smem, st, geo, geo_width, bins, counts, cull,
                    fid, bits, sval, pix, grad, partial, channels, hp, wp,
                    tile_h, tile_w, cap, chunks);
    };
    cudaError_t err;
    if (channels == 3) {
      err = args(launch_partial<3, WARPS, BLOCKS>, 0);
    } else if (channels == 9) {
      err = args(launch_partial<9, WARPS, BLOCKS>, 0);
    } else {
      err = args(launch_partial<0, dirt::FUSED_GENERAL_WARPS, 1>,
                 dirt::fused_general_smem(k_cols));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // With no list to read, pass 2 finds no face and writes zeros.
  fused_bwd_reduce_kernel<<<
      (unsigned)(((long long)out_rows + dirt::SCATTER_REDUCE_FACES - 1) /
                 dirt::SCATTER_REDUCE_FACES),
      dirt::SCATTER_REDUCE_THREADS, 0, st>>>(
      bins, counts, bbox, partial, out, listed ? num_faces : 0, out_rows,
      k_cols, cap, tiles_x, tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
