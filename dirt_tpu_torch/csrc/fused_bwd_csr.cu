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
// On Hopper a thread reads the owner's geometry row directly, so the
// pre-gather and both products have no counterpart, and the neighbor inputs
// are the bit plane and the four sval planes of packed_prologue.cu, not the
// nfid4 / nz4 / sval4 maps.
//
// The reduction onto faces, deterministic, is two passes:
//   pass 1: fused_rows.cuh's block body over CSR rows: one block per 64
//           rows of the CSR array (half a 128-row block, so all its rows
//           belong to one tile). The block finds the tile once
//           (scatter_rows.cuh's csr_block_tile: two rounds of a block-wide
//           count, no serial search) and leaves if it holds only padding, so
//           three quarters of a padded array's rows cost a block that exits.
//           Its eight warps take the live rows only, each the next one not
//           taken as it comes free (a counter in shared memory hands them
//           out; it decides which warp computes a row, never the row's
//           bits). A warp scans its face's cull box clipped to the tile a
//           window of 128 pixels at a time and deals the owned pixels to its
//           lanes, which sum the cotangent core in registers at C = 3 and 9
//           (two instances at 3, for meshes of small faces and of larger
//           ones) and in shared memory at any other C; it writes the row with
//           one coalesced store.
//   pass 2: scatter_rows.cuh's reduce_face_rows as it is: a block per 32
//           faces finds each face's slot in the runs of the tiles its
//           binning box touches (the only runs that name it), once per face
//           and tile and not once per column, sums the partial rows in tile
//           order and writes every output row, so the caller clears
//           nothing. Rows of padding slots are neither written nor read.
// Both orders are fixed, so two runs give equal bits. They are other orders
// than those of the first version of this kernel (shared-memory
// accumulators and a butterfly per column), so the rows' bits differ from
// that version's. The dense fused backward (fused_bwd.cu) runs the same
// block body over its [T, cap] bins.
//
// What bounds it: by count, bytes (the fid plane over each entry's box, the
// 2C + 5 planes of every covered pixel once, the per-entry rows written and
// read once); in practice the latency of the loads of each entry's scan
// (owner tests, then the planes of the owned pixels) in warps that each
// take a few entries in turn, the accumulators in registers allowing two
// or three blocks an SM. Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

constexpr int CHUNK = dirt::SCATTER_CHUNK;    // rows per CSR block
// Tuning constants, what the timings on the H100 chose
// (tools/bench_raster_ab.py, PERF.md): the CSR rows a pass-1 block takes (a
// part of a 128-row block: fewer rows a block give its warps fewer entries
// each), and the warps of a pass-1 block of the compile-time instances.
constexpr int ROWS = 64;
constexpr int WARPS = 8;
static_assert(CHUNK % ROWS == 0, "a pass-1 block lies in one CSR block");
// At C = 3, a mesh of at least one face per SMALL_FACES pixels of the image
// has faces of a few pixels each, and its entries are many and short: their
// scans' latency is what counts, so the instance that keeps three blocks an
// SM (80 registers a thread) runs them. A mesh of fewer, larger faces has
// fewer entries with more owned pixels each, and the core's arithmetic
// counts: the instance with more registers and two blocks an SM runs them.
// Pass 1 alone, the instance chosen against the other, uv spheres at
// 1024^2 (NVIDIA H100 80GB HBM3, 700 W; tools/bench_raster_ab.py, PERF.md
// section 6): 10,224 faces 0.1232 ms against 0.1394, 19,800 0.1272 against
// 0.1375, then three blocks: 40,044 0.1251 against 0.1296, 65,160 0.1081
// against 0.1206, 99,904 0.1078 against 0.1314. They cross between one
// face per 53 and per 26 pixels.
constexpr long long SMALL_FACES = 32;

// Pass 1: one block of W warps per ROWS rows of the CSR array (all in one
// 128-row block, so in one tile), at least MINB blocks an SM; fused_rows.cuh
// with the entries taken as warps come free. C > 0: C channels at compile
// time; C == 0: `channels` at run time, with fused_general_smem() bytes of
// dynamic shared memory.
template <int C, int W, int MINB>
__global__ void __launch_bounds__(W * 32, MINB)
fused_bwd_csr_partial_kernel(
    const float* __restrict__ geo, int geo_width,
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ cull,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, float* __restrict__ partial,
    int channels, int hp, int wp, int tile_h, int tile_w, int tiles) {
  constexpr int PARTS = CHUNK / ROWS;
  const int block = blockIdx.x / PARTS;       // the 128-row CSR block
  const int part = blockIdx.x - block * PARTS;
  const int t = dirt::csr_block_tile<W * 32>(start_block, block, tiles);
  const int live =
      counts[t] - (block - start_block[t]) * CHUNK - part * ROWS;
  if (live <= 0) return;                      // block-uniform: only padding
  const long long row0 = (long long)block * CHUNK + part * ROWS;
  dirt::fused_block_rows<C, W, ROWS, true>(
      entry_face + row0, min(live, ROWS), t, row0, geo, geo_width, cull, fid,
      bits, sval, pix, grad, partial, channels, hp, wp, tile_h, tile_w);
}

__global__ void __launch_bounds__(dirt::SCATTER_REDUCE_THREADS)
fused_bwd_csr_reduce_kernel(
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int* __restrict__ bbox,
    const float* __restrict__ partial, float* __restrict__ out,
    int num_faces, int out_rows, int k_cols, int tiles_x, int tile_h,
    int tile_w) {
  const long long first_row =
      (long long)blockIdx.x * dirt::SCATTER_REDUCE_FACES;
  dirt::reduce_face_rows(
      [entry_face, start_block, counts](int t, const int** list, int* n) {
        const long long row0 = (long long)start_block[t] * CHUNK;
        *list = entry_face + row0;
        *n = counts[t];
        return row0;
      },
      bbox, partial, out, first_row, num_faces, out_rows, k_cols, tiles_x,
      tile_h, tile_w);
}

template <int C, int W, int MINB>
cudaError_t launch_partial(unsigned blocks, int smem, cudaStream_t st,
                           const float* geo, int geo_width,
                           const int* entry_face, const int* start_block,
                           const int* counts, const int* cull,
                           const int* fid, const int* bits,
                           const float* sval, const float* pix,
                           const float* grad, float* partial, int channels,
                           int hp, int wp, int tile_h, int tile_w,
                           int tiles) {
  if (smem > 48 * 1024) {                     // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        fused_bwd_csr_partial_kernel<C, W, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fused_bwd_csr_partial_kernel<C, W, MINB><<<blocks, W * 32, smem, st>>>(
      geo, geo_width, entry_face, start_block, counts, cull, fid, bits, sval,
      pix, grad, partial, channels, hp, wp, tile_h, tile_w, tiles);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers: geo [>= num_faces, geo_width] f32; entry_face [n_pad] int32
// (n_pad a multiple of 128), start_block (in 128-row blocks, start_block[0]
// == 0, non-decreasing) and counts [tiles] int32, the forward's CSR bins;
// bbox [num_faces, 4] int32 (xmin, xmax, ymin, ymax; the boxes the bins were
// made from: pass 2 walks their tiles) and cull [>= num_faces, 4] int32 (the
// forward's cull boxes: pass 1 scans them), both 16-byte aligned; fid, bits
// [hp, wp] int32; sval [4, hp, wp]; pix, grad [C, hp, wp]; partial [n_pad,
// 12 + 3C] scratch; out [num_faces, 12 + 3C], every row of which is
// written. Both launches go on `stream` and do not synchronise. Returns the
// first CUDA error code (0 on success).
extern "C" int dirt_fused_bwd_csr(
    const float* geo, int geo_width, const int* entry_face,
    const int* start_block, const int* counts, const int* bbox,
    const int* cull, const int* fid, const int* bits, const float* sval,
    const float* pix, const float* grad, float* partial, float* out,
    int channels, int hp, int wp, int tile_h, int tile_w, int n_pad,
    int num_faces, void* stream) {
  const int k_cols = 12 + 3 * channels;
  const int tiles_x = wp / tile_w;
  const int tiles = (hp / tile_h) * tiles_x;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_faces <= 0) return 0;
  const bool listed = n_pad > 0 && tiles > 0;
  if (listed) {
    const unsigned blocks = (unsigned)(n_pad / ROWS);
    const auto args = [&](auto launch, int smem) {
      return launch(blocks, smem, st, geo, geo_width, entry_face,
                    start_block, counts, cull, fid, bits, sval, pix, grad,
                    partial, channels, hp, wp, tile_h, tile_w, tiles);
    };
    const bool small_faces =
        (long long)num_faces * SMALL_FACES >= (long long)hp * wp;
    cudaError_t err;
    if (channels == 3 && small_faces) {
      err = args(launch_partial<3, WARPS, 3>, 0);
    } else if (channels == 3) {
      err = args(launch_partial<3, WARPS, 2>, 0);
    } else if (channels == 9) {
      err = args(launch_partial<9, WARPS, 2>, 0);
    } else {
      err = args(launch_partial<0, dirt::FUSED_GENERAL_WARPS, 1>,
                 dirt::fused_general_smem(k_cols));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // With no list to read, pass 2 finds no face and writes zeros.
  fused_bwd_csr_reduce_kernel<<<
      (unsigned)(((long long)num_faces + dirt::SCATTER_REDUCE_FACES - 1) /
                 dirt::SCATTER_REDUCE_FACES),
      dirt::SCATTER_REDUCE_THREADS, 0, st>>>(
      entry_face, start_block, counts, bbox, partial, out,
      listed ? num_faces : 0, num_faces, k_cols, tiles_x, tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
