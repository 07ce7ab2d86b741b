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
// The reduction, without atomics (deterministic), takes scatter_rows.cuh's
// two passes, those of the CSR face scatter (scatter_faces_csr.cu), with a
// body of its own in pass 1:
//   pass 1: one block per 64 rows of the CSR array (half a 128-row block, so
//           all its rows belong to one tile). The block finds the tile once
//           (csr_block_tile: two rounds of a block-wide count, no serial
//           search) and leaves if it holds only padding, so three quarters of
//           a padded array's rows cost a block that exits. It stages the live
//           rows' face ids, their scan boxes (each face's cull box, the
//           forward's raster_tile.cuh::cull_box, clipped to the tile: every
//           pixel a face can own lies inside it, which the binning box of the
//           face's corners does not bound for a needle whose far corners lie
//           far off the image) and their 17 geometry columns in shared memory,
//           and its eight warps take the live rows only, each the next one not
//           taken as it comes free (a sliver's box takes many more trips than
//           a small face's, so a fixed deal leaves warps idle). A warp takes
//           an entry's box a window of 128 pixels at a time: the window's
//           owner tests are loaded together (the next window's, and the warp's
//           next entry's first, while this one's pixels run the core), and the
//           window's owned pixels, ranked in scan order, are dealt to the
//           lanes, so a round of the core runs on up to 32 owned pixels
//           however thinly they lie in the box (a sliver near a pole owns a
//           few pixels of a box of hundreds). A lane runs cotangent_core.cuh's
//           pixel_cotangents into accumulators in registers, in a fixed order:
//           the channel count is a compile-time instance (3 and 9, the counts
//           of the paths that run it; at 3, one for meshes of small faces and
//           one for larger, see SMALL_FACES), so every column index is a
//           constant. A fixed transposing xor butterfly (scatter_rows.cuh's
//           fold_step) then leaves column c's sum in lane c (a second fold for
//           columns 32 on), and the warp writes the entry's row with one
//           coalesced store. Any other channel count takes the general form:
//           fused_rows.cuh's accumulators in shared memory ([warp][column]
//           [lane], four warps a block, a pixel to the lane that tests it), a
//           butterfly per column.
//   pass 2: scatter_rows.cuh's reduce_face_rows as it is: a block per 32
//           faces finds each face's slot in the runs of the tiles its
//           binning box touches (the only runs that name it), once per face
//           and tile and not once per column, sums the partial rows in tile
//           order and writes every output row, so the caller clears
//           nothing. Rows of padding slots are neither written nor read.
// Both orders are fixed, so two runs give equal bits. They are other orders
// than those of the first version of this kernel (shared-memory
// accumulators and a butterfly per column), so the rows' bits differ from
// that version's.
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
constexpr int GEO = 17;                       // geometry columns read
constexpr int WIN = 4;                        // trips of a window
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

// The transposing butterfly over all 32 lanes: lane l ends with column
// l % KB's sum in v[0].
template <int KB>
__device__ __forceinline__ void fold(float (&v)[KB], int lane) {
  dirt::fold_step<KB, 16>(v, lane);
  dirt::fold_step<KB, 8>(v, lane);
  dirt::fold_step<KB, 4>(v, lane);
  dirt::fold_step<KB, 2>(v, lane);
  dirt::fold_step<KB, 1>(v, lane);
}

// The warp's sums of the K columns of acc, written to dst[0 .. K): columns
// 0-31 in one fold, the rest (K <= 64) in a second.
template <int K>
__device__ __forceinline__ void store_row(const float (&acc)[K], int lane,
                                          float* __restrict__ dst) {
  static_assert(K <= 64, "a compile-time instance takes up to 64 columns");
  constexpr int K1 = K < 32 ? K : 32;
  float v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = j < K1 ? acc[j < K1 ? j : 0] : 0.0f;
  fold<32>(v, lane);
  if (lane < K1) dst[lane] = v[0];
  if constexpr (K > 32) {
    constexpr int K2 = K - 32;
    constexpr int F2 = K2 <= 8 ? 8 : (K2 <= 16 ? 16 : 32);
    float w[F2];
#pragma unroll
    for (int j = 0; j < F2; ++j) {
      w[j] = j < K2 ? acc[32 + (j < K2 ? j : 0)] : 0.0f;
    }
    fold<F2>(w, lane);
    if (lane < K2) dst[32 + lane] = w[0];
  }
}

// Owner tests of the window of 32 * WIN pixels from `base` of a scan box,
// their loads in flight together: bit j is set if `face` owns the lane's
// pixel base + 32 j + lane. With FIRST, the test of the window's first 32
// pixels is `owner0`, loaded beforehand.
template <bool FIRST>
__device__ __forceinline__ unsigned window_owned(
    const int* __restrict__ fid, const int4& box, int base, int face,
    int owner0, int wp, int lane) {
  int owner[WIN];
#pragma unroll
  for (int j = 0; j < WIN; ++j) {
    const int idx = base + 32 * j + lane;
    owner[j] = (FIRST && j == 0)
                   ? owner0
                   : (idx < box.w ? __ldg(fid + dirt::box_pixel(box, idx, wp))
                                  : -1);
  }
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < WIN; ++j) bits |= (owner[j] == face ? 1u : 0u) << j;
  return bits;
}

// One warp, one entry, C channels known at compile time: the row of `face`
// over its scan box, summed in registers. The box is taken a window of
// 32 * WIN pixels at a time: the window's owner tests are loaded together
// (the next window's while this one's pixels run the core), and the owned
// pixels of the window, ranked in scan order, are dealt to the lanes (rank
// r to lane r % 32), so a round of the core runs on up to 32 owned pixels
// however they lie in the box. owner0 is the owner of the lane's pixel
// among the box's first 32; m is the face's 17 geometry columns.
template <int C>
__device__ __forceinline__ void entry_row(
    const float* m, int face, const int4& box, int owner0,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, int wp, long long plane, int lane,
    float* __restrict__ dst) {
  constexpr int K = 12 + 3 * C;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  unsigned own = window_owned<true>(fid, box, 0, face, owner0, wp, lane);
  for (int base = 0; base < box.w; base += 32 * WIN) {
    const int next = base + 32 * WIN;
    const unsigned own_next =
        next < box.w ? window_owned<false>(fid, box, next, face, 0, wp, lane)
                     : 0u;
    unsigned ballot[WIN];
    int total = 0;
#pragma unroll
    for (int j = 0; j < WIN; ++j) {
      ballot[j] = __ballot_sync(dirt::SCATTER_FULL, (own >> j) & 1u);
      total += __popc(ballot[j]);
    }
    for (int r = lane; r - lane < total; r += 32) {
      if (r >= total) continue;
      // The r-th owned pixel of the window: trip j, lane __fns(...).
      int rank = r, off = 0;
      unsigned mask = 0u;
      bool found = false;
#pragma unroll
      for (int j = 0; j < WIN; ++j) {
        const int count = __popc(ballot[j]);
        if (!found && rank < count) {
          mask = ballot[j];
          off = 32 * j;
          found = true;
        } else if (!found) {
          rank -= count;
        }
      }
      const int idx = base + off + (int)__fns(mask, 0u, rank + 1);
      const int yy = idx / box.z;
      const int x = box.x + (idx - yy * box.z);
      const int y = box.y + yy;
      const long long p = (long long)y * wp + x;
      const float dx = ((float)x + 0.5f) - m[0];
      const float dy = ((float)y + 0.5f) - m[1];
      dirt::pixel_cotangents(m, dx, dy, C, grad, pix, plane, p,
                             __ldg(bits + p), sval,
                             [&](int k, float v) { acc[k] = acc[k] + v; });
    }
    own = own_next;
  }
  store_row<K>(acc, lane, dst);
}

// Pass 1's walk for warp `warp` of a block of W warps, the staged entries
// dealt out as warps come free: warp w takes entry w first, then each warp
// takes the next entry not yet taken (*s_next, set to W before the walk)
// when it starts its current one, and loads that entry's first owner test
// meanwhile. An entry's row is one warp's work in a fixed order, so which
// warp takes it does not change its bits. entry(e, face, box, owner0) as in
// scatter_rows.cuh's walk_entries.
template <int W, class Entry>
__device__ __forceinline__ void take_entries(
    const int* s_face, const int4* s_box, int live, int* s_next,
    const int* __restrict__ fid, int wp, int warp, int lane, Entry entry) {
  int e = warp;
  int owner0 = e < live ? dirt::first_owner(fid, s_box[e], wp, lane) : -1;
  while (e < live) {
    int e_next = 0;
    if (lane == 0) e_next = atomicAdd(s_next, 1);
    e_next = __shfl_sync(dirt::SCATTER_FULL, e_next, 0);
    const int owner_next =
        e_next < live ? dirt::first_owner(fid, s_box[e_next], wp, lane) : -1;
    entry(e, s_face[e], s_box[e], owner0);
    e = e_next;
    owner0 = owner_next;
  }
}

// Pass 1: one block of W warps per ROWS rows of the CSR array (all in one
// 128-row block, so in one tile), at least MINB blocks an SM. C > 0: C
// channels at compile time; C == 0: `channels` at run time, with
// [W][12 + 3 channels][32] floats of dynamic shared memory.
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
  constexpr int THREADS = W * 32;
  constexpr int PARTS = CHUNK / ROWS;
  __shared__ int s_face[ROWS];
  __shared__ int4 s_box[ROWS];
  __shared__ float s_geo[ROWS * GEO];
  __shared__ int s_next;                      // the next entry not taken
  const int block = blockIdx.x / PARTS;       // the 128-row CSR block
  const int part = blockIdx.x - block * PARTS;
  const int t = dirt::csr_block_tile<THREADS>(start_block, block, tiles);
  const int live =
      counts[t] - (block - start_block[t]) * CHUNK - part * ROWS;
  if (live <= 0) return;                      // block-uniform: only padding
  const int n = min(live, ROWS);
  const long long row0 = (long long)block * CHUNK + part * ROWS;
  if (threadIdx.x == 0) s_next = W;
  dirt::stage_entries<THREADS>(entry_face + row0, n, t, cull, wp, tile_h,
                               tile_w, s_face, s_box);
  for (int i = threadIdx.x; i < n * GEO; i += THREADS) {
    const int j = i / GEO;
    s_geo[i] = __ldg(geo + (long long)s_face[j] * geo_width + (i - j * GEO));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const int k_cols = 12 + 3 * channels;
  const long long plane = (long long)hp * wp;
  if constexpr (C > 0) {
    take_entries<W>(
        s_face, s_box, n, &s_next, fid, wp, warp, lane,
        [&](int e, int face, const int4& box, int owner0) {
          entry_row<C>(s_geo + e * GEO, face, box, owner0, fid, bits, sval,
                       pix, grad, wp, plane, lane,
                       partial + (row0 + e) * k_cols);
        });
  } else {
    extern __shared__ float acc_all[];        // [W][k_cols][32]
    float* acc = acc_all + warp * k_cols * 32;
    for (int e = warp; e < n; e += W) {
      dirt::fused_partial_row(s_geo + e * GEO, s_face[e], s_box[e], fid,
                              bits, sval, pix, grad,
                              partial + (row0 + e) * k_cols, acc, lane,
                              channels, hp, wp);
    }
  }
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
  if (smem > 0) {
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
      err = args(launch_partial<0, dirt::ROW_WARPS, 1>,
                 dirt::partial_smem_bytes(k_cols));
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
