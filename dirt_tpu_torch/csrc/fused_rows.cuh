// Pass 1 of the fused backwards (fused_bwd.cu over dense [T, cap] bins,
// fused_bwd_csr.cu over CSR runs): for up to ROWS consecutive entries
// of one tile's ascending face list, each entry's partial row, the sum of
// the cotangent core (cotangent_core.cuh) over the pixels the entry's face
// owns inside the tile. A row is [9 edge | 3 den | 3C attribute] floats.
// Pass 2, the sum of each face's partial rows over the tiles that list it,
// is scatter_rows.cuh's reduce_face_rows, as the face scatters run it.
//
// A block stages its live entries' face ids, their scan boxes
// (scatter_rows.cuh's stage_entries: each face's cull box, the forward's
// raster_tile.cuh::cull_box, clipped to the tile; every pixel a face can own
// lies inside it, which the binning box of the face's corners does not bound
// for a needle whose far corners lie far off the image) and their 17
// geometry columns in shared memory, and its warps take the live entries
// only: dealt in turn (warp w takes entries w, w + W, ...), or, with TAKE,
// each the next one not taken as it comes free (a sliver's box takes many
// more trips than a small face's, so a fixed deal can leave warps idle; the
// CSR backward takes them so, with a counter in shared memory). A warp
// takes an entry's box a window of 128 pixels at a time: the window's owner
// tests are loaded together (the next window's, and the warp's next entry's
// first, while this one's pixels run the core), and the window's owned
// pixels, ranked in scan order, are dealt to the lanes, so a round of the
// core runs on up to 32 owned pixels however thinly they lie in the box (a
// sliver near a pole owns a few pixels of a box of hundreds). A lane runs
// cotangent_core.cuh's pixel_cotangents into accumulators in registers, in a
// fixed order: the channel count is a compile-time instance (3 and 9, the
// counts of the paths that run these kernels), so every column index is a
// constant. A fixed transposing xor butterfly (scatter_rows.cuh's
// fold_step) then leaves column c's sum in lane c (a second fold for columns
// 32 on), and the warp writes the entry's row with one coalesced store.
//
// Any other channel count takes the general form: accumulators in shared
// memory ([warp][column][lane], FUSED_GENERAL_WARPS warps a block, a pixel
// to the lane that tests it, 32 consecutive pixels of the box a trip) and a
// butterfly per column.
//
// A pixel's owner is always in its tile's list, since the forward draws only
// listed faces, and a face is listed at most once per tile, so every covered
// pixel is summed exactly once. Every order is fixed (an entry's row is one
// warp's work whichever warp takes it), so two runs give equal bits. Built
// with -fmad=false and IEEE division.

#pragma once

#include <cuda_runtime.h>

#include "cotangent_core.cuh"
#include "scatter_rows.cuh"

namespace dirt {

constexpr int FUSED_GENERAL_WARPS = 4;         // warps of a general block
constexpr int FUSED_GEO = 17;                 // geometry columns read
constexpr int FUSED_WIN = 4;                  // trips of a window

// Dynamic shared memory of a general-form block: [warps][k_cols][32] floats.
inline int fused_general_smem(int k_cols) {
  return FUSED_GENERAL_WARPS * k_cols * 32 * (int)sizeof(float);
}

// The transposing butterfly over all 32 lanes: lane l ends with column
// l % KB's sum in v[0].
template <int KB>
__device__ __forceinline__ void fold(float (&v)[KB], int lane) {
  fold_step<KB, 16>(v, lane);
  fold_step<KB, 8>(v, lane);
  fold_step<KB, 4>(v, lane);
  fold_step<KB, 2>(v, lane);
  fold_step<KB, 1>(v, lane);
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

// Owner tests of the window of 32 * FUSED_WIN pixels from `base` of a scan
// box, their loads in flight together: bit j is set if `face` owns the
// lane's pixel base + 32 j + lane. With FIRST, the test of the window's
// first 32 pixels is `owner0`, loaded beforehand.
template <bool FIRST>
__device__ __forceinline__ unsigned window_owned(
    const int* __restrict__ fid, const int4& box, int base, int face,
    int owner0, int wp, int lane) {
  int owner[FUSED_WIN];
#pragma unroll
  for (int j = 0; j < FUSED_WIN; ++j) {
    const int idx = base + 32 * j + lane;
    owner[j] = (FIRST && j == 0)
                   ? owner0
                   : (idx < box.w ? __ldg(fid + box_pixel(box, idx, wp))
                                  : -1);
  }
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < FUSED_WIN; ++j) {
    bits |= (owner[j] == face ? 1u : 0u) << j;
  }
  return bits;
}

// One warp, one entry, C channels known at compile time: the row of `face`
// over its scan box, summed in registers. The box is taken a window of
// 32 * FUSED_WIN pixels at a time: the window's owner tests are loaded
// together (the next window's while this one's pixels run the core), and
// the owned pixels of the window, ranked in scan order, are dealt to the
// lanes (rank r to lane r % 32), so a round of the core runs on up to 32
// owned pixels however they lie in the box. owner0 is the owner of the
// lane's pixel among the box's first 32; m is the face's 17 geometry
// columns.
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
  for (int base = 0; base < box.w; base += 32 * FUSED_WIN) {
    const int next = base + 32 * FUSED_WIN;
    const unsigned own_next =
        next < box.w ? window_owned<false>(fid, box, next, face, 0, wp, lane)
                     : 0u;
    unsigned ballot[FUSED_WIN];
    int total = 0;
#pragma unroll
    for (int j = 0; j < FUSED_WIN; ++j) {
      ballot[j] = __ballot_sync(SCATTER_FULL, (own >> j) & 1u);
      total += __popc(ballot[j]);
    }
    for (int r = lane; r - lane < total; r += 32) {
      if (r >= total) continue;
      // The r-th owned pixel of the window: trip j, lane __fns(...).
      int rank = r, off = 0;
      unsigned mask = 0u;
      bool found = false;
#pragma unroll
      for (int j = 0; j < FUSED_WIN; ++j) {
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
      pixel_cotangents(m, dx, dy, C, grad, pix, plane, p, __ldg(bits + p),
                       sval, [&](int k, float v) { acc[k] = acc[k] + v; });
    }
    own = own_next;
  }
  store_row<K>(acc, lane, dst);
}

// The general form for one warp: the row of `face` over the scan box `box`
// (x0, y0, width, pixel count), written to dst[0 .. k_cols), `acc` the
// warp's [k_cols][32] shared accumulators. A lane whose pixel the face owns
// adds the pixel's values to its own accumulators, in scan order; a
// butterfly per column then sums the 32 lanes.
__device__ __forceinline__ void general_entry_row(
    const float* m_row, int face, const int4& box,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, float* __restrict__ dst, float* acc,
    int lane, int channels, long long plane, int wp) {
  const int k_cols = 12 + 3 * channels;
  float m[FUSED_GEO];
#pragma unroll
  for (int k = 0; k < FUSED_GEO; ++k) m[k] = m_row[k];
  for (int k = 0; k < k_cols; ++k) acc[k * 32 + lane] = 0.0f;
  for (int idx = lane; idx < box.w; idx += 32) {
    const int yy = idx / box.z;
    const int x = box.x + (idx - yy * box.z);
    const int y = box.y + yy;
    const long long p = (long long)y * wp + x;
    if (fid[p] != face) continue;
    const float dx = ((float)x + 0.5f) - m[0];
    const float dy = ((float)y + 0.5f) - m[1];
    pixel_cotangents(m, dx, dy, channels, grad, pix, plane, p, bits[p], sval,
                     [acc, lane](int k, float v) {
                       acc[k * 32 + lane] = acc[k * 32 + lane] + v;
                     });
  }
  __syncwarp();
  for (int k = 0; k < k_cols; ++k) {
    float v = acc[k * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = v + __shfl_xor_sync(SCATTER_FULL, v, off);
    }
    if (lane == 0) dst[k] = v;
  }
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
  int owner0 = e < live ? first_owner(fid, s_box[e], wp, lane) : -1;
  while (e < live) {
    int e_next = 0;
    if (lane == 0) e_next = atomicAdd(s_next, 1);
    e_next = __shfl_sync(SCATTER_FULL, e_next, 0);
    const int owner_next =
        e_next < live ? first_owner(fid, s_box[e_next], wp, lane) : -1;
    entry(e, s_face[e], s_box[e], owner0);
    e = e_next;
    owner0 = owner_next;
  }
}

// Pass 1 for one block of W warps: the entries list[0 .. live), live <=
// ROWS, of tile t; entry i's partial row goes to partial[(row0 + i) *
// (12 + 3C) ..]. C > 0: C channels at compile time, the entries dealt in
// turn or (TAKE) taken as warps come free; C == 0: `channels` at run time,
// with fused_general_smem() bytes of dynamic shared memory. Every thread of
// the block calls it (it synchronises the block).
template <int C, int W, int ROWS, bool TAKE>
__device__ __forceinline__ void fused_block_rows(
    const int* __restrict__ list, int live, int t, long long row0,
    const float* __restrict__ geo, int geo_width,
    const int* __restrict__ cull, const int* __restrict__ fid,
    const int* __restrict__ bits, const float* __restrict__ sval,
    const float* __restrict__ pix, const float* __restrict__ grad,
    float* __restrict__ partial, int channels, int hp, int wp, int tile_h,
    int tile_w) {
  constexpr int THREADS = W * 32;
  __shared__ int s_face[ROWS];
  __shared__ int4 s_box[ROWS];
  __shared__ float s_geo[ROWS * FUSED_GEO];
  __shared__ int s_next;                      // TAKE: next entry not taken
  if (TAKE && threadIdx.x == 0) s_next = W;
  stage_entries<THREADS>(list, live, t, cull, wp, tile_h, tile_w, s_face,
                         s_box);
  for (int i = threadIdx.x; i < live * FUSED_GEO; i += THREADS) {
    const int j = i / FUSED_GEO;
    s_geo[i] = __ldg(geo + (long long)s_face[j] * geo_width +
                     (i - j * FUSED_GEO));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const int k_cols = 12 + 3 * channels;
  const long long plane = (long long)hp * wp;
  if constexpr (C > 0) {
    const auto entry = [&](int e, int face, const int4& box, int owner0) {
      entry_row<C>(s_geo + e * FUSED_GEO, face, box, owner0, fid, bits, sval,
                   pix, grad, wp, plane, lane, partial + (row0 + e) * k_cols);
    };
    if constexpr (TAKE) {
      take_entries<W>(s_face, s_box, live, &s_next, fid, wp, warp, lane,
                      entry);
    } else {
      walk_entries<W>(s_face, s_box, live, fid, wp, warp, lane, entry);
    }
  } else {
    extern __shared__ float acc_all[];        // [W][k_cols][32]
    float* acc = acc_all + warp * k_cols * 32;
    for (int e = warp; e < live; e += W) {
      general_entry_row(s_geo + e * FUSED_GEO, s_face[e], s_box[e], fid,
                        bits, sval, pix, grad, partial + (row0 + e) * k_cols,
                        acc, lane, channels, plane, wp);
    }
  }
}

}  // namespace dirt
