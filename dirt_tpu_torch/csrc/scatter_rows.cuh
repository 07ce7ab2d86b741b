// The two passes of the face scatters (scatter_faces.cu over dense [T, cap]
// bins, scatter_faces_csr.cu over CSR runs): per-pixel rows cot[:, y, x]
// (channels-first planes [K, hp, wp]) summed onto the face that owns the
// pixel, without atomics. The fused backwards (fused_bwd.cu over dense bins,
// fused_bwd_csr.cu over CSR runs) take the block structure of pass 1
// (csr_block_tile, stage_entries, walk_entries, fold_step) with a body of
// their own (fused_rows.cuh), and pass 2 as it is. These passes are shaped
// by what bounds a scatter on Hopper.
// By count that is bytes, but the card could move the bytes the function
// needs in a sixth of the time it takes: what it waits for is the chain of
// dependent loads (list -> box -> owner -> planes) and the 32-byte sectors
// a gather by face touches (a face owns a few pixels of a row of its box, so
// a sector carries a dozen useful bytes, in each of K planes). So the design
// keeps many loads in flight, gives a warp only to list entries that are
// live, and spends one load on a step of the scan that finds no owned pixel.
//
//   pass 1 (scatter_block_rows): one block per 128 consecutive slots of one
//           tile's list; the caller has already left if none of them is
//           live. The block stages the live entries' face ids and scan boxes
//           (stage_entries: each face's cull box, the forward's
//           raster_tile.cuh::cull_box, clipped to the tile; every pixel a
//           face can own lies inside its cull box, which the binning box of
//           its corners does not bound for a needle whose far corners lie
//           far off the image) in shared memory, and its warps stride over
//           the entries (walk_entries). A warp scans an entry's box 32
//           pixels at a time, lanes along image rows; a trip in which the
//           face owns no pixel costs one load of the owners and no more. A
//           lane whose pixel the face owns loads a batch of 8, 16, 24 or 32
//           columns of that pixel (one plane each, all in flight before the
//           first add) and adds them to accumulators in registers, in scan
//           order; the owner test of the next 32 pixels (and of the warp's
//           next entry) is loaded before the batch, so it is in flight
//           meanwhile. More columns take further batches over the same
//           pixels; a bit mask keeps the first 32 owner tests. A fixed
//           transposing xor butterfly (31 shuffles for 32 columns, where a
//           butterfly per column takes 160) leaves column c's sum in lane c,
//           and the warp writes the entry's partial row with one coalesced
//           store.
//   pass 2 (reduce_face_rows): one block of 128 threads per 32 consecutive
//           faces. Four threads a face each find the face's slot in one of
//           the tiles its binning box touches (a face is listed in those
//           tiles only; ascending tiles; a search probes seven pivots a
//           round; a face in more than four tiles takes further rounds), so
//           the searches run once per face and tile, not once per column,
//           and side by side. The block then writes the 32 output rows as
//           one contiguous range, each value the sum of its face's partial
//           rows in tile order. It writes every row of the output, zeros
//           included (faces no list names, the sentinel row, padding rows),
//           so the caller clears nothing.
// Both orders are fixed (scan order per lane, the butterfly, tile order), so
// two runs give equal bits. Built with -fmad=false.

#pragma once

#include <climits>

#include <cuda_runtime.h>

// Tuning constants; the defaults are what the timings on the H100 chose
// (tools/bench_scatter.py --define builds and times other values).
// Warps of a pass-1 block: its up to 128 entries are dealt out to them, so
// more warps mean shorter chains of dependent loads per warp.
#ifndef SCATTER_WARPS
#define SCATTER_WARPS 16
#endif
// Widest batch of columns a lane loads together: 8, 16, 24 or 32. A wider
// batch keeps more loads in flight per warp and costs two registers a
// column, so fewer warps fit an SM.
#ifndef SCATTER_COLS
#define SCATTER_COLS 32
#endif
namespace dirt {

constexpr int SCATTER_CHUNK = 128;            // list slots per pass-1 block
constexpr int SCATTER_THREADS = SCATTER_WARPS * 32;
constexpr int SCATTER_REDUCE_FACES = 32;      // pass 2: faces per block
constexpr int SCATTER_SEARCHES = 4;           // pass 2: threads per face
constexpr int SCATTER_REDUCE_THREADS =
    SCATTER_REDUCE_FACES * SCATTER_SEARCHES;
constexpr int SCATTER_PIVOTS = 7;             // pass 2: probes per round
constexpr unsigned SCATTER_FULL = 0xffffffffu;

// One step of the transposing butterfly over lanes `OFF` apart. While a lane
// holds more than OFF live values, partners split them: the lower lane keeps
// the first half and the upper lane the second, each adding what the other
// sends. After the steps 16, 8, 4, 2, 1 lane l holds in v[0] the sum over
// all 32 lanes of column l % KB.
template <int KB, int OFF>
__device__ __forceinline__ void fold_step(float (&v)[KB], int lane) {
  if constexpr (KB >= 2 * OFF) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int j = 0; j < OFF; ++j) {
      const float send = upper ? v[j] : v[j + OFF];
      const float keep = upper ? v[j + OFF] : v[j];
      v[j] = keep + __shfl_xor_sync(SCATTER_FULL, send, OFF);
    }
  } else {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      v[j] = v[j] + __shfl_xor_sync(SCATTER_FULL, v[j], OFF);
    }
  }
}

// Pixel idx of a clipped box (x0, y0, width, pixel count), in scan order: its
// offset in a plane of pitch wp.
__device__ __forceinline__ long long box_pixel(const int4& box, int idx,
                                               int wp) {
  const int yy = idx / box.z;
  return (long long)(box.y + yy) * wp + (box.x + idx - yy * box.z);
}

// The owner of the lane's pixel in an entry's first 32 (-1 past the box).
__device__ __forceinline__ int first_owner(const int* __restrict__ fid,
                                           const int4& box, int wp,
                                           int lane) {
  return lane < box.w ? __ldg(fid + box_pixel(box, lane, wp)) : -1;
}

// *ptr through the read-only path if `on`, else 0 without touching memory:
// a predicated instruction, so that a few of them in a row are a straight
// run of loads with no branch between them.
__device__ __forceinline__ float load_if(const float* ptr, bool on) {
  float v;
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "setp.ne.u32 p, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\t"
      "@p ld.global.nc.f32 %0, [%1];\n\t"
      "}"
      : "=f"(v)
      : "l"(ptr), "r"((unsigned)on));
  return v;
}

// One warp, one list entry, the LOADS columns from k0 on: their sums over the
// box's pixels that `face` owns, written to dst[k0 ..] for the columns below
// k_cols. A column past the last repeats the last one's address (a load the
// cache answers), so every load of the batch is unconditional and the
// compiler keeps them together; such a column's sum is never stored. The
// first batch (k0 == 0) takes the lane's first owner from `owner0` and
// records the first 32 owner tests in `own_bits`; later batches read them.
template <int LOADS>
__device__ __forceinline__ void scatter_entry_batch(
    const float* __restrict__ cot, const int* __restrict__ fid, int face,
    const int4& box, int owner0, unsigned& own_bits, int k0, int k_cols,
    int wp, long long plane, int lane, float* __restrict__ dst) {
  constexpr int FOLD = LOADS <= 8 ? 8 : (LOADS <= 16 ? 16 : 32);
  float acc[FOLD];
#pragma unroll
  for (int j = 0; j < FOLD; ++j) acc[j] = 0.0f;
  const bool first = k0 == 0;
  const int last = k_cols - 1 - k0;
  const int trips = (box.w + 31) >> 5;
  int idx = lane;
  long long p = idx < box.w ? box_pixel(box, idx, wp) : 0;
  int owner = first ? owner0 : ((own_bits & 1u) ? face : -1);
  for (int trip = 0; trip < trips; ++trip) {
    // The next 32 pixels' owner test, in flight while this batch loads.
    const int idx_next = idx + 32;
    long long p_next = 0;
    int owner_next = -1;
    if (trip + 1 < trips && idx_next < box.w) {
      p_next = box_pixel(box, idx_next, wp);
      if (first || trip + 1 >= 32) {
        owner_next = __ldg(fid + p_next);
      } else if ((own_bits >> (trip + 1)) & 1u) {
        owner_next = face;
      }
    }
    if (owner == face) {
      if (first && trip < 32) own_bits |= 1u << trip;
      const float* src = cot + (long long)k0 * plane + p;
      float v[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        v[j] = __ldg(src);
        if (j < last) src += plane;
      }
#pragma unroll
      for (int j = 0; j < LOADS; ++j) acc[j] = acc[j] + v[j];
    }
    idx = idx_next;
    p = p_next;
    owner = owner_next;
  }
  fold_step<FOLD, 16>(acc, lane);
  fold_step<FOLD, 8>(acc, lane);
  fold_step<FOLD, 4>(acc, lane);
  fold_step<FOLD, 2>(acc, lane);
  fold_step<FOLD, 1>(acc, lane);
  if (lane < LOADS && k0 + lane < k_cols) dst[k0 + lane] = acc[0];
}

// One warp, one list entry: all k_cols columns, in batches of up to
// SCATTER_COLS.
__device__ __forceinline__ void scatter_entry(
    const float* __restrict__ cot, const int* __restrict__ fid, int face,
    const int4& box, int owner0, int k_cols, int wp, long long plane,
    int lane, float* __restrict__ dst) {
  unsigned own_bits = 0u;
  for (int k0 = 0; k0 < k_cols; k0 += SCATTER_COLS) {
    const int left = k_cols - k0;
    if constexpr (SCATTER_COLS > 24) {
      if (left > 24) {
        scatter_entry_batch<32>(cot, fid, face, box, owner0, own_bits, k0,
                                k_cols, wp, plane, lane, dst);
        continue;
      }
    }
    if constexpr (SCATTER_COLS > 16) {
      if (left > 16) {
        scatter_entry_batch<24>(cot, fid, face, box, owner0, own_bits, k0,
                                k_cols, wp, plane, lane, dst);
        continue;
      }
    }
    if constexpr (SCATTER_COLS > 8) {
      if (left > 8) {
        scatter_entry_batch<16>(cot, fid, face, box, owner0, own_bits, k0,
                                k_cols, wp, plane, lane, dst);
        continue;
      }
    }
    scatter_entry_batch<8>(cot, fid, face, box, owner0, own_bits, k0, k_cols,
                           wp, plane, lane, dst);
  }
}

// The box `cb` (xmin, xmax, ymin, ymax) clipped to tile t, as the scan box of
// a list entry: (x0, y0, width >= 1, pixel count; 0 when they do not meet).
__device__ __forceinline__ int4 tile_scan_box(const int4& cb, int t, int wp,
                                              int tile_h, int tile_w) {
  const int tiles_x = wp / tile_w;
  const int tx = (t % tiles_x) * tile_w, ty = (t / tiles_x) * tile_h;
  const int x0 = max(tx, cb.x), x1 = min(tx + tile_w - 1, cb.y);
  const int y0 = max(ty, cb.z), y1 = min(ty + tile_h - 1, cb.w);
  const int w = max(x1 - x0 + 1, 0), h = max(y1 - y0 + 1, 0);
  return make_int4(x0, y0, max(w, 1), w * h);
}

// The tile of CSR block `block` (start_block in blocks, non-decreasing,
// start_block[0] == 0): the last tile that starts at or before it, for a
// block of THREADS threads. A coarse round over every stride-th tile, then
// a fine round inside the stride it found; every thread tests one entry a
// round and a block-wide count gives the answer, so there is no serial
// search. Every thread of the block calls it (it synchronises the block).
template <int THREADS>
__device__ __forceinline__ int csr_block_tile(
    const int* __restrict__ start_block, int block, int tiles) {
  const int stride = (tiles + THREADS - 1) / THREADS;
  const long long coarse = (long long)threadIdx.x * stride;
  int t = __syncthreads_count(coarse < tiles &&
                              start_block[coarse] <= block) - 1;
  if (stride > 1) {
    const int base = t * stride;
    int inside = 0;
    for (int off = 0; off < stride; off += THREADS) {
      const int i = off + threadIdx.x;
      inside += __syncthreads_count(i < stride && base + i < tiles &&
                                    start_block[base + i] <= block);
    }
    t = base + inside - 1;
  }
  return t;
}

// Pass 1's staging, for a block of THREADS threads: the faces of list[0 ..
// live) of tile t and their scan boxes (each face's cull box clipped to the
// tile) into s_face / s_box. Every thread of the block calls it (it
// synchronises the block).
template <int THREADS>
__device__ __forceinline__ void stage_entries(
    const int* __restrict__ list, int live, int t,
    const int* __restrict__ cull, int wp, int tile_h, int tile_w,
    int* s_face, int4* s_box) {
  for (int i = threadIdx.x; i < live; i += THREADS) {
    const int face = list[i];
    // xmin, xmax, ymin, ymax: 16 bytes a thread.
    s_face[i] = face;
    s_box[i] = tile_scan_box(reinterpret_cast<const int4*>(cull)[face], t,
                             wp, tile_h, tile_w);
  }
  __syncthreads();
}

// Pass 1's walk, for warp `warp` of a block of WARPS warps: the staged
// entries warp, warp + WARPS, ... below live, each handed to entry(e, face,
// box, owner0), owner0 being the owner of the lane's pixel among the
// entry's first 32, loaded while the warp's previous entry ran.
template <int WARPS, class Entry>
__device__ __forceinline__ void walk_entries(
    const int* s_face, const int4* s_box, int live,
    const int* __restrict__ fid, int wp, int warp, int lane, Entry entry) {
  int e = warp;
  int face = 0, owner0 = -1;
  int4 box = make_int4(0, 0, 1, 0);
  if (e < live) {
    face = s_face[e];
    box = s_box[e];
    owner0 = first_owner(fid, box, wp, lane);
  }
  while (e < live) {
    // The next entry's first owner test, in flight during this entry.
    const int e_next = e + WARPS;
    int face_next = 0, owner_next = -1;
    int4 box_next = make_int4(0, 0, 1, 0);
    if (e_next < live) {
      face_next = s_face[e_next];
      box_next = s_box[e_next];
      owner_next = first_owner(fid, box_next, wp, lane);
    }
    entry(e, face, box, owner0);
    e = e_next;
    face = face_next;
    box = box_next;
    owner0 = owner_next;
  }
}

// Pass 1 for one block: the entries list[0 .. live), live <= SCATTER_CHUNK,
// of tile t; entry i's partial row goes to partial[(row0 + i) * k_cols ..].
// Every thread of the block calls it (it synchronises the block).
__device__ __forceinline__ void scatter_block_rows(
    const int* __restrict__ list, int live, int t, long long row0,
    const int* __restrict__ cull, const int* __restrict__ fid,
    const float* __restrict__ cot, float* __restrict__ partial, int k_cols,
    int hp, int wp, int tile_h, int tile_w) {
  __shared__ int s_face[SCATTER_CHUNK];
  __shared__ int4 s_box[SCATTER_CHUNK];
  stage_entries<SCATTER_THREADS>(list, live, t, cull, wp, tile_h, tile_w,
                                 s_face, s_box);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x - warp * 32;
  const long long plane = (long long)hp * wp;
  walk_entries<SCATTER_WARPS>(
      s_face, s_box, live, fid, wp, warp, lane,
      [&](int e, int face, const int4& box, int owner0) {
        scatter_entry(cot, fid, face, box, owner0, k_cols, wp, plane, lane,
                      partial + (row0 + e) * k_cols);
      });
}

// Pass 2 for one block of SCATTER_REDUCE_THREADS threads: output rows
// [first_row, first_row + 32) below out_rows. Rows of faces (below num_faces)
// sum the face's partial rows over the tiles of its box in ascending tile
// order; other rows are zero. lists(t, &list, &n) gives tile t's ascending
// face list and its length, and returns the row of `partial` that holds the
// list's first entry. Every thread of the block calls it (it synchronises
// the block).
template <class Lists>
__device__ __forceinline__ void reduce_face_rows(
    Lists lists, const int* __restrict__ bbox,
    const float* __restrict__ partial, float* __restrict__ out,
    long long first_row, int num_faces, long long out_rows, int k_cols,
    int tiles_x, int tile_h, int tile_w) {
  constexpr int S = SCATTER_SEARCHES;
  constexpr int P = SCATTER_PIVOTS;
  __shared__ long long s_row[SCATTER_REDUCE_FACES][S];
  const int mine_f = threadIdx.x / S;         // this thread's face and which
  const int mine_u = threadIdx.x - mine_f * S;  // of its tiles each round
  const long long face = first_row + mine_f;
  // The tiles of the box binning used (clipped to the image; empty when
  // max < min).
  int tx0 = 0, ty0 = 0, nx = 1, ny = 0;
  if (face < num_faces) {
    const int4 bb = reinterpret_cast<const int4*>(bbox)[face];
    if (bb.y >= bb.x && bb.w >= bb.z) {
      tx0 = bb.x / tile_w;
      nx = bb.y / tile_w - tx0 + 1;
      ty0 = bb.z / tile_h;
      ny = bb.w / tile_h - ty0 + 1;
    }
  }
  const int tiles_mine = nx * ny;
  float* dst = out + first_row * k_cols;
  const int total = SCATTER_REDUCE_FACES * k_cols;
  int j0 = 0;
  do {
    // This thread's search: the slot of `face` in its tile j0 + mine_u. It
    // keeps [lo, hi]: the ids before lo are below `face`, those from hi on
    // are not. A round probes P evenly spaced slots together (an ascending
    // list: the ids below `face` are a prefix of them) and keeps the one gap
    // that can hold the first id >= face.
    long long row = -1;
    if (j0 + mine_u < tiles_mine) {
      const int j = j0 + mine_u;
      const int jy = j / nx;
      const int* tile_list;
      int n;
      const long long row0 =
          lists((ty0 + jy) * tiles_x + tx0 + (j - jy * nx), &tile_list, &n);
      int lo = 0, hi = n;
      while (lo < hi) {
        const int step = (hi - lo + P) / (P + 1);
        int seen[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int at = lo + (k + 1) * step - 1;
          seen[k] = at < hi ? __ldg(tile_list + at) : INT_MAX;
        }
        int below = 0;
#pragma unroll
        for (int k = 0; k < P; ++k) below += seen[k] < face ? 1 : 0;
        const int next = lo + (below + 1) * step - 1;
        if (below < P && next < hi) hi = next;
        lo += below * step;
      }
      if (lo < n && __ldg(tile_list + lo) == face) row = row0 + lo;
    }
    s_row[mine_f][mine_u] = row;
    __syncthreads();
    // The 32 rows are one contiguous range of 32 * k_cols floats, a thread a
    // float at a time (the same thread every round, so a later round adds to
    // what an earlier one stored); each float sums its face's rows of this
    // round in tile order, their loads in flight together.
    for (int i = threadIdx.x; i < total; i += SCATTER_REDUCE_THREADS) {
      const int f = i / k_cols;
      const int c = i - f * k_cols;
      float v[S];
      bool any = false;
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const long long src = s_row[f][u];
        v[u] = load_if(partial + max(src, 0LL) * k_cols + c, src >= 0);
        any = any || src >= 0;
      }
      if (first_row + f < out_rows && (j0 == 0 || any)) {
        float sum = j0 == 0 ? 0.0f : dst[i];
#pragma unroll
        for (int u = 0; u < S; ++u) sum = sum + v[u];
        dst[i] = sum;
      }
    }
    j0 += S;
  } while (__syncthreads_or(j0 < tiles_mine));
}

}  // namespace dirt
