// Fused packed backward for Hopper (sm_90a): per-entry cotangent rows.
//
// Replaces dirt_tpu/ops/packed_bwd.py::_bwd_packed_kernel (called by
// packed_entry_rows). For every budget row (one face on one 8x16 subtile
// job) it sums raster_bwd.pixel_cotangents_core over the subtile pixels
// that row owns, into out[row] = [9 edge | 3 den | 3C attribute] floats.
//
// Ownership. A covered pixel is owned by exactly one budget row: the row of
// its own (strip, lane group) run whose face is the pixel's fid (a face is
// binned at most once per subtile). The TPU kernel finds it with a 3-pass
// bf16 one-hot matmul that also carries a "ones" column as the covered
// flag; here each thread walks its subtile's live iterations in ascending
// order, compares the staged face ids (entries >> 3) with its fid, and
// reads the owner's 17 geometry columns from the face table directly, at
// row fid (the owner's face is the pixel's fid). A pixel with no owner in
// the live range (background, padding, or an owner outside the chunk
// slice) is not covered and contributes nothing. All of a row's pixels
// therefore lie in its own subtile, which is what lets a block take a few
// subtiles alone.
//
// Work decomposition. One block per subtile (lane group) of one (tile,
// strip), one thread per pixel: 128 threads, four warps of two subtile rows
// each (SUBS takes more subtiles a block). The first version of
// this kernel took the whole 8 x 128 strip in a block of 1,024 threads, one
// block an SM, every __syncthreads holding all of them. The live iterations
// of the strip are [iter_off, iter_off + strip_iters), clamped to the
// tile's n_iters (which drops chunks past the tile's content) and to the
// chunk slice [c_lo, c_hi).
//   pass 1a: the block stages its subtiles' face ids (128 iterations at a
//            time, 4-byte entries 32 bytes apart) and each thread finds its
//            owner, the first match;
//   pass 1b: each thread evaluates the cotangent core for its pixel
//            (cotangent_core.cuh: the expressions of
//            raster_bwd.pixel_cotangents_core, in the same order) and stages
//            its columns in dynamic shared memory ([THREADS][k_n] floats);
//   pass 2:  a counting sort of each subtile's pixels by owner, with warp
//            ballots: a half-warp is 16 pixels of one subtile row, and the
//            lowest lane of each owner's __match_any_sync group writes the
//            owner's 16-bit mask of that row, so each row ends with 8 masks
//            (16 bytes) that list its pixels in the subtile's row-major
//            order. One thread per (row, column) then sums exactly the row's
//            pixels, in that order, and writes the sum: a row that owns six
//            pixels costs one 16-byte load and six adds, where the first
//            version of this kernel read all 128 owner slots of the subtile
//            for every (row, column). The order is the plain version's
//            (one index_add_ per pixel position), and every product, sum and
//            quotient rounds alike (-fmad=false, IEEE division), so the rows
//            equal the plain version's and the first version's bit for bit.
// Column groups. A launch stages at most `cols_per_pass` columns (the
// wrapper's columns_per_pass()); the entry point runs one launch per group
// of columns [k_lo, k_lo + k_n) over the same owners: each launch finds the
// owners and evaluates the core again, stages only its group's columns and
// writes only them, so every column is summed exactly as in a single launch
// and any channel count runs.
// Layouts. With `flat` 0 the per-pixel fields (fid, bits, sval, pix, grad)
// are in image layout, as the neighbour prologue writes them. With `flat` 1
// they are in flat-subtile layout (subtile_swap.cu: pixel (r, 16 g + c) of a
// strip lies at row g, column 16 r + c), as the sharded halo backward hands
// them over; only the address a thread reads its pixel at differs.
// Every row is written by the one block whose run holds it; rows no run
// reaches (padding, rows past n_iters, empty chunks) keep the zeros the
// wrapper allocated, since the reduce gathers rows by backpointer.
//
// What bounds it: by count, bytes (the per-pixel planes once, the live rows'
// entries, the owners' geometry columns, the rows written once). In
// practice, latency: timed with one pass cut out at a time
// (tools/bench_raster_ab.py --kernels K2; bench sphere, 1024^2, C = 3,
// NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), the first version
// spent two thirds of its time in pass 2 (0.0875 of 0.1332 ms) and a fifth
// in pass 1b; this one takes 0.0552 ms,
// about 40% in pass 2 (each row's chain of dependent shared loads and adds,
// kept in order for the bits), 40% in pass 1b (the core and its loads) and
// the rest in pass 1a (the serial owner walk, ~20 iterations a strip) and
// the block's set-up. Built with -fmad=false and IEEE division.

#include <cuda_runtime.h>

#include "cotangent_core.cuh"

namespace {

// Tuning constants, what the timings on the H100 chose
// (tools/bench_raster_ab.py --kernels K2, PERF.md): the subtiles a block
// takes (1, 2, 4 or 8), and the blocks an SM the kernel is compiled to
// hold, for up to 3 channels and for more.
constexpr int SUBS = 1;
constexpr int BLOCKS_FEW = 12;
constexpr int BLOCKS = 8;

constexpr int SUB_H = 8;
constexpr int SUB_W = 16;
constexpr int GROUPS = 8;
constexpr int TILE_W = GROUPS * SUB_W;        // 128
constexpr int PACK_ITERS = 64;
constexpr int PACK_CHUNK = PACK_ITERS * GROUPS;
constexpr int BLOCK_W = SUBS * SUB_W;         // pixel columns of a block
constexpr int THREADS = SUB_H * BLOCK_W;
constexpr int STAGE = 128;                    // iterations per round
constexpr unsigned FULL = 0xffffffffu;
// The ids and the masks: the static shared memory of a block.
constexpr int STATIC_SMEM = STAGE * SUBS * (4 + 2 * SUB_H);
static_assert(GROUPS % SUBS == 0, "a block takes whole lane groups");

template <int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
packed_bwd_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ entries, const int* __restrict__ start_block,
    const int* __restrict__ n_iters, const int* __restrict__ iter_off,
    const int* __restrict__ strip_iters,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, float* __restrict__ out,
    int channels, int hp, int wp, int tile_h, int tiles_x, int c_lo,
    int c_hi, int k_lo, int k_n, int flat) {
  extern __shared__ float cot[];              // [THREADS][k_n]
  __shared__ int ids[STAGE * SUBS];           // [iteration][subtile]
  // [iteration][subtile][subtile row]: the row's pixels of that subtile row.
  __shared__ __align__(16) unsigned short masks[STAGE * SUBS * SUB_H];
  const int k_cols = 12 + 3 * channels;

  const int strips = tile_h / SUB_H;
  const int ts = blockIdx.x / (GROUPS / SUBS);  // t * strips + s
  const int g0 = (blockIdx.x - ts * (GROUPS / SUBS)) * SUBS;
  const int t = ts / strips;
  const int s = ts - t * strips;
  const int sb = start_block[t];
  const int lo = max(iter_off[ts], (c_lo - sb) * PACK_ITERS);
  const int hi = min(min(iter_off[ts] + strip_iters[ts], n_iters[t]),
                     (c_hi - sb) * PACK_ITERS);
  if (lo >= hi) return;                       // block-uniform
  const int n_it = hi - lo;
  // Budget row of iteration j (from lo) of lane group g: row0 + 8 j + g.
  const long long row0 = ((long long)sb * PACK_ITERS + lo) * GROUPS;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid / BLOCK_W;                // subtile row
  const int c = tid - r * BLOCK_W;
  const int gl = c / SUB_W;                   // subtile of the block
  const int pc = c - gl * SUB_W;              // == lane & 15
  const int g = g0 + gl;
  const int x0 = (t % tiles_x) * TILE_W;
  const int y0 = (t / tiles_x) * tile_h + s * SUB_H;
  const int x = x0 + g * SUB_W + pc;
  const int y = y0 + r;
  const long long plane = (long long)hp * wp;
  const long long p =
      flat ? (long long)(y0 + g) * wp + x0 + r * SUB_W + pc
           : (long long)y * wp + x;

  // ---- pass 1a: the owning iteration (first match in ascending order) ---
  const int f = fid[p];
  int own = -1;                               // iteration from lo
  for (int i0 = 0; i0 < n_it; i0 += STAGE) {
    const int n = min(STAGE, n_it - i0);
    __syncthreads();                          // previous stage consumed
    for (int k = tid; k < n * SUBS; k += THREADS) {
      const int j = k / SUBS;
      ids[k] = __ldg(entries + row0 + (long long)(i0 + j) * GROUPS + g0 +
                     (k - j * SUBS)) >> 3;
    }
    __syncthreads();
    if (own < 0) {
      for (int j = 0; j < n; ++j) {
        if (ids[j * SUBS + gl] == f) {
          own = i0 + j;
          break;
        }
      }
    }
  }

  // ---- pass 1b: the pixel's cotangents (pixel_cotangents_core) ----------
  if (own >= 0) {
    const float* m = table + (long long)f * width;
    float* my = cot + tid * k_n;
    const float dx = ((float)x + 0.5f) - m[0];
    const float dy = ((float)y + 0.5f) - m[1];
    dirt::pixel_cotangents(m, dx, dy, channels, grad, pix, plane, p, bits[p],
                           sval, [my, k_lo, k_n](int k, float v) {
                             const int kk = k - k_lo;
                             if (kk >= 0 && kk < k_n) my[kk] = v;
                           });
  }

  // ---- pass 2: each row sums its own pixels, in pixel order --------------
  float* dst = out + (row0 - (long long)c_lo * PACK_CHUNK) * k_cols + k_lo;
  for (int j0 = 0; j0 < n_it; j0 += STAGE) {
    const int n = min(STAGE, n_it - j0);
    unsigned* words = reinterpret_cast<unsigned*>(masks);
    for (int k = tid; k < n * SUBS * SUB_H / 2; k += THREADS) words[k] = 0u;
    __syncthreads();                          // cot staged; masks cleared
    // A half-warp holds 16 pixels of one subtile row; the lowest lane of
    // each owner's group writes the owner's mask of that row.
    const int mine = own >= j0 && own < j0 + n ? own - j0 : -1;
    const unsigned same = __match_any_sync(FULL, mine);
    const unsigned half = (same >> (lane & 16)) & 0xffffu;
    if (mine >= 0 && (int)(__ffs(half) - 1) == pc) {
      masks[(mine * SUBS + gl) * SUB_H + r] = (unsigned short)half;
    }
    __syncthreads();
    for (int task = tid; task < n * SUBS * k_n; task += THREADS) {
      const int row = task / k_n;             // j * SUBS + subtile
      const int k = task - row * k_n;
      const int sub = row % SUBS;
      const uint4 list = reinterpret_cast<const uint4*>(masks)[row];
      const unsigned half_words[4] = {list.x, list.y, list.z, list.w};
      float sum = 0.0f;
#pragma unroll
      for (int pr = 0; pr < SUB_H; ++pr) {
        unsigned mask = (half_words[pr >> 1] >> (16 * (pr & 1))) & 0xffffu;
        const float* src = cot + (pr * BLOCK_W + sub * SUB_W) * k_n + k;
        while (mask) {
          const int pcol = __ffs(mask) - 1;
          mask &= mask - 1;
          sum = sum + src[pcol * k_n];
        }
      }
      const int j = j0 + row / SUBS;
      dst[((long long)j * GROUPS + g0 + sub) * k_cols + k] = sum;
    }
    __syncthreads();                          // masks consumed
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `table` is [F + 1, width] floats, every entry >> 3 a row of it;
// `out` holds (c_hi - c_lo) * 512 zeroed rows of 12 + 3C floats.
// `cols_per_pass` >= 1 is the most columns one launch may stage; the
// 12 + 3C columns run in ceil((12 + 3C) / cols_per_pass) launches. `flat`
// says which layout the per-pixel fields are in (0 image, 1 flat-subtile).
// The launches go on `stream` and do not synchronise. Returns the first
// CUDA error code (0 on success).
extern "C" int dirt_packed_bwd(
    const float* table, int width, const int* entries,
    const int* start_block, const int* n_iters,
    const int* iter_off, const int* strip_iters,
    const int* fid, const int* bits, const float* sval, const float* pix,
    const float* grad, float* out, int channels, int hp, int wp,
    int tile_h, int c_lo, int c_hi, int cols_per_pass, int flat,
    void* stream) {
  const int tiles_x = wp / TILE_W;
  const int blocks =
      (hp / tile_h) * tiles_x * (tile_h / SUB_H) * (GROUPS / SUBS);
  const int k_cols = 12 + 3 * channels;
  if (cols_per_pass < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int widest = k_cols < cols_per_pass ? k_cols : cols_per_pass;
  const int smem = THREADS * widest * (int)sizeof(float);
  // Few channels: the core is short, and latency counts more than the
  // registers an instance compiled for more blocks an SM spills.
  const auto kernel = channels <= 3 ? packed_bwd_kernel<BLOCKS_FEW>
                                    : packed_bwd_kernel<BLOCKS>;
  if (smem + STATIC_SMEM > 48 * 1024) {       // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0 && c_hi > c_lo) {
    for (int k_lo = 0; k_lo < k_cols; k_lo += cols_per_pass) {
      const int k_n =
          cols_per_pass < k_cols - k_lo ? cols_per_pass : k_cols - k_lo;
      kernel<<<blocks, THREADS, THREADS * k_n * (int)sizeof(float),
               static_cast<cudaStream_t>(stream)>>>(
          table, width, entries, start_block, n_iters, iter_off, strip_iters,
          fid, bits, sval, pix, grad, out, channels, hp, wp, tile_h, tiles_x,
          c_lo, c_hi, k_lo, k_n, flat);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
