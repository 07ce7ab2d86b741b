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
// flag; here each thread walks its group's live iterations in ascending
// order, compares the staged face ids with its fid, and reads the owning
// row's 17 geometry columns directly. A pixel with no owner in the live
// range (background, padding, or an owner outside the chunk slice) is not
// covered and contributes nothing.
//
// Work decomposition. One block per (tile, strip), one thread per pixel of
// the 8x128 strip, as in raster_fwd_packed.cu. The live iterations of the
// strip are [iter_off, iter_off + strip_iters), clamped to the tile's
// n_iters (which drops chunks past the tile's content) and to the chunk
// slice [c_lo, c_hi).
//   pass 1: each thread finds its owner, evaluates the cotangent core
//           (cotangent_core.cuh: the expressions of
//           raster_bwd.pixel_cotangents_core, in the same order) and stages
//           its 12 + 3C values and its owner in dynamic shared memory
//           (1024 * (13 + 3C) floats: 88 KB at C = 3, 160 KB at C = 9; the
//           card's opt-in shared memory per block caps C, see
//           packed_bwd.max_channels);
//   pass 2: one thread per (live row, column) sums that column over the
//           row's group pixels it owns, in the subtile's row-major pixel
//           order, and writes it. The fixed order makes the kernel
//           deterministic and equal to the plain version's ordered sums.
// Every row is written by the one block whose run holds it; rows no run
// reaches (padding, rows past n_iters, empty chunks) keep the zeros the
// wrapper allocated, since the reduce gathers rows by backpointer.
//
// What bounds it: the per-pixel walk over the strip's run (~20 iterations
// per strip on the 10k-face bench sphere at 1024^2) and the row reads; the
// 19.6 MB `rows` table is the largest input, read once for the face ids
// and again, through the cache, for each owner's 17 columns. Pass 2 reads
// shared memory only. Built with -fmad=false and IEEE division, so every
// product, sum and quotient rounds like the plain PyTorch version.

#include <cuda_runtime.h>

#include "cotangent_core.cuh"

namespace {

constexpr int SUB_H = 8;
constexpr int SUB_W = 16;
constexpr int GROUPS = 8;
constexpr int TILE_W = GROUPS * SUB_W;        // 128
constexpr int PACK_ITERS = 64;
constexpr int PACK_CHUNK = PACK_ITERS * GROUPS;
constexpr int THREADS = SUB_H * TILE_W;       // 1024
constexpr int COL_ID = 17;
constexpr int STAGE = 128;                    // iterations per id stage

__global__ void __launch_bounds__(THREADS)
packed_bwd_kernel(
    const float* __restrict__ rows, int width,
    const int* __restrict__ start_block, const int* __restrict__ n_iters,
    const int* __restrict__ iter_off, const int* __restrict__ strip_iters,
    const int* __restrict__ fid, const int* __restrict__ bits,
    const float* __restrict__ sval, const float* __restrict__ pix,
    const float* __restrict__ grad, float* __restrict__ out,
    int channels, int hp, int wp, int tile_h, int tiles_x, int c_lo,
    int c_hi) {
  extern __shared__ float smem[];
  __shared__ float ids[STAGE * GROUPS];
  const int k_cols = 12 + 3 * channels;
  int* owner = reinterpret_cast<int*>(smem);  // [THREADS] local row or -1
  float* cot = smem + THREADS;                // [THREADS][k_cols]

  const int strips = tile_h / SUB_H;
  const int ts = blockIdx.x;                  // t * strips + s
  const int t = ts / strips;
  const int s = ts - t * strips;
  const int sb = start_block[t];
  const int lo = max(iter_off[ts], (c_lo - sb) * PACK_ITERS);
  const int hi = min(min(iter_off[ts] + strip_iters[ts], n_iters[t]),
                     (c_hi - sb) * PACK_ITERS);
  if (lo >= hi) return;                       // block-uniform
  const long long row0 = ((long long)sb * PACK_ITERS + lo) * GROUPS;

  const int tid = threadIdx.x;
  const int r = tid / TILE_W;
  const int c = tid - r * TILE_W;
  const int g = c / SUB_W;
  const int x = (t % tiles_x) * TILE_W + c;
  const int y = (t / tiles_x) * tile_h + s * SUB_H + r;
  const long long plane = (long long)hp * wp;
  const long long p = (long long)y * wp + x;

  // ---- pass 1a: the owning row (first match in ascending order) ----------
  const float f = (float)fid[p];
  int own = -1;                               // (i - lo) * GROUPS + g
  for (int i0 = lo; i0 < hi; i0 += STAGE) {
    const int n = min(STAGE, hi - i0);
    __syncthreads();                          // previous stage consumed
    const float* src = rows + (row0 + (long long)(i0 - lo) * GROUPS) * width;
    for (int k = tid; k < n * GROUPS; k += THREADS) {
      ids[k] = src[(long long)k * width + COL_ID];
    }
    __syncthreads();
    if (own < 0) {
      for (int j = 0; j < n; ++j) {
        if (ids[j * GROUPS + g] == f) {
          own = (i0 - lo + j) * GROUPS + g;
          break;
        }
      }
    }
  }
  owner[tid] = own;

  // ---- pass 1b: the pixel's cotangents (pixel_cotangents_core) ----------
  if (own >= 0) {
    const float* m = rows + (row0 + own) * width;
    float* my = cot + tid * k_cols;
    const float dx = ((float)x + 0.5f) - m[0];
    const float dy = ((float)y + 0.5f) - m[1];
    dirt::pixel_cotangents(m, dx, dy, channels, grad, pix, plane, p, bits[p],
                           sval, [my](int k, float v) { my[k] = v; });
  }
  __syncthreads();

  // ---- pass 2: each live row sums its owned pixels, in pixel order -------
  const int n_rows = (hi - lo) * GROUPS;
  float* dst = out + (row0 - (long long)c_lo * PACK_CHUNK) * k_cols;
  for (int task = tid; task < n_rows * k_cols; task += THREADS) {
    const int row = task / k_cols;
    const int k = task - row * k_cols;
    const int base = (row % GROUPS) * SUB_W;
    float sum = 0.0f;
    for (int pr = 0; pr < SUB_H; ++pr) {
      for (int pc = 0; pc < SUB_W; ++pc) {
        const int q = pr * TILE_W + base + pc;
        if (owner[q] == row) sum = sum + cot[q * k_cols + k];
      }
    }
    dst[(long long)row * k_cols + k] = sum;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `out` holds (c_hi - c_lo) * 512 zeroed rows of 12 + 3C floats.
// The launch goes on `stream` and does not synchronise. Returns the
// cudaGetLastError() code (0 on success).
extern "C" int dirt_packed_bwd(
    const float* rows, int width,
    const int* start_block, const int* n_iters,
    const int* iter_off, const int* strip_iters,
    const int* fid, const int* bits, const float* sval, const float* pix,
    const float* grad, float* out, int channels, int hp, int wp,
    int tile_h, int c_lo, int c_hi, void* stream) {
  const int tiles_x = wp / TILE_W;
  const int blocks = (hp / tile_h) * tiles_x * (tile_h / SUB_H);
  const int smem = THREADS * (1 + 12 + 3 * channels) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      packed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0 && c_hi > c_lo) {
    packed_bwd_kernel<<<blocks, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        rows, width, start_block, n_iters, iter_off, strip_iters, fid, bits,
        sval, pix, grad, out, channels, hp, wp, tile_h, tiles_x, c_lo, c_hi);
  }
  return static_cast<int>(cudaGetLastError());
}
