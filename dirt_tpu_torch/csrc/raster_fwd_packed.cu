// Packed-engine forward rasterizer for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package on the forward path:
//   * dirt_tpu/ops/raster_fwd.py::_fwd_packed_kernel (the packed forward),
//   * dirt_tpu/ops/raster_fwd.py::flat_subtile_swap_pallas, which the TPU
//     path runs on the background going in and on the three outputs coming
//     out. This kernel reads the background and writes pixels, face ids and
//     depth in image layout, so both swaps disappear: it computes
//     flat_subtile_swap o _fwd_packed_kernel o flat_subtile_swap.
//
// Work decomposition. One warp per job stream: the 8 x 16 pixels of one
// (tile, strip, lane group), four consecutive pixels of one row a lane
// (lane l: row l / 4, columns 4 (l % 4) .. + 3). The warp walks its strip's
// contiguous run of iterations [iter_off, iter_off + strip_iters), clamped
// to the tile's n_iters, in ascending order; iteration i's job is budget
// row r = (start_block * PACK_ITERS + i) * GROUPS + g, face entries[r] >> 3,
// whose row the warp reads from the face table where it lies (no copy of
// the table in budget-row order is made). Ascending order plus the strict
// z < zbuf test keeps the rule that a depth tie goes to the lower face id.
// The 4 warps of a block are 4 of the 8 groups of one (tile, strip); they
// share nothing and never wait on each other (__syncwarp only). On the
// H100, blocks of 4 warps ran 5-13% faster than blocks of a strip's 8 and
// as fast as blocks of 1 or 2; stages of 16 jobs, and a cap of 40
// registers (12 blocks an SM, which spills), were slower.
//
// The loop only runs the coverage and depth test and remembers the
// winning face; the perspective reciprocal and the C attribute planes are
// evaluated once per pixel, from the winner's table row, after the loop.
// The expressions are the TPU kernel's (raster_fwd.py:482-503) in the same
// operation order: the products m3 dy, m6 dy, m9 dy, m12 dy, the same for
// a lane's four pixels, are taken once per job, which rounds alike. Built
// with -fmad=false (no multiply-add contraction) and IEEE division, so fid,
// zbuf and pixels equal its plain PyTorch version bit for bit.
//
// What bounds it: the per-pixel iteration count (11 per strip on average
// on the 10k-face sphere at 1024^2) times ~22 flops, plus writing the
// (C + 2) output planes once; on the card the test loop took 78% of the
// first version's time at C = 3, the epilogue 17% (42% at C = 16). Each
// warp stages STAGE jobs' coefficient columns 0..15 at a time in its own
// shared memory and reads each job's as four 16-byte broadcasts, one set
// for its four pixels a lane; outputs and the background move as 16-byte
// vectors. A job's row is a dependent read (its entry, then 64 bytes of
// its face's row, anywhere in the table: the rows are 16-byte aligned,
// packed_table_width pads to 8 columns), so the stages are pipelined: lane
// l reads the entry of job l two stages ahead, and four lanes a job copy
// the next stage's columns 0..15 into the warp's second buffer (cp.async,
// no register held) while the current stage is tested. On the H100 a
// third buffer, and copies that bypass L1, were no faster.

#include <cuda_runtime.h>

namespace {

constexpr int SUB_H = 8;
constexpr int SUB_W = 16;
constexpr int GROUPS = 8;
constexpr int TILE_W = GROUPS * SUB_W;        // 128
constexpr int PACK_ITERS = 64;
constexpr int WARPS = 4;                      // warps (job streams) a block
constexpr int THREADS = 32 * WARPS;
constexpr int LANE_PIX = 4;                   // consecutive pixels a lane
constexpr int STAGE = 32;                     // jobs a warp stages at a time
constexpr int COL_ID = 17;
constexpr int COL_ATT = 19;
constexpr float BIG_Z = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes from global to shared memory without a register (cp.async,
// through L1: the 4 warps of a block are neighbouring groups of one strip,
// which share many faces), and the group fences around such copies.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void copies_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy columns 0..15 of the table rows of a stage's first n jobs into
// `dst`: lane l holds the face of job l; four lanes a job, eight jobs a
// round, and every lane takes each shuffle.
__device__ __forceinline__ void stage_rows(float4 (*dst)[4],
                                           const float* __restrict__ table,
                                           int width, int face_l, int n,
                                           int lane) {
#pragma unroll
  for (int q0 = 0; q0 < 4 * STAGE; q0 += 32) {
    const int j = (q0 + lane) >> 2;
    const int face = __shfl_sync(FULL, face_l, j);
    if (j < n) {
      copy16(&dst[j][lane & 3],
             table + (size_t)face * width + 4 * (lane & 3));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
raster_fwd_packed_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ entries,
    const int* __restrict__ start_block, const int* __restrict__ n_iters,
    const int* __restrict__ iter_off, const int* __restrict__ strip_iters,
    const float* __restrict__ bg, float* __restrict__ pix,
    int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp, int tile_h, int tiles_x) {
  // Columns 0..15 of STAGE jobs, per warp, in two buffers: the next
  // stage's rows are copied into one while the other's are tested.
  __shared__ float4 stage[WARPS][2][STAGE][4];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * WARPS + warp;  // (t * strips + s) * G + g
  const int ts = job / GROUPS;
  const int g = job - ts * GROUPS;
  const int strips = tile_h / SUB_H;
  const int t = ts / strips;
  const int s = ts - t * strips;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int x0 = tx * TILE_W + g * SUB_W + (lane & 3) * LANE_PIX;
  const int y = ty * tile_h + s * SUB_H + (lane >> 2);
  const float yf = (float)y + 0.5f;
  float xf[LANE_PIX];
#pragma unroll
  for (int k = 0; k < LANE_PIX; ++k) xf[k] = (float)(x0 + k) + 0.5f;

  const int lo = iter_off[ts];
  const int hi = min(lo + strip_iters[ts], n_iters[t]);
  const int row0 = start_block[t] * PACK_ITERS;
  float4 (*st)[STAGE][4] = stage[warp];

  float zb[LANE_PIX];
  int best[LANE_PIX];                          // winning face
#pragma unroll
  for (int k = 0; k < LANE_PIX; ++k) {
    zb[k] = BIG_Z;
    best[k] = -1;
  }
  // Lane l holds the entry of job l of the current stage (STAGE == 32)
  // and of the next one.
  int entry = lo + lane < hi
                  ? __ldg(entries + (row0 + lo + lane) * GROUPS + g) : 0;
  int entry_next =
      lo + STAGE + lane < hi
          ? __ldg(entries + (row0 + lo + STAGE + lane) * GROUPS + g) : 0;
  if (lo < hi) {
    stage_rows(st[0], table, width, entry >> 3, min(STAGE, hi - lo), lane);
  }
  copies_commit();
  for (int i0 = lo, buf = 0; i0 < hi; i0 += STAGE, buf ^= 1) {
    const int n = min(STAGE, hi - i0);
    const int face_l = entry >> 3;
    // The next stage's rows go into the other buffer (consumed at the end
    // of the previous stage), and the entries of the stage after it are
    // read, while this stage is tested.
    if (i0 + STAGE < hi) {
      stage_rows(st[buf ^ 1], table, width, entry_next >> 3,
                 min(STAGE, hi - i0 - STAGE), lane);
    }
    copies_commit();
    entry = entry_next;
    const int ahead = i0 + 2 * STAGE + lane;
    entry_next = ahead < hi ? __ldg(entries + (row0 + ahead) * GROUPS + g)
                            : 0;
    copies_wait_all_but_one();                 // this stage's rows are in
    __syncwarp();
    const float4 (*cur)[4] = st[buf];
    for (int j = 0; j < n; ++j) {
      // a = m0..m3, b = m4..m7, c = m8..m11, d = m12..m15.
      const float4 a = cur[j][0], b = cur[j][1];
      const float4 c = cur[j][2], d = cur[j][3];
      const float dy = yf - a.y;
      const float m3dy = a.w * dy, m6dy = b.z * dy;
      const float m9dy = c.y * dy, m12dy = d.x * dy;
      const int face = __shfl_sync(FULL, face_l, j);
#pragma unroll
      for (int k = 0; k < LANE_PIX; ++k) {
        const float dx = xf[k] - a.x;
        const float e0 = a.z * dx + m3dy + b.x;   // m2 dx + m3 dy + m4
        const float e1 = b.y * dx + m6dy + b.w;   // m5 dx + m6 dy + m7
        const float e2 = c.x * dx + m9dy + c.z;   // m8 dx + m9 dy + m10
        const float zv = c.w * dx + m12dy + d.y;  // m11 dx + m12 dy + m13
        // min(e0, e1, e2) >= 0, NaN-safe like jnp.minimum: any NaN fails.
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zv < zb[k] &&
            zv >= -1.0f && zv <= 1.0f) {
          zb[k] = zv;
          best[k] = face;
        }
      }
    }
    __syncwarp();                              // this buffer consumed
  }

  const int plane = hp * wp;
  const int p = y * wp + x0;
  *reinterpret_cast<float4*>(zbuf + p) = make_float4(zb[0], zb[1], zb[2],
                                                     zb[3]);
  const float* m[LANE_PIX];
  float dx[LANE_PIX], dy[LANE_PIX], recip[LANE_PIX];
  int ids[LANE_PIX];
  bool missed = false;
#pragma unroll
  for (int k = 0; k < LANE_PIX; ++k) {
    ids[k] = -1;
    m[k] = table;
    dx[k] = dy[k] = recip[k] = 0.0f;
    if (best[k] >= 0) {
      m[k] = table + (size_t)best[k] * width;
      dx[k] = xf[k] - m[k][0];
      dy[k] = yf - m[k][1];
      const float den = m[k][14] * dx[k] + m[k][15] * dy[k] + m[k][16];
      recip[k] = 1.0f / den;
      ids[k] = (int)m[k][COL_ID];
    } else {
      missed = true;
    }
  }
  *reinterpret_cast<int4*>(fid + p) = make_int4(ids[0], ids[1], ids[2],
                                                ids[3]);
  for (int ch = 0; ch < channels; ++ch) {
    float4 back = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (missed) {
      back = __ldg(reinterpret_cast<const float4*>(bg + ch * plane + p));
    }
    const float bk[LANE_PIX] = {back.x, back.y, back.z, back.w};
    float v[LANE_PIX];
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) {
      const float* at = m[k] + COL_ATT + 3 * ch;
      v[k] = best[k] >= 0 ? (at[0] * dx[k] + at[1] * dy[k] + at[2]) * recip[k]
                          : bk[k];
    }
    *reinterpret_cast<float4*>(pix + ch * plane + p) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers, `table` ([F + 1, width] floats, every entry >> 3 a row of it),
// `bg`, `pix`, `fid` and `zbuf` 16-byte aligned, `width` a multiple of 4;
// the launch goes on `stream` and does not synchronise. Returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int dirt_raster_fwd_packed(
    const float* table, int width, const int* entries,
    const int* start_block, const int* n_iters,
    const int* iter_off, const int* strip_iters,
    const float* bg, float* pix, int* fid, float* zbuf,
    int channels, int hp, int wp, int tile_h, void* stream) {
  const int tiles_x = wp / TILE_W;
  const int jobs = (hp / tile_h) * tiles_x * (tile_h / SUB_H) * GROUPS;
  if (jobs > 0) {
    raster_fwd_packed_kernel<<<jobs / WARPS, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        table, width, entries, start_block, n_iters, iter_off, strip_iters,
        bg, pix, fid, zbuf, channels, hp, wp, tile_h, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
