// Streaming (CSR) forward rasterizer for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/raster_fwd.py::_fwd_csr_kernel (called by
// raster_forward_csr): for every image tile, the faces of the tile's CSR run
// entry_face[start_block[t] * 128 + i], i < counts[t], are scan-converted in
// ascending face id with a z-buffer: three edge planes >= 0, the depth plane
// strictly below the buffer and inside [-1, 1]; the winner's C attribute
// planes times the perspective reciprocal 1 / den give the pixel.
//
// What the TPU kernel does that this one does not. The TPU kernel cannot
// gather inside the kernel, so it streams a pre-gathered copy of the face
// table in CSR order (table[entry_face], one row per listed pair) in
// 128-row chunks, one grid step per (tile, chunk) up to a static chunk
// bound, and carries depth, ids and pixels from chunk to chunk through its
// output blocks. Here a block gathers the rows of the faces it keeps from
// the face table itself, and loops over the tile's whole run to counts[t]:
// no pre-gathered copy, no revisited outputs, no static chunk bound, and the
// sentinel slots behind a run are never read.
//
// Work decomposition: raster_tile.cuh's two launches, shared with the dense
// kernel. First one thread per face table row works out the row's cull_box:
// the pixels where the face can pass the edge tests, rounding included;
// the boxes go back to the caller, for the backward. Then the culled strip
// walk: one block of 512 threads per 4-row strip of a tile,
// one thread per pixel; the run is read 512 entries at a time with each
// face's box, only the faces whose boxes meet the strip are kept (in run
// order) and gathered, and a warp (4 rows x 8 columns) tests only the kept
// faces whose boxes meet it.
//
// What bounds it. On a 100k-face mesh a tile lists thousands of faces of a
// few pixels each. Testing every listed face at every pixel of the tile, as
// the walk without the cull does, was ~150x the function's bound; with the
// cull a pixel tests ~14 faces, not ~900. What is left (PERF.md, section
// 6): each block's chain of dependent loads per batch (entry, box,
// coefficients) with a block barrier between, and the few tiles of the
// sphere's poles, which list thousands of faces and run longest. 4-row
// strips of 512 threads beat 8-row strips of 1024; prefetching the next
// batch's entries, two pixels a thread, one block for two strips and
// launching the heaviest tiles first did not pay.

#include <cuda_runtime.h>

#include "raster_tile.cuh"

namespace {

constexpr int CHUNK = 128;                    // rows per CSR block

__global__ void __launch_bounds__(dirt::CULL_ROWS * dirt::SEG_W)
raster_fwd_csr_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const int4* __restrict__ boxes,
    const float* __restrict__ bg, float* __restrict__ pix,
    int* __restrict__ fid, float* __restrict__ zbuf, int channels, int hp,
    int wp, int tile_h, int tile_w) {
  const int t = dirt::culled_tile(blockIdx.x, tile_h, tile_w);
  dirt::raster_strip_culled(table, width,
                            entry_face + (long long)start_block[t] * CHUNK,
                            counts[t], boxes, bg, pix, fid, zbuf, channels,
                            hp, wp, tile_h, tile_w, t);
}

}  // namespace

// Plain C entry points (bound with ctypes). All pointers are device
// pointers; `table` is [rows, width] f32, `boxes` [rows, 4] int32 and
// 16-byte aligned. Launches go on `stream` and do not synchronise. Each
// returns the cudaGetLastError() code of its launches (0 on success).

// Writes the cull_box of every table row of an hp x wp array into `boxes`.
extern "C" int dirt_csr_cull_boxes(const float* table, int width, int rows,
                                   int* boxes, int hp, int wp,
                                   void* stream) {
  dirt::launch_cull_boxes(table, width, rows, boxes, hp, wp,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The forward: `entry_face` [n_pad] int32, `start_block` (in 128-row
// blocks) and `counts` [tiles] int32; `boxes` is written by the first
// launch (the cull_box of every table row) and read by the walk. tile_h is
// a multiple of 8 and tile_w at most 128 or a multiple of 128 (the wrapper
// checks).
extern "C" int dirt_raster_fwd_csr(
    const float* table, int width, int rows, const int* entry_face,
    const int* start_block, const int* counts, int* boxes, const float* bg,
    float* pix, int* fid, float* zbuf, int channels, int hp, int wp,
    int tile_h, int tile_w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dirt::launch_cull_boxes(table, width, rows, boxes, hp, wp, s);
  const int blocks = dirt::culled_blocks(hp, wp, tile_h, tile_w);
  if (blocks > 0) {
    raster_fwd_csr_kernel<<<blocks, dirt::culled_threads(tile_w), 0, s>>>(
        table, width, entry_face, start_block, counts,
        reinterpret_cast<const int4*>(boxes), bg, pix, fid, zbuf, channels,
        hp, wp, tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
