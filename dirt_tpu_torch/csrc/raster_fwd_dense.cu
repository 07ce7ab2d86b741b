// Dense whole-tile forward rasterizer for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/raster_fwd.py::_fwd_kernel (called by
// raster_forward): for every image tile, the tile's binned faces
// bins[t, 0 .. counts[t]) are scan-converted in ascending face id with a
// z-buffer: three edge planes >= 0, the depth plane strictly below the
// buffer and inside [-1, 1]; the winner's C attribute planes times the
// perspective reciprocal 1 / den give the pixel.
//
// What the TPU kernel does that this one does not. The TPU kernel keeps the
// whole face table resident in its fast memory and walks one tile per
// sequential grid step, testing every binned face at every pixel of the
// tile. Here blocks run in parallel over strips of tiles, and each strip
// tests only the listed faces that can pass there.
//
// Work decomposition: raster_tile.cuh's two launches, the streaming
// kernel's over the dense bins. First one thread per face table row works
// out the row's cull_box (the pixels where the face can pass the edge
// tests, rounding included; cull_box reads only the row, so the dense table
// serves as it is, its sentinel rows included, which pass nowhere); the
// boxes go back to the caller, for the backward. Then raster_strip_culled
// over bins + t * cap, counts[t]: one block of up to 512 threads per 4-row
// strip of a tile, one thread per pixel; the list is read 512 entries at a
// time with each face's box, only the faces whose boxes meet the strip are
// kept (in list order) and gathered, and a warp (4 rows x 8 columns) tests
// only the kept faces whose boxes meet it. The walk runs to counts[t] and
// never reads the sentinel slots behind it, so the result does not depend
// on the cap.
//
// What bounds it. Testing every face binned to a tile at every pixel of the
// tile, as the walk without the cull does, was 26-69x the function's bound
// (PERF.md, section 6); with the cull a pixel tests a few faces, and what
// is left is each block's chain of dependent loads per batch (entry, box,
// coefficients) and, at small images, the launches.

#include <cuda_runtime.h>

#include "raster_tile.cuh"

namespace {

__global__ void __launch_bounds__(dirt::CULL_ROWS * dirt::SEG_W)
raster_fwd_dense_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ bins, const int* __restrict__ counts, int cap,
    const int4* __restrict__ boxes, const float* __restrict__ bg,
    float* __restrict__ pix, int* __restrict__ fid,
    float* __restrict__ zbuf, int channels, int hp, int wp, int tile_h,
    int tile_w) {
  const int t = dirt::culled_tile(blockIdx.x, tile_h, tile_w);
  dirt::raster_strip_culled(table, width, bins + (long long)t * cap,
                            counts[t], boxes, bg, pix, fid, zbuf, channels,
                            hp, wp, tile_h, tile_w, t);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `table` is [rows, width] f32, `bins` [tiles, cap] int32 and
// `counts` [tiles] int32; `boxes` [rows, 4] int32, 16-byte aligned, is
// written by the first launch (the cull_box of every table row) and read
// by the walk. tile_h is a multiple of 8 and tile_w at most 128 or a
// multiple of 128 (the wrapper checks). The launches go on `stream` and do
// not synchronise. Returns the cudaGetLastError() code of the launches (0
// on success).
extern "C" int dirt_raster_fwd_dense(
    const float* table, int width, int rows, const int* bins,
    const int* counts, int cap, int* boxes, const float* bg, float* pix,
    int* fid, float* zbuf, int channels, int hp, int wp, int tile_h,
    int tile_w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dirt::launch_cull_boxes(table, width, rows, boxes, hp, wp, s);
  const int blocks = dirt::culled_blocks(hp, wp, tile_h, tile_w);
  if (blocks > 0) {
    raster_fwd_dense_kernel<<<blocks, dirt::culled_threads(tile_w), 0, s>>>(
        table, width, bins, counts, cap,
        reinterpret_cast<const int4*>(boxes), bg, pix, fid, zbuf, channels,
        hp, wp, tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
