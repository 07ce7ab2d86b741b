// Dense whole-tile forward rasterizer for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/raster_fwd.py::_fwd_kernel (called by
// raster_forward): for every image tile, the tile's binned faces
// bins[t, 0 .. counts[t]) are scan-converted in ascending face id with a
// z-buffer: three edge planes >= 0, the depth plane strictly below the
// buffer and inside [-1, 1]; the winner's C attribute planes times the
// perspective reciprocal 1 / den give the pixel.
//
// Work decomposition. The TPU kernel keeps the whole face table resident in
// its fast memory and walks one tile per sequential grid step. Here one
// block takes an 8-row strip of one tile (a 128-column segment of it when
// the tile is wider), one thread per pixel, so a 256^2 image gives 64 blocks
// and a 1024^2 image 1024; the walk itself is raster_tile.cuh's, shared with
// the streaming kernel. The loop runs to counts[t] and never reads the
// sentinel slots behind it, so the result does not depend on the cap.
//
// What bounds it: operations. Every pixel tests every face binned to its
// tile (~21 flops each); the bytes are small beside that: the table is read
// once per strip through the cache and the C + 2 output planes are written
// once.

#include <cuda_runtime.h>

#include "raster_tile.cuh"

namespace {

__global__ void __launch_bounds__(dirt::STRIP_H * dirt::SEG_W)
raster_fwd_dense_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ bins, const int* __restrict__ counts, int cap,
    const float* __restrict__ bg, float* __restrict__ pix,
    int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp, int tile_h, int tile_w) {
  const int t = dirt::strip_tile(blockIdx.x, tile_h, tile_w);
  dirt::raster_strip(table, width, bins + (long long)t * cap, counts[t], bg,
                     pix, fid, zbuf, channels, hp, wp, tile_h, tile_w);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `table` is [rows, width] f32, `bins` [tiles, cap] int32 and
// `counts` [tiles] int32; tile_h is a multiple of 8 and tile_w at most 128
// or a multiple of 128 (the wrapper checks). The launch goes on `stream`
// and does not synchronise. Returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int dirt_raster_fwd_dense(
    const float* table, int width, const int* bins, const int* counts,
    int cap, const float* bg, float* pix, int* fid, float* zbuf,
    int channels, int hp, int wp, int tile_h, int tile_w, void* stream) {
  const int blocks = dirt::strip_blocks(hp, wp, tile_h, tile_w);
  if (blocks > 0) {
    raster_fwd_dense_kernel<<<blocks,
                              dirt::STRIP_H * dirt::segment_width(tile_w), 0,
                              static_cast<cudaStream_t>(stream)>>>(
        table, width, bins, counts, cap, bg, pix, fid, zbuf, channels, hp,
        wp, tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
