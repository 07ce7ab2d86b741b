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
// output blocks. Here a block gathers the rows of the faces it stages from
// the face table itself, and loops over the tile's whole run to counts[t]:
// no pre-gathered copy, no revisited outputs, no static chunk bound, and the
// sentinel slots behind a run are never read.
//
// Work decomposition: raster_tile.cuh's strip walk, shared with the dense
// kernel: one block per 8-row strip of a tile, one thread per pixel, the
// run staged through shared memory 64 faces at a time.
//
// What bounds it: the operations of this walk. Every pixel of a strip tests
// every face of its tile's run (~21 flops each), thousands of faces per tile
// on a 100k-face mesh; the bytes (the run's table rows once per strip,
// through the cache, and C + 2 output planes) are small beside that. The
// least the function needs is far less, one test per pixel of each face's
// box, which is below the time its bytes take: culling the run per strip is
// the way down.

#include <cuda_runtime.h>

#include "raster_tile.cuh"

namespace {

constexpr int CHUNK = 128;                    // rows per CSR block

__global__ void __launch_bounds__(dirt::STRIP_H * dirt::SEG_W)
raster_fwd_csr_kernel(
    const float* __restrict__ table, int width,
    const int* __restrict__ entry_face, const int* __restrict__ start_block,
    const int* __restrict__ counts, const float* __restrict__ bg,
    float* __restrict__ pix, int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp, int tile_h, int tile_w) {
  const int t = dirt::strip_tile(blockIdx.x, tile_h, tile_w);
  dirt::raster_strip(table, width,
                     entry_face + (long long)start_block[t] * CHUNK,
                     counts[t], bg, pix, fid, zbuf, channels, hp, wp, tile_h,
                     tile_w);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `table` is [rows, width] f32, `entry_face` [n_pad] int32,
// `start_block` (in 128-row blocks) and `counts` [tiles] int32; tile_h is a
// multiple of 8 and tile_w at most 128 or a multiple of 128 (the wrapper
// checks). The launch goes on `stream` and does not synchronise. Returns
// the cudaGetLastError() code of the launch (0 on success).
extern "C" int dirt_raster_fwd_csr(
    const float* table, int width, const int* entry_face,
    const int* start_block, const int* counts, const float* bg, float* pix,
    int* fid, float* zbuf, int channels, int hp, int wp, int tile_h,
    int tile_w, void* stream) {
  const int blocks = dirt::strip_blocks(hp, wp, tile_h, tile_w);
  if (blocks > 0) {
    raster_fwd_csr_kernel<<<blocks,
                            dirt::STRIP_H * dirt::segment_width(tile_w), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        table, width, entry_face, start_block, counts, bg, pix, fid, zbuf,
        channels, hp, wp, tile_h, tile_w);
  }
  return static_cast<int>(cudaGetLastError());
}
