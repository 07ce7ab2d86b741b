// Image <-> flat-subtile layout swap for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/raster_fwd.py::flat_subtile_swap_pallas (its
// butterfly of rolls and selects over 64x128 blocks). The permutation acts
// inside every 8-row x 128-column strip of a plane:
//   flat[8*S + k, 128*tx + 16*r + c] = image[8*S + r, 128*tx + 16*k + c]
// (k = 16-column group, r = row of the strip, c = column of the group), so
// the 128 pixels of one 8x16 subtile become one 128-element row. Swapping r
// and k is its own inverse: the same kernel converts both ways.
//
// Work decomposition. One launch permutes every plane of up to MAX_ARRAYS
// arrays of one [hp, wp] image size (any mix of float32 and int32: 32-bit
// words are moved, not interpreted). blockIdx.x is the (strip, tile column),
// blockIdx.y the plane, counted over all arrays; a block of 256 threads
// moves the strip's 1024 words, one 16-byte vector of four per thread (a
// group is 16 columns wide, so four neighbouring words stay neighbours; the
// wrapper hands over 16-byte aligned arrays). A warp reads one whole
// 512-byte row of the strip and writes eight 64-byte runs (the row's eight
// groups land on eight destination rows), whole 32-byte sectors both.
//
// What bounds it: bytes only. Each word is read once and written once. On
// the card this runs at ~90% of the copy's byte bound; giving a thread
// several vectors (all loads before the first store), read-only loads with
// streaming stores, or a grid of a few waves striding over the strips each
// measured slower (PERF.md, section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SUB_H = 8;
constexpr int SUB_W = 16;
constexpr int TILE_W = 128;
constexpr int THREADS = SUB_H * TILE_W / 4;           // 256
constexpr int MAX_ARRAYS = 8;

struct Arrays {
  const uint4* src[MAX_ARRAYS];
  uint4* dst[MAX_ARRAYS];
  int first_plane[MAX_ARRAYS + 1];  // running plane count; [n] = total
  int n;
};

__global__ void __launch_bounds__(THREADS)
subtile_swap_kernel(Arrays a, int hp, int wp) {
  const int tiles_x = wp / TILE_W;
  const int strip = blockIdx.x / tiles_x;
  const int tx = blockIdx.x - strip * tiles_x;
  int which = 0;
  while (which + 1 < a.n && (int)blockIdx.y >= a.first_plane[which + 1]) {
    ++which;
  }
  // All offsets below count 4-word vectors: wp, TILE_W and SUB_W are
  // multiples of 4.
  const long long row = wp / 4;
  const long long plane =
      (long long)((int)blockIdx.y - a.first_plane[which]) * hp * row;
  const uint4* src = a.src[which] + plane;
  uint4* dst = a.dst[which] + plane;
  const long long base = (long long)strip * SUB_H * row + tx * (TILE_W / 4);
  const int r = threadIdx.x / (TILE_W / 4);           // row of the strip
  const int q = threadIdx.x - r * (TILE_W / 4);       // vector of the row
  const int k = q / (SUB_W / 4);                      // group
  const int c = q - k * (SUB_W / 4);                  // vector of the group
  dst[base + k * row + r * (SUB_W / 4) + c] = src[base + r * row + q];
}

}  // namespace

// Plain C entry point (bound with ctypes). `srcs` and `dsts` are host arrays
// of `n` device pointers (1 <= n <= 8), `planes[i]` the number of [hp, wp]
// planes of array i; hp is a multiple of 8 and wp of 128, and every pointer
// is 16-byte aligned. One launch on `stream`, no synchronisation. Returns
// the CUDA error code (0 on success).
extern "C" int dirt_subtile_swap(const void* const* srcs, void* const* dsts,
                                 const int* planes, int n, int hp, int wp,
                                 void* stream) {
  if (n < 1 || n > MAX_ARRAYS || hp % SUB_H || wp % TILE_W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Arrays a;
  a.n = n;
  a.first_plane[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(srcs[i]) % 16 ||
        reinterpret_cast<uintptr_t>(dsts[i]) % 16) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    a.src[i] = static_cast<const uint4*>(srcs[i]);
    a.dst[i] = static_cast<uint4*>(dsts[i]);
    a.first_plane[i + 1] = a.first_plane[i] + planes[i];
  }
  const int total = a.first_plane[n];
  const int blocks = (hp / SUB_H) * (wp / TILE_W);
  if (blocks > 0 && total > 0) {
    subtile_swap_kernel<<<dim3(blocks, total), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, hp, wp);
  }
  return static_cast<int>(cudaGetLastError());
}
