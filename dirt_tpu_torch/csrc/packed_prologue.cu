// Neighbor prologue of the packed backward for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/packed_bwd.py::_prologue_kernel (the fused
// neighbor prologue, called by fused_neighbor_prologue). For every pixel of
// the tile-padded image and each of the four boundary_cases() directions
// (right, left, below, above) it computes
//   * bit n of `bits`: pair & front, with pair = (fid != nfid) &
//     (nfid != -2) and front = z < nz for right/below (strict) and
//     z <= nz for left/above;
//   * sval[n] = 0.5 * sum_c (grad_c + ngrad_c) * (pix_c - npix_c), summed
//     over channels in channel order.
// A neighbor outside the padded image has fid -2, z BIG_Z and pix/grad 0.
//
// Layout and shape. The TPU kernel walks 8-row strips with clamped
// previous/next strip views for the vertical halo and then swaps every
// plane into the flat-subtile layout. Here one thread owns one pixel and
// reads its four neighbors directly in image layout (the vertical halo is
// just the next row), and the backward kernel reads image layout after it,
// so no swap runs on this path (the sharded halo path, which does not come
// through here, swaps: subtile_swap.cu).
//
// What bounds it: memory traffic. It reads 2 + 2C planes (fid, z, pix,
// grad; the neighbors' reads hit L1/L2) and writes 5 (bits, 4 sval): at
// 1024^2 with C = 3, ~33.5 MB read and ~21 MB written. Consecutive threads
// take consecutive pixels of a row, so every plane access is coalesced.
// Built with -fmad=false, so sval rounds like the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG_Z = 3.0e38f;

__global__ void __launch_bounds__(THREADS)
packed_prologue_kernel(const int* __restrict__ fid,
                       const float* __restrict__ zbuf,
                       const float* __restrict__ pix,
                       const float* __restrict__ grad,
                       int* __restrict__ bits_out,
                       float* __restrict__ sval_out,
                       int channels, int hp, int wp) {
  const long long plane = (long long)hp * wp;
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  const int y = (int)(p / wp);
  const int x = (int)(p - (long long)y * wp);
  const int f = fid[p];
  const float z = zbuf[p];

  // boundary_cases() order: (dy, dx, strict).
  const int dys[4] = {0, 0, 1, -1};
  const int dxs[4] = {1, -1, 0, 0};
  int bits = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int ny = y + dys[n];
    const int nx = x + dxs[n];
    const bool inside = ny >= 0 && ny < hp && nx >= 0 && nx < wp;
    const long long q = (long long)ny * wp + nx;
    const int nf = inside ? fid[q] : -2;
    const float nz = inside ? zbuf[q] : BIG_Z;
    const bool strict = n == 0 || n == 2;
    const bool pair = f != nf && nf != -2;
    const bool front = strict ? z < nz : z <= nz;
    bits |= (pair && front ? 1 : 0) << n;
    float sval = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const float npix = inside ? pix[c * plane + q] : 0.0f;
      const float ngrad = inside ? grad[c * plane + q] : 0.0f;
      sval = sval + (grad[c * plane + p] + ngrad) * (pix[c * plane + p] - npix);
    }
    sval_out[n * plane + p] = 0.5f * sval;
  }
  bits_out[p] = bits;
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; the launch goes on `stream` and does not synchronise. Returns
// the cudaGetLastError() code of the launch (0 on success).
extern "C" int dirt_packed_prologue(const int* fid, const float* zbuf,
                                    const float* pix, const float* grad,
                                    int* bits, float* sval, int channels,
                                    int hp, int wp, void* stream) {
  const long long plane = (long long)hp * wp;
  const long long blocks = (plane + THREADS - 1) / THREADS;
  if (blocks > 0) {
    packed_prologue_kernel<<<(unsigned)blocks, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        fid, zbuf, pix, grad, bits, sval, channels, hp, wp);
  }
  return static_cast<int>(cudaGetLastError());
}
