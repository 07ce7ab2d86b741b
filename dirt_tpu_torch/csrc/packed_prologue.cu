// Neighbor prologue of the backward for Hopper (sm_90a).
//
// Replaces dirt_tpu/ops/packed_bwd.py::_prologue_kernel (the fused
// neighbor prologue, called by padded_prologue): "one pass:
// neighbor shifts -> (pair & front) bit plane + per-direction sval + the
// fields in the backward's layout". For every pixel of the tile-padded
// image and each of the four boundary_cases() directions (right, left,
// below, above) it computes
//   * bit n of `bits`: pair & front, with pair = (fid != nfid) &
//     (nfid != -2) and front = z < nz for right/below (strict) and
//     z <= nz for left/above;
//   * sval[n] = 0.5 * sum_c (grad_c + ngrad_c) * (pix_c - npix_c), summed
//     over channels in channel order, then halved;
// and, like the TPU kernel, writes the fields the backward kernels read:
// fid padded with -2 and the pixels and the upstream gradient padded with
// 0 as [C, Hp, Wp] planes. It reads fid, z, pixels and gradient of the
// unpadded [H, W] image through their strides (the pixels are a permuted,
// cropped view of the forward's [C, Hp, Wp] output, the gradient is
// usually [H, W, C]), so nothing is padded or copied before it. A pixel
// outside the image, padding or beyond, reads as fid -2, z BIG_Z and pix /
// grad 0; no padded z plane is ever built.
//
// Work decomposition. A 2-D grid of blocks of 8 warps; a warp takes 128
// consecutive pixels of one padded row, four consecutive pixels a lane.
// A lane reads its four pixels of each field, and of the rows above and
// below, as one 16-byte vector where the field allows it (unit x stride,
// aligned rows: the forward's fid, depth and pixels), else pixel by pixel
// (the [H, W, C] gradient); the rows above and below are L1 / L2 hits, the
// neighbouring warps read them too. Its left and right neighbors come
// from its own registers and, at the ends of its four, from the next
// lanes by warp shuffles (the warp's two end lanes load the pixel past the
// warp's run). Each channel is read once, and all four sval accumulate in
// one pass over the channels, each in the plain version's order, so
// (-fmad=false) the outputs equal the plain PyTorch version bit for bit.
// Offsets are 32-bit (the entry point refuses fields that do not fit).
// Blocks of 2 or 4 warps ran as fast at 1024^2 C = 3 and up to 4% slower
// at C = 9.
//
// What bounds it: memory traffic. It must read 8 + 8C bytes a pixel (fid,
// z, C pixels, C gradient values) and write 24 + 8C a padded pixel (fid,
// bits, 4 sval, 2C planes): 83.9 MB at 1024^2 with C = 3, 0.025 ms at
// 3.35 TB/s. Stores are 16-byte vectors when the padded width is a
// multiple of 4 (always for the packed engine's 128-wide tiles).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LANE_PIX = 4;                   // consecutive pixels a lane
constexpr int SEG = 32 * LANE_PIX;            // 128 pixels a warp
constexpr float BIG_Z = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

// Element strides of the strided inputs: fid and z [H, W], pixels and
// gradient [H, W, C].
struct Strides {
  int fid_y, fid_x, z_y, z_x, pix_y, pix_x, pix_c, grad_y, grad_x, grad_c;
};

// Which inputs a lane reads as one 16-byte vector of four pixels (unit x
// stride, rows and channel planes 16-byte aligned): bits of Image::vec.
constexpr int VEC_FID = 1, VEC_Z = 2, VEC_PIX = 4, VEC_GRAD = 8;

struct Image {
  const int* fid;
  const float* z;
  const float* pix;
  const float* grad;
  Strides s;
  int h, w, vec;

  __device__ __forceinline__ bool inside(int y, int x) const {
    return (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
  }
  __device__ __forceinline__ int f(int y, int x) const {
    return inside(y, x) ? __ldg(fid + y * s.fid_y + x * s.fid_x) : -2;
  }
  __device__ __forceinline__ float zv(int y, int x) const {
    return inside(y, x) ? __ldg(z + y * s.z_y + x * s.z_x) : BIG_Z;
  }
  __device__ __forceinline__ float p(int c, int y, int x) const {
    return inside(y, x) ? __ldg(pix + y * s.pix_y + x * s.pix_x + c * s.pix_c)
                        : 0.0f;
  }
  __device__ __forceinline__ float g(int c, int y, int x) const {
    return inside(y, x)
        ? __ldg(grad + y * s.grad_y + x * s.grad_x + c * s.grad_c) : 0.0f;
  }
};

__device__ __forceinline__ void unpack(const int4& v, int (&out)[LANE_PIX]) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void unpack(const float4& v,
                                       float (&out)[LANE_PIX]) {
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// A lane's four values of image row y, columns x0 .. x0 + 3 (x0 >= 0), of
// a strided field: one 16-byte load where the field allows it and all four
// lie in the image, else one load per pixel; outside the image `pad`.
template <typename V, typename T>
__device__ __forceinline__ void row4(const T* base, int sy, int sx, bool vec,
                                     int y, int x0, int h, int w, T pad,
                                     T (&out)[LANE_PIX]) {
  if ((unsigned)y >= (unsigned)h) {
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) out[k] = pad;
    return;
  }
  const T* row = base + y * sy;
  if (vec && x0 + LANE_PIX <= w) {
    unpack(__ldg(reinterpret_cast<const V*>(row + x0)), out);
  } else {
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) {
      out[k] = x0 + k < w ? __ldg(row + (x0 + k) * sx) : pad;
    }
  }
}

__device__ __forceinline__ void store_vec(int* out, const int (&v)[LANE_PIX]) {
  *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(float* out,
                                          const float (&v)[LANE_PIX]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

// A lane's four values at x0.. of one output row: one 16-byte store when
// the padded width is a multiple of 4 (x0 is, and so is every row start),
// else one store per pixel inside the padded width.
template <typename T>
__device__ __forceinline__ void store4(T* out, int x0, int wp, bool vec,
                                       const T (&v)[LANE_PIX]) {
  if (vec) {
    if (x0 < wp) store_vec(out + x0, v);
  } else {
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) {
      if (x0 + k < wp) out[x0 + k] = v[k];
    }
  }
}

// The horizontal neighbors of a lane's four values: right[k] = value at
// x0 + k + 1, left[k] = at x0 + k - 1. `past_right` / `past_left` are the
// values at x0 + 4 and x0 - 1 as the warp's last and first lanes load them.
template <typename T>
__device__ __forceinline__ void sideways(const T (&v)[LANE_PIX], int lane,
                                         T past_right, T past_left,
                                         T (&right)[LANE_PIX],
                                         T (&left)[LANE_PIX]) {
  const T r = __shfl_down_sync(FULL, v[0], 1);
  const T l = __shfl_up_sync(FULL, v[LANE_PIX - 1], 1);
#pragma unroll
  for (int k = 0; k < LANE_PIX - 1; ++k) {
    right[k] = v[k + 1];
    left[k + 1] = v[k];
  }
  right[LANE_PIX - 1] = lane == 31 ? past_right : r;
  left[0] = lane == 0 ? past_left : l;
}

__global__ void __launch_bounds__(THREADS)
packed_prologue_kernel(Image im, int channels, int hp, int wp, bool vec,
                       int* __restrict__ fid_out, int* __restrict__ bits_out,
                       float* __restrict__ sval_out,
                       float* __restrict__ pix_out,
                       float* __restrict__ grad_out) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (y >= hp) return;                        // the whole warp
  const int x0 = blockIdx.x * SEG + lane * LANE_PIX;
  const int plane = hp * wp;
  const int row = y * wp;
  const bool last = lane == 31, first = lane == 0;

  // Face ids and depths: own, right / left (registers and shuffles),
  // below / above (loads).
  const int h = im.h, w = im.w;
  const Strides& st = im.s;
  int f[LANE_PIX], fr[LANE_PIX], fl[LANE_PIX], fb[LANE_PIX], fa[LANE_PIX];
  float z[LANE_PIX], zr[LANE_PIX], zl[LANE_PIX], zb[LANE_PIX], za[LANE_PIX];
  const bool vf = im.vec & VEC_FID, vz = im.vec & VEC_Z;
  row4<int4>(im.fid, st.fid_y, st.fid_x, vf, y, x0, h, w, -2, f);
  row4<int4>(im.fid, st.fid_y, st.fid_x, vf, y + 1, x0, h, w, -2, fb);
  row4<int4>(im.fid, st.fid_y, st.fid_x, vf, y - 1, x0, h, w, -2, fa);
  row4<float4>(im.z, st.z_y, st.z_x, vz, y, x0, h, w, BIG_Z, z);
  row4<float4>(im.z, st.z_y, st.z_x, vz, y + 1, x0, h, w, BIG_Z, zb);
  row4<float4>(im.z, st.z_y, st.z_x, vz, y - 1, x0, h, w, BIG_Z, za);
  sideways(f, lane, last ? im.f(y, x0 + LANE_PIX) : -2,
           first ? im.f(y, x0 - 1) : -2, fr, fl);
  sideways(z, lane, last ? im.zv(y, x0 + LANE_PIX) : BIG_Z,
           first ? im.zv(y, x0 - 1) : BIG_Z, zr, zl);
  int bits[LANE_PIX];
#pragma unroll
  for (int k = 0; k < LANE_PIX; ++k) {
    const int me = f[k];
    bits[k] = ((me != fr[k] && fr[k] != -2 && z[k] < zr[k]) ? 1 : 0)
            | ((me != fl[k] && fl[k] != -2 && z[k] <= zl[k]) ? 2 : 0)
            | ((me != fb[k] && fb[k] != -2 && z[k] < zb[k]) ? 4 : 0)
            | ((me != fa[k] && fa[k] != -2 && z[k] <= za[k]) ? 8 : 0);
  }
  store4(fid_out + row, x0, wp, vec, f);
  store4(bits_out + row, x0, wp, vec, bits);

  // sval, all four directions in one pass over the channels.
  float s[4][LANE_PIX];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) s[n][k] = 0.0f;
  }
  const bool vp = im.vec & VEC_PIX, vg = im.vec & VEC_GRAD;
  for (int c = 0; c < channels; ++c) {
    const float* pc = im.pix + c * st.pix_c;
    const float* gc = im.grad + c * st.grad_c;
    float p[LANE_PIX], g[LANE_PIX];
    row4<float4>(pc, st.pix_y, st.pix_x, vp, y, x0, h, w, 0.0f, p);
    row4<float4>(gc, st.grad_y, st.grad_x, vg, y, x0, h, w, 0.0f, g);
    store4(pix_out + c * plane + row, x0, wp, vec, p);
    store4(grad_out + c * plane + row, x0, wp, vec, g);
    float pr[LANE_PIX], pl[LANE_PIX], gr[LANE_PIX], gl[LANE_PIX];
    sideways(p, lane, last ? im.p(c, y, x0 + LANE_PIX) : 0.0f,
             first ? im.p(c, y, x0 - 1) : 0.0f, pr, pl);
    sideways(g, lane, last ? im.g(c, y, x0 + LANE_PIX) : 0.0f,
             first ? im.g(c, y, x0 - 1) : 0.0f, gr, gl);
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) {
      s[0][k] = s[0][k] + (g[k] + gr[k]) * (p[k] - pr[k]);
      s[1][k] = s[1][k] + (g[k] + gl[k]) * (p[k] - pl[k]);
    }
    row4<float4>(pc, st.pix_y, st.pix_x, vp, y + 1, x0, h, w, 0.0f, pr);
    row4<float4>(gc, st.grad_y, st.grad_x, vg, y + 1, x0, h, w, 0.0f, gr);
    row4<float4>(pc, st.pix_y, st.pix_x, vp, y - 1, x0, h, w, 0.0f, pl);
    row4<float4>(gc, st.grad_y, st.grad_x, vg, y - 1, x0, h, w, 0.0f, gl);
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) {
      s[2][k] = s[2][k] + (g[k] + gr[k]) * (p[k] - pr[k]);
      s[3][k] = s[3][k] + (g[k] + gl[k]) * (p[k] - pl[k]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float half[LANE_PIX];
#pragma unroll
    for (int k = 0; k < LANE_PIX; ++k) half[k] = 0.5f * s[n][k];
    store4(sval_out + n * plane + row, x0, wp, vec, half);
  }
}

// Whether a strided [H, W(, C)] input may be read as 16-byte vectors of
// four pixels: unit x stride, and every row (and channel plane) start
// 16-byte aligned.
bool vector_rows(const void* ptr, int sy, int sx, int sc) {
  return sx == 1 && sy % 4 == 0 && sc % 4 == 0 &&
         reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The largest element offset of a strided [h, w, c] input.
long long last_offset(int h, int w, int c, int sy, int sx, int sc) {
  return (long long)(h - 1) * sy + (long long)(w - 1) * sx +
         (long long)(c - 1) * sc;
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; the strides are in elements. The launch goes on `stream` and
// does not synchronise. Returns -1 without a launch if an offset does not fit
// in 32 bits, else the cudaGetLastError() code of the launch (0 on
// success).
extern "C" int dirt_packed_prologue(
    const int* fid, const float* zbuf, const float* pix, const float* grad,
    int fid_y, int fid_x, int z_y, int z_x, int pix_y, int pix_x, int pix_c,
    int grad_y, int grad_x, int grad_c, int height, int width, int channels,
    int hp, int wp, int* fid_out, int* bits, float* sval, float* pix_out,
    float* grad_out, void* stream) {
  const long long limit = 1LL << 31;
  const int c = channels > 0 ? channels : 1;
  if (last_offset(height, width, 1, fid_y, fid_x, 0) >= limit ||
      last_offset(height, width, 1, z_y, z_x, 0) >= limit ||
      last_offset(height, width, c, pix_y, pix_x, pix_c) >= limit ||
      last_offset(height, width, c, grad_y, grad_x, grad_c) >= limit ||
      (long long)(c > 4 ? c : 4) * hp * wp >= limit) {
    return -1;
  }
  const int vec_in =
      (vector_rows(fid, fid_y, fid_x, 0) ? VEC_FID : 0) |
      (vector_rows(zbuf, z_y, z_x, 0) ? VEC_Z : 0) |
      (vector_rows(pix, pix_y, pix_x, pix_c) ? VEC_PIX : 0) |
      (vector_rows(grad, grad_y, grad_x, grad_c) ? VEC_GRAD : 0);
  const Image im{fid, zbuf, pix, grad,
                 Strides{fid_y, fid_x, z_y, z_x, pix_y, pix_x, pix_c, grad_y,
                         grad_x, grad_c},
                 height, width, vec_in};
  const dim3 grid((wp + SEG - 1) / SEG, (hp + WARPS - 1) / WARPS);
  if (hp > 0 && wp > 0) {
    packed_prologue_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        im, channels, hp, wp, wp % LANE_PIX == 0, fid_out, bits, sval,
        pix_out, grad_out);
  }
  return static_cast<int>(cudaGetLastError());
}
