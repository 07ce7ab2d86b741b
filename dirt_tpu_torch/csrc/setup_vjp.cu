// Vector-Jacobian product of the triangle setup for Hopper (sm_90a).
//
// Replaces no Pallas kernel: dirt_tpu chains the raster op's plane
// cotangents to the screen-space faces with jax.vjp of setup_planes
// (dirt_tpu/ops/triangle_setup.py), which XLA fuses with its autodiff into a
// few loops. PyTorch has no such fusion: the port recomputed setup_planes
// under autograd and called torch.autograd.grad through it, some 450
// elementwise launches over [F] columns read through strided views, about
// 7 ms of a 1,001,112-face step. This kernel computes the same product per
// face in registers:
//
//   (d_geo [F, 24], d_att [F, 3C]) -> (d_face_verts [F, 3, 4],
//                                      d_face_attrs [F, 3, C])
//
// Per face it recomputes what the derivative needs (the corners, area2,
// orientation and validity, the edge slopes, 1 / |area2|, the z,
// denominator and numerator slope sums) and applies setup_planes' chain
// rule as autograd applies it: the gradient only through the branch each
// torch.where takes, orientation and validity piecewise constant, c0 of
// edges 1 and 2 constant, zero for invalid faces, d_geo's padding columns
// 17-23 ignored, row_shift (the sharded path's move one row down) adding to
// y with unit Jacobian. No reduction across faces and no atomics: each output
// is one face's arithmetic in a fixed order. It is the order of
// ops/triangle_setup.setup_planes_vjp_plain; built with -fmad=false and IEEE
// division, the two agree bit for bit.
//
// What bounds it: bytes. A face needs its corners (48 B), attributes (12C),
// the 17 used columns of d_geo (68) and d_att (12C), and writes
// d_face_verts (48) and d_face_attrs (12C): 164 + 36C B, 272 B at C = 3
// (1,001,112 faces: 0.27 GB, 0.081 ms at 3.35 TB/s), against ~130 float
// operations and ~50 more a channel. The rows are 48 B, 96 B (d_geo) and
// 12C B, and the engines hand d_att as a view of their [F, 12 + 3C] face rows
// (84 B a row at C = 3), so a thread that read its own rows would touch
// several sectors in every warp-wide load. Instead a block of THREADS
// threads takes THREADS faces and stages each input's contiguous span
// through shared memory with 16-byte loads of neighbouring lanes (d_geo's
// and d_att's whole rows, as they lie: 96 + 84 B at C = 3, ~350 B a face
// moved in all); each thread then reads its face from shared memory (the
// corners and d_geo as 16-byte vectors), and the outputs go back the same
// way. C = 3 and C = 9, the channel counts of the benchmark's cells, are
// compile-time instances; any other C, or rows too wide to stage, takes the
// general form, a thread per face reading and writing its rows directly in
// a loop over the channels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 64;      // faces a block, one a thread
constexpr int FV = 12;           // floats of a face's corners
constexpr int GEO_USED = 17;     // d_geo columns the setup writes
constexpr float AREA_EPS = 1e-10f;
// Dynamic shared memory a block may take without an opt-in.
constexpr long long SMEM_LIMIT = 48 * 1024;

// Bits of `vec`: which pointers are 16-byte aligned, so that a block's span
// (which starts at a multiple of THREADS rows) moves as float4 vectors.
constexpr unsigned VEC_FV = 1, VEC_FA = 2, VEC_GEO = 4, VEC_ATT = 8,
                   VEC_DFV = 16, VEC_DFA = 32;

__host__ __device__ constexpr long long round4(long long n) {
  return (n + 3) / 4 * 4;
}

// Floats of a block's span of rows of `stride` floats whose first `width`
// are read: every row but the last whole, the last its first `width`.
__host__ __device__ constexpr long long span(long long stride, int width) {
  return (THREADS - 1) * stride + width;
}

// Shared floats of the staged instance for C channels.
__host__ __device__ constexpr long long staged_floats(int c, long long gs,
                                                      long long as) {
  return THREADS * FV + THREADS * 3 * c + round4(span(gs, GEO_USED)) +
         round4(span(as, 3 * c));
}

__device__ __forceinline__ void stage_in(float* dst, const float* src, int n,
                                         bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < n4; v += THREADS) d4[v] = __ldg(s4 + v);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) {
    dst[i] = __ldg(src + i);
  }
}

__device__ __forceinline__ void stage_out(float* dst, const float* src, int n,
                                          bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < n4; v += THREADS) d4[v] = s4[v];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

// One face's cotangents. `v`: its corners (x, y, z, invw) x 3; `g`: the 17
// used columns of its d_geo row; `fa`: its attributes, corner k of channel c
// at k * C + c; `t`: its d_att row. Writes d_face_attrs to `dfa` (same
// layout as `fa`, which it may alias) unless null, and returns d_face_verts
// in `dv`. C > 0 is the channel count at compile time; C == 0 takes it from
// `channels`.
template <int C>
__device__ __forceinline__ void face_vjp(const float (&v)[FV],
                                         const float (&g)[GEO_USED],
                                         const float* fa, const float* t,
                                         float* dfa, int channels,
                                         float row_shift, float (&dv)[FV]) {
  const int nc = C > 0 ? C : channels;
  float x[3], y[3], z[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = v[4 * k];
    y[k] = v[4 * k + 1];
    z[k] = v[4 * k + 2];
    w[k] = v[4 * k + 3];
  }
  if (row_shift != 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) y[k] = y[k] + row_shift;
  }
  const float ex1 = x[1] - x[0], ey2 = y[2] - y[0];
  const float ey1 = y[1] - y[0], ex2 = x[2] - x[0];
  const float area2 = ex1 * ey2 - ey1 * ex2;
  const bool valid = fabsf(area2) > AREA_EPS && w[0] > 0.0f &&
                     w[1] > 0.0f && w[2] > 0.0f;
  if (!valid) {
#pragma unroll
    for (int i = 0; i < FV; ++i) dv[i] = 0.0f;
    if (dfa != nullptr) {
      for (int i = 0; i < 3 * nc; ++i) dfa[i] = 0.0f;
    }
    return;
  }
  const float o = area2 >= 0.0f ? 1.0f : -1.0f;
  const float a[3] = {o * (y[1] - y[2]), o * (y[2] - y[0]),
                      o * (y[0] - y[1])};
  const float b[3] = {o * (x[2] - x[1]), o * (x[0] - x[2]),
                      o * (x[1] - x[0])};
  const float ia = 1.0f / (o * area2);

  // The z and denominator planes: za = (z . a) ia, zb = (z . b) ia,
  // zc = z0; likewise for invw.
  const float sza = (z[0] * a[0] + z[1] * a[1]) + z[2] * a[2];
  const float szb = (z[0] * b[0] + z[1] * b[1]) + z[2] * b[2];
  const float swa = (w[0] * a[0] + w[1] * a[1]) + w[2] * a[2];
  const float swb = (w[0] * b[0] + w[1] * b[1]) + w[2] * b[2];
  const float gza = g[11] * ia, gzb = g[12] * ia;
  const float gwa = g[14] * ia, gwb = g[15] * ia;
  float dia = g[11] * sza;
  dia = dia + g[12] * szb;
  dia = dia + g[14] * swa;
  dia = dia + g[15] * swb;
  float dz[3], dw[3], da[3], db[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dz[k] = gza * a[k] + gzb * b[k];
    dw[k] = gwa * a[k] + gwb * b[k];
    da[k] = (g[2 + 3 * k] + gza * z[k]) + gwa * w[k];
    db[k] = (g[3 + 3 * k] + gzb * z[k]) + gwb * w[k];
  }
  dz[0] = dz[0] + g[13];
  dw[0] = dw[0] + g[16];

  // The attribute planes, a channel at a time: q_k = attr_k invw_k,
  // na = (q . a) ia, nb = (q . b) ia, nc0 = q_0.
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float A[3] = {fa[c], fa[nc + c], fa[2 * nc + c]};
    const float q[3] = {A[0] * w[0], A[1] * w[1], A[2] * w[2]};
    const float sna = (q[0] * a[0] + q[1] * a[1]) + q[2] * a[2];
    const float snb = (q[0] * b[0] + q[1] * b[1]) + q[2] * b[2];
    const float ta = t[3 * c], tb = t[3 * c + 1], tc = t[3 * c + 2];
    const float gna = ta * ia, gnb = tb * ia;
    dia = dia + ta * sna;
    dia = dia + tb * snb;
    float dq[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dq[k] = gna * a[k] + gnb * b[k];
      da[k] = da[k] + gna * q[k];
      db[k] = db[k] + gnb * q[k];
    }
    dq[0] = dq[0] + tc;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (dfa != nullptr) dfa[k * nc + c] = dq[k] * w[k];
      dw[k] = dw[k] + dq[k] * A[k];
    }
  }

  // c0 of edge 0 is |area2|, and 1 / |area2| scales every slope.
  const float dabs = g[4] - dia * (ia * ia);
  const float darea = o * dabs;
  float pa[3], pb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pa[k] = o * da[k];
    pb[k] = o * db[k];
  }
  const float dex1 = darea * ey2, dey2 = darea * ex1;
  const float dey1 = -(darea * ex2), dex2 = -(darea * ey1);
  const float dx[3] = {((g[0] + pb[1]) - pb[2]) - (dex1 + dex2),
                       (pb[2] - pb[0]) + dex1, (pb[0] - pb[1]) + dex2};
  const float dy[3] = {((g[1] + pa[2]) - pa[1]) - (dey1 + dey2),
                       (pa[0] - pa[2]) + dey1, (pa[1] - pa[0]) + dey2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dv[4 * k] = dx[k];
    dv[4 * k + 1] = dy[k];
    dv[4 * k + 2] = dz[k];
    dv[4 * k + 3] = dw[k];
  }
}

// C = 3 or 9: a block stages its faces' spans in shared memory (see the
// note at the top), computes a face a thread, and stores the outputs back
// from shared memory. `gs`, `as` are d_geo's and d_att's row strides.
template <int C>
__global__ void __launch_bounds__(THREADS) setup_vjp_staged(
    const float* __restrict__ fv, const float* __restrict__ fa,
    const float* __restrict__ geo, long long gs,
    const float* __restrict__ att, long long as, float* __restrict__ dfv,
    float* __restrict__ dfa, long long faces, float row_shift,
    unsigned vec) {
  extern __shared__ float4 smem4[];
  float* const s_fv = reinterpret_cast<float*>(smem4);
  float* const s_fa = s_fv + THREADS * FV;
  float* const s_geo = s_fa + THREADS * 3 * C;
  float* const s_att = s_geo + round4(span(gs, GEO_USED));
  const long long f0 = static_cast<long long>(blockIdx.x) * THREADS;
  const int nb = static_cast<int>(
      faces - f0 < THREADS ? faces - f0 : THREADS);
  stage_in(s_fv, fv + f0 * FV, nb * FV, vec & VEC_FV);
  stage_in(s_fa, fa + f0 * 3 * C, nb * 3 * C, vec & VEC_FA);
  stage_in(s_geo, geo + f0 * gs,
           static_cast<int>((nb - 1) * gs + GEO_USED), vec & VEC_GEO);
  stage_in(s_att, att + f0 * as, static_cast<int>((nb - 1) * as + 3 * C),
           vec & VEC_ATT);
  __syncthreads();
  const int f = threadIdx.x;
  if (f < nb) {
    float v[FV], g[GEO_USED], dv[FV];
    const float4* row4 = reinterpret_cast<const float4*>(s_fv + f * FV);
#pragma unroll
    for (int i = 0; i < FV / 4; ++i) {
      const float4 r = row4[i];
      v[4 * i] = r.x;
      v[4 * i + 1] = r.y;
      v[4 * i + 2] = r.z;
      v[4 * i + 3] = r.w;
    }
    const float* grow = s_geo + f * gs;
    if (gs % 4 == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(grow);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 r = g4[i];
        g[4 * i] = r.x;
        g[4 * i + 1] = r.y;
        g[4 * i + 2] = r.z;
        g[4 * i + 3] = r.w;
      }
      g[16] = grow[16];
    } else {
#pragma unroll
      for (int i = 0; i < GEO_USED; ++i) g[i] = grow[i];
    }
    float* const fa_row = s_fa + f * 3 * C;
    face_vjp<C>(v, g, fa_row, s_att + f * as, fa_row, C, row_shift, dv);
    float4* out4 = reinterpret_cast<float4*>(s_fv + f * FV);
#pragma unroll
    for (int i = 0; i < FV / 4; ++i) {
      out4[i] = make_float4(dv[4 * i], dv[4 * i + 1], dv[4 * i + 2],
                            dv[4 * i + 3]);
    }
  }
  __syncthreads();
  if (dfv != nullptr) {
    stage_out(dfv + f0 * FV, s_fv, nb * FV, vec & VEC_DFV);
  }
  if (dfa != nullptr) {
    stage_out(dfa + f0 * 3 * C, s_fa, nb * 3 * C, vec & VEC_DFA);
  }
}

// Any C: a thread per face, its rows read and written where they lie.
__global__ void __launch_bounds__(THREADS) setup_vjp_general(
    const float* __restrict__ fv, const float* __restrict__ fa,
    const float* __restrict__ geo, long long gs,
    const float* __restrict__ att, long long as, float* __restrict__ dfv,
    float* __restrict__ dfa, long long faces, int channels,
    float row_shift) {
  const long long f = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (f >= faces) return;
  float v[FV], g[GEO_USED], dv[FV];
#pragma unroll
  for (int i = 0; i < FV; ++i) v[i] = __ldg(fv + f * FV + i);
#pragma unroll
  for (int i = 0; i < GEO_USED; ++i) g[i] = __ldg(geo + f * gs + i);
  const long long row = f * 3 * channels;
  face_vjp<0>(v, g, fa + row, att + f * as,
              dfa != nullptr ? dfa + row : nullptr, channels, row_shift, dv);
  if (dfv != nullptr) {
#pragma unroll
    for (int i = 0; i < FV; ++i) dfv[f * FV + i] = dv[i];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int C>
cudaError_t launch_staged(unsigned blocks, cudaStream_t stream,
                          const float* fv, const float* fa, const float* geo,
                          long long gs, const float* att, long long as,
                          float* dfv, float* dfa, long long faces,
                          float row_shift, unsigned vec) {
  const size_t smem = staged_floats(C, gs, as) * sizeof(float);
  setup_vjp_staged<C><<<blocks, THREADS, smem, stream>>>(
      fv, fa, geo, gs, att, as, dfv, dfa, faces, row_shift, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). `fv` [F, 3, 4] and `fa` [F, 3, C]
// contiguous float32; `geo` F rows of `geo_stride` >= 17 floats (columns
// 0-16 read), `att` F rows of `att_stride` >= 3C floats (the first 3C read);
// `dfv` [F, 3, 4] and `dfa` [F, 3, C] contiguous, each written whole unless
// null. One launch on `stream` when F > 0 and an output is asked for, no
// synchronisation. Returns the CUDA error code (0 on success).
extern "C" int dirt_setup_vjp(const void* fv, const void* fa, const void* geo,
                              long long geo_stride, const void* att,
                              long long att_stride, void* dfv, void* dfa,
                              long long faces, int channels, float row_shift,
                              void* stream) {
  if (faces < 0 || channels < 1 || geo_stride < GEO_USED ||
      att_stride < 3LL * channels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (faces == 0 || (dfv == nullptr && dfa == nullptr)) {
    return 0;
  }
  const long long blocks = (faces + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f_v = static_cast<const float*>(fv);
  const auto* f_a = static_cast<const float*>(fa);
  const auto* g = static_cast<const float*>(geo);
  const auto* t = static_cast<const float*>(att);
  auto* d_v = static_cast<float*>(dfv);
  auto* d_a = static_cast<float*>(dfa);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned vec = (aligned16(fv) ? VEC_FV : 0) |
                       (aligned16(fa) ? VEC_FA : 0) |
                       (aligned16(geo) ? VEC_GEO : 0) |
                       (aligned16(att) ? VEC_ATT : 0) |
                       (aligned16(dfv) ? VEC_DFV : 0) |
                       (aligned16(dfa) ? VEC_DFA : 0);
  const auto fits = [&](int c) {
    return staged_floats(c, geo_stride, att_stride) *
               static_cast<long long>(sizeof(float)) <=
           SMEM_LIMIT;
  };
  const auto grid = static_cast<unsigned>(blocks);
  cudaError_t err;
  if (channels == 3 && fits(3)) {
    err = launch_staged<3>(grid, st, f_v, f_a, g, geo_stride, t, att_stride,
                           d_v, d_a, faces, row_shift, vec);
  } else if (channels == 9 && fits(9)) {
    err = launch_staged<9>(grid, st, f_v, f_a, g, geo_stride, t, att_stride,
                           d_v, d_a, faces, row_shift, vec);
  } else {
    setup_vjp_general<<<grid, THREADS, 0, st>>>(
        f_v, f_a, g, geo_stride, t, att_stride, d_v, d_a, faces, channels,
        row_shift);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
