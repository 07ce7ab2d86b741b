// Forward triangle setup for Hopper (sm_90a): planes, boxes and edge columns.
//
// Replaces no Pallas kernel: dirt_tpu sets its faces up with setup_planes,
// face_bbox_cols and edge_filter_cols (dirt_tpu/ops/triangle_setup.py),
// elementwise arithmetic over [F] columns that XLA fuses into a few loops.
// PyTorch has no such fusion: the port ran some 200 elementwise launches
// over [F] columns read through strided views of the corners, about 3.5 ms
// of a 1,001,112-face forward. This kernel does the same per face in
// registers:
//
//   (face_verts [F, 3, 4], face_attrs [F, 3, C]) -> geo [F, 24],
//       att [F, 3C], valid [F], boxes, edge columns
//
// geo and att as setup_planes lays them out (geo's columns 17-23 zero);
// valid as one byte 0 or 1; the boxes (xmin, xmax, ymin, ymax) as
// face_bbox_cols computes them: inclusive pixel indices from the corners'
// least and greatest x and y (a NaN corner makes its extreme NaN, as
// torch.amin does), converted with XLA's saturating convert (NaN to 0,
// clamped to [-2^31, 2147483520]), culled when the face is invalid, off the
// image or wholly outside z in [-1, 1], and clipped to the image; either as
// [F, 4] int32 rows (the dense and streaming engines) or as four contiguous
// [F] int32 columns (the packed engine); and, for the packed engine's
// binning, edge_filter_cols' nine [F] float columns (x0, y0, a0, b0, a1, b1,
// a2, b2, c0) contiguous. Every expression keeps setup_planes' operation
// order; built with -fmad=false and IEEE division, the outputs agree with
// ops/triangle_setup.setup_faces_plain bit for bit.
//
// What bounds it: bytes. A face reads its corners (48 B) and attributes
// (12C) and writes geo (96), att (12C), valid (1), the boxes (16) and the
// edge columns (36): 197 + 24C B, 269 B at C = 3 (1,001,112 faces: 0.27 GB,
// 0.080 ms at 3.35 TB/s), against ~70 float operations and ~10 more a
// channel. The rows are 48 B, 12C B and 96 B, so a thread that read and
// wrote its own rows would touch several sectors in every warp-wide access.
// Instead a block of THREADS threads takes THREADS faces and stages the
// corners' and attributes' contiguous spans through shared memory with
// 16-byte loads of neighbouring lanes; each thread reads its corners back
// as 16-byte vectors, writes its geo and att rows to shared memory, and the
// block stores both spans with 16-byte stores. The columns and the box rows
// a thread writes directly: neighbouring lanes write neighbouring words.
// C = 3 and C = 9, the channel counts of the benchmark's cells, are
// compile-time instances; any other C takes the general form, a thread per
// face reading and writing its rows directly in a loop over the channels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 64;      // faces a block, one a thread
constexpr int FV = 12;           // floats of a face's corners
constexpr int GEO = 24;          // floats of a geo row
constexpr int GEO_USED = 17;     // geo columns the setup writes
constexpr int EDGES = 9;         // edge-filter columns
constexpr float AREA_EPS = 1e-10f;
// Bounds of the saturating float -> int32 convert: -2^31 and the largest
// float below 2^31.
constexpr float I32_LO = -2147483648.0f;
constexpr float I32_HI = 2147483520.0f;

// Bits of `vec`: which pointers are 16-byte aligned, so that a block's span
// (which starts at a multiple of THREADS rows) moves as float4 vectors.
constexpr unsigned VEC_FV = 1, VEC_FA = 2, VEC_GEO = 4, VEC_ATT = 8;

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

// The least and greatest of three floats, NaN if any is NaN (torch.amin /
// torch.amax over a face's corners).
__device__ __forceinline__ float min3(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return __int_as_float(0x7fffffff);
  return fminf(fminf(a, b), c);
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  if (isnan(a) || isnan(b) || isnan(c)) return __int_as_float(0x7fffffff);
  return fmaxf(fmaxf(a, b), c);
}

// XLA's saturating float -> int32 convert: NaN to 0, clamped to the range.
__device__ __forceinline__ int to_i32(float v) {
  if (isnan(v)) return 0;
  return static_cast<int>(fminf(fmaxf(v, I32_LO), I32_HI));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// What one face's setup writes besides att.
struct Face {
  float geo[GEO_USED];
  float edge[EDGES];
  int box[4];       // xmin, xmax, ymin, ymax
  bool valid;
};

// One face's setup. `v`: its corners (x, y, z, invw) x 3; `fa`: its
// attributes, corner k of channel c at k * C + c; `att`: where its att row
// goes (channel c's (na, nb, nc0) at 3c), which may alias `fa` when C > 0.
// C > 0 is the channel count at compile time (the attributes are read into
// registers before att is written); C == 0 takes it from `channels`, and
// `att` may not alias `fa`.
template <int C>
__device__ __forceinline__ void face_setup(const float (&v)[FV],
                                           const float* fa, float* att,
                                           int channels, int height,
                                           int width, Face& out) {
  float x[3], y[3], z[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = v[4 * k];
    y[k] = v[4 * k + 1];
    z[k] = v[4 * k + 2];
    w[k] = v[4 * k + 3];
  }
  const float area2 = (x[1] - x[0]) * (y[2] - y[0]) -
                      (y[1] - y[0]) * (x[2] - x[0]);
  const float orient = area2 >= 0.0f ? 1.0f : -1.0f;
  const bool valid = fabsf(area2) > AREA_EPS && w[0] > 0.0f &&
                     w[1] > 0.0f && w[2] > 0.0f;
  // Edge j runs from vertex (j+1)%3 to (j+2)%3 (opposite vertex j); an
  // invalid face's edges exclude every pixel.
  float a[3], b[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j] = valid ? orient * (y[(j + 1) % 3] - y[(j + 2) % 3]) : 0.0f;
    b[j] = valid ? orient * (x[(j + 2) % 3] - x[(j + 1) % 3]) : 0.0f;
  }
  const float abs_area = orient * area2;
  const float c0 = valid ? abs_area : -1.0f;
  const float c12 = valid ? 0.0f : -1.0f;
  const float inv_area = valid ? 1.0f / abs_area : 0.0f;

  // Barycentric slope sums: the z, denominator and numerator planes.
  float* g = out.geo;
  g[0] = valid ? x[0] : 0.0f;
  g[1] = valid ? y[0] : 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g[2 + 3 * j] = a[j];
    g[3 + 3 * j] = b[j];
    g[4 + 3 * j] = j == 0 ? c0 : c12;
  }
  g[11] = ((z[0] * a[0] + z[1] * a[1]) + z[2] * a[2]) * inv_area;
  g[12] = ((z[0] * b[0] + z[1] * b[1]) + z[2] * b[2]) * inv_area;
  g[13] = valid ? z[0] : 0.0f;
  g[14] = ((w[0] * a[0] + w[1] * a[1]) + w[2] * a[2]) * inv_area;
  g[15] = ((w[0] * b[0] + w[1] * b[1]) + w[2] * b[2]) * inv_area;
  g[16] = valid ? w[0] : 1.0f;

  if constexpr (C > 0) {
    float A[3 * C];
#pragma unroll
    for (int i = 0; i < 3 * C; ++i) A[i] = fa[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float q[3] = {A[c] * w[0], A[C + c] * w[1], A[2 * C + c] * w[2]};
      att[3 * c] = ((q[0] * a[0] + q[1] * a[1]) + q[2] * a[2]) * inv_area;
      att[3 * c + 1] = ((q[0] * b[0] + q[1] * b[1]) + q[2] * b[2]) * inv_area;
      att[3 * c + 2] = valid ? q[0] : 0.0f;
    }
  } else {
    for (int c = 0; c < channels; ++c) {
      const float q[3] = {fa[c] * w[0], fa[channels + c] * w[1],
                          fa[2 * channels + c] * w[2]};
      att[3 * c] = ((q[0] * a[0] + q[1] * a[1]) + q[2] * a[2]) * inv_area;
      att[3 * c + 1] = ((q[0] * b[0] + q[1] * b[1]) + q[2] * b[2]) * inv_area;
      att[3 * c + 2] = valid ? q[0] : 0.0f;
    }
  }

  // The binning's edge filter: the raw anchor, the edges, c0.
  const float e[EDGES] = {x[0], y[0], a[0], b[0], a[1], b[1], a[2], b[2], c0};
#pragma unroll
  for (int i = 0; i < EDGES; ++i) out.edge[i] = e[i];

  // The conservative pixel box, culled and clipped to the image.
  int xmin = to_i32(floorf(min3(x[0], x[1], x[2]) - 0.5f));
  int xmax = to_i32(ceilf(max3(x[0], x[1], x[2]) - 0.5f));
  int ymin = to_i32(floorf(min3(y[0], y[1], y[2]) - 0.5f));
  int ymax = to_i32(ceilf(max3(y[0], y[1], y[2]) - 0.5f));
  const bool onscreen = xmax >= 0 && xmin <= width - 1 && ymax >= 0 &&
                        ymin <= height - 1 &&
                        min3(z[0], z[1], z[2]) <= 1.0f &&
                        max3(z[0], z[1], z[2]) >= -1.0f;
  const bool keep = valid && onscreen;
  out.box[0] = keep ? clampi(xmin, 0, width - 1) : 0;
  out.box[1] = keep ? clampi(xmax, 0, width - 1) : -1;
  out.box[2] = keep ? clampi(ymin, 0, height - 1) : 0;
  out.box[3] = keep ? clampi(ymax, 0, height - 1) : -1;
  out.valid = valid;
}

// Face f's valid byte, box and edge columns: `box_rows` [F, 4] rows or [4, F]
// columns; `boxes` and `edges` ([9, F]) may be null.
__device__ __forceinline__ void store_columns(const Face& out, long long f,
                                              long long faces,
                                              uint8_t* __restrict__ valid,
                                              int* __restrict__ boxes,
                                              bool box_rows,
                                              float* __restrict__ edges) {
  valid[f] = out.valid ? 1 : 0;
  if (boxes != nullptr) {
    if (box_rows) {
      reinterpret_cast<int4*>(boxes)[f] =
          make_int4(out.box[0], out.box[1], out.box[2], out.box[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) boxes[k * faces + f] = out.box[k];
    }
  }
  if (edges != nullptr) {
#pragma unroll
    for (int k = 0; k < EDGES; ++k) edges[k * faces + f] = out.edge[k];
  }
}

// C = 3 or 9: a block stages its faces' corner and attribute spans in
// shared memory (see the note at the top), sets a face up a thread, and
// stores the geo and att spans back from shared memory.
template <int C>
__global__ void __launch_bounds__(THREADS) setup_fwd_staged(
    const float* __restrict__ fv, const float* __restrict__ fa,
    float* __restrict__ geo, float* __restrict__ att,
    uint8_t* __restrict__ valid, int* __restrict__ boxes, int box_rows,
    float* __restrict__ edges, long long faces, int height, int width,
    unsigned vec) {
  __shared__ float4 s_fv4[THREADS * FV / 4];
  __shared__ float4 s_fa4[THREADS * 3 * C / 4];
  __shared__ float4 s_geo4[THREADS * GEO / 4];
  float* const s_fv = reinterpret_cast<float*>(s_fv4);
  float* const s_fa = reinterpret_cast<float*>(s_fa4);
  float* const s_geo = reinterpret_cast<float*>(s_geo4);
  const long long f0 = static_cast<long long>(blockIdx.x) * THREADS;
  const int nb = static_cast<int>(
      faces - f0 < THREADS ? faces - f0 : THREADS);
  stage_in(s_fv, fv + f0 * FV, nb * FV, vec & VEC_FV);
  stage_in(s_fa, fa + f0 * 3 * C, nb * 3 * C, vec & VEC_FA);
  __syncthreads();
  const int f = threadIdx.x;
  if (f < nb) {
    float v[FV];
#pragma unroll
    for (int i = 0; i < FV / 4; ++i) {
      const float4 r = s_fv4[f * (FV / 4) + i];
      v[4 * i] = r.x;
      v[4 * i + 1] = r.y;
      v[4 * i + 2] = r.z;
      v[4 * i + 3] = r.w;
    }
    Face out;
    float* const fa_row = s_fa + f * 3 * C;
    face_setup<C>(v, fa_row, fa_row, C, height, width, out);
    float* const g = s_geo + f * GEO;
#pragma unroll
    for (int i = 0; i < GEO_USED; ++i) g[i] = out.geo[i];
#pragma unroll
    for (int i = GEO_USED; i < GEO; ++i) g[i] = 0.0f;
    store_columns(out, f0 + f, faces, valid, boxes, box_rows != 0, edges);
  }
  __syncthreads();
  stage_out(geo + f0 * GEO, s_geo, nb * GEO, vec & VEC_GEO);
  stage_out(att + f0 * 3 * C, s_fa, nb * 3 * C, vec & VEC_ATT);
}

// Any C: a thread per face, its rows read and written where they lie.
__global__ void __launch_bounds__(THREADS) setup_fwd_general(
    const float* __restrict__ fv, const float* __restrict__ fa,
    float* __restrict__ geo, float* __restrict__ att,
    uint8_t* __restrict__ valid, int* __restrict__ boxes, int box_rows,
    float* __restrict__ edges, long long faces, int channels, int height,
    int width) {
  const long long f = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (f >= faces) return;
  float v[FV];
#pragma unroll
  for (int i = 0; i < FV; ++i) v[i] = __ldg(fv + f * FV + i);
  Face out;
  const long long row = f * 3 * channels;
  face_setup<0>(v, fa + row, att + row, channels, height, width, out);
#pragma unroll
  for (int i = 0; i < GEO_USED; ++i) geo[f * GEO + i] = out.geo[i];
#pragma unroll
  for (int i = GEO_USED; i < GEO; ++i) geo[f * GEO + i] = 0.0f;
  store_columns(out, f, faces, valid, boxes, box_rows != 0, edges);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). `fv` [F, 3, 4] and `fa` [F, 3, C]
// contiguous float32; `geo` [F, 24] and `att` [F, 3C] contiguous float32 and
// `valid` [F] bytes, written whole; `boxes` int32, 16-byte aligned when
// `box_rows` (then [F, 4] rows, else [4, F] columns), `edges` [9, F] float32,
// each written whole unless null; `height`, `width` the image the boxes are
// clipped to. One launch on `stream` when F > 0, no synchronisation.
// Returns the CUDA error code (0 on success).
extern "C" int dirt_setup_fwd(const void* fv, const void* fa, void* geo,
                              void* att, void* valid, void* boxes,
                              int box_rows, void* edges, long long faces,
                              int channels, int height, int width,
                              void* stream) {
  if (faces < 0 || channels < 1 || height < 1 || width < 1 ||
      (boxes != nullptr && box_rows != 0 && !aligned16(boxes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (faces == 0) {
    return 0;
  }
  const long long blocks = (faces + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* f_v = static_cast<const float*>(fv);
  const auto* f_a = static_cast<const float*>(fa);
  auto* g = static_cast<float*>(geo);
  auto* t = static_cast<float*>(att);
  auto* ok = static_cast<uint8_t*>(valid);
  auto* box = static_cast<int*>(boxes);
  auto* e = static_cast<float*>(edges);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned vec = (aligned16(fv) ? VEC_FV : 0) |
                       (aligned16(fa) ? VEC_FA : 0) |
                       (aligned16(geo) ? VEC_GEO : 0) |
                       (aligned16(att) ? VEC_ATT : 0);
  const auto grid = static_cast<unsigned>(blocks);
  if (channels == 3) {
    setup_fwd_staged<3><<<grid, THREADS, 0, st>>>(
        f_v, f_a, g, t, ok, box, box_rows, e, faces, height, width, vec);
  } else if (channels == 9) {
    setup_fwd_staged<9><<<grid, THREADS, 0, st>>>(
        f_v, f_a, g, t, ok, box, box_rows, e, faces, height, width, vec);
  } else {
    setup_fwd_general<<<grid, THREADS, 0, st>>>(
        f_v, f_a, g, t, ok, box, box_rows, e, faces, channels, height,
        width);
  }
  return static_cast<int>(cudaGetLastError());
}
