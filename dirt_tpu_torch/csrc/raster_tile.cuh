// The culled whole-tile strip walk of the forward kernels that scan a tile's
// face list (raster_fwd_dense.cu over [T, cap] bins, raster_fwd_csr.cu over
// CSR runs), and the per-row cull boxes it culls by.
//
// A call is two launches. First cull_boxes_kernel, one thread per face
// table row, works out the row's cull_box: the pixels where the face can
// pass the edge tests, float32 rounding included. The boxes go back to the
// caller too, since the backward kernels scan them (every pixel a face can
// own lies inside its box). Then one block takes a CULL_ROWS-row strip of
// one tile (a 128-column segment of it when the tile is wider), one thread
// per pixel: raster_strip_culled reads the list in batches with each
// face's box, keeps only the faces whose boxes meet the block's strip,
// compacted in list order, stages their coefficients in shared memory, and
// a warp tests only the kept faces whose boxes meet its own pixels. The
// loop runs to `count` and never reads the slots behind it. Ascending order
// plus the strict z < zbuf test keeps the rule that a depth tie goes to the
// lower face id.
//
// The loop only remembers the winning face; the reciprocal and the attribute
// planes are evaluated once per pixel from the winner's row afterwards (the
// same expressions as the TPU kernels' loop body, raster_fwd.py:58-77, in
// the same order). Built with -fmad=false and IEEE division, so a kernel
// matches its plain PyTorch version, which tests every listed face at every
// pixel of its tile.

#pragma once

#include <cuda_runtime.h>

namespace dirt {

constexpr int SEG_W = 128;                    // widest segment per block
constexpr int NCOEF = 14;                     // geo columns 0..13
constexpr int COL_ATT = 17;
constexpr int CULL_BATCH = 512;               // list entries culled at once
constexpr float BIG_Z = 3.0e38f;

// Columns of a block's segment: the tile's width, at most SEG_W.
__host__ __device__ inline int segment_width(int tile_w) {
  return tile_w < SEG_W ? tile_w : SEG_W;
}

// Depth, face id and the C pixel values of pixel (x, y) from the winning
// face's row (background where no face won).
__device__ __forceinline__ void write_winner(
    const float* __restrict__ table, int width, int best, float zb, float xf,
    float yf, int x, int y, const float* __restrict__ bg,
    float* __restrict__ pix, int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp) {
  const long long plane = (long long)hp * wp;
  const long long p = (long long)y * wp + x;
  zbuf[p] = zb;
  fid[p] = best;
  if (best >= 0) {
    const float* m = table + (long long)best * width;
    const float dx = xf - m[0];
    const float dy = yf - m[1];
    const float den = m[14] * dx + m[15] * dy + m[16];
    const float recip = 1.0f / den;
    for (int ch = 0; ch < channels; ++ch) {
      const float* a = m + COL_ATT + 3 * ch;
      pix[ch * plane + p] = (a[0] * dx + a[1] * dy + a[2]) * recip;
    }
  } else {
    for (int ch = 0; ch < channels; ++ch) {
      pix[ch * plane + p] = bg[ch * plane + p];
    }
  }
}

// The coverage and depth test of one face's 14 coefficients `m` at pixel
// centre (xf, yf): the face (id at `id`, read only when it wins) wins if
// its three edges are >= 0 and its depth is inside [-1, 1] and strictly
// below the buffer `zb`.
__device__ __forceinline__ void test_face(const float* m, const int* id,
                                          float xf, float yf, float& zb,
                                          int& best) {
  const float dx = xf - m[0];
  const float dy = yf - m[1];
  const float e0 = m[2] * dx + m[3] * dy + m[4];
  const float e1 = m[5] * dx + m[6] * dy + m[7];
  const float e2 = m[8] * dx + m[9] * dy + m[10];
  const float zv = m[11] * dx + m[12] * dy + m[13];
  // min(e0, e1, e2) >= 0, NaN-safe like jnp.minimum: any NaN fails.
  if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && zv < zb && zv >= -1.0f &&
      zv <= 1.0f) {
    zb = zv;
    best = *id;
  }
}

// Whether box (xmin, xmax, ymin, ymax) meets columns [x0, x1] and rows
// [y0, y1].
__device__ __forceinline__ bool box_meets(int4 box, int x0, int x1, int y0,
                                          int y1) {
  return box.x <= x1 && box.y >= x0 && box.z <= y1 && box.w >= y0;
}

constexpr int CULL_ROWS = 4;                  // rows of a culled strip
constexpr int WARP_C = 32 / CULL_ROWS;        // columns of a culled warp

// Threads of a raster_strip_culled block: CULL_ROWS rows of a segment,
// rounded up to whole warps (the warp votes need every lane).
__host__ __device__ inline int culled_threads(int tile_w) {
  return (CULL_ROWS * segment_width(tile_w) + 31) / 32 * 32;
}

// Blocks of a culled launch: one per (tile, CULL_ROWS-row strip, segment).
inline int culled_blocks(int hp, int wp, int tile_h, int tile_w) {
  return (hp / tile_h) * (wp / tile_w) * (tile_h / CULL_ROWS) *
         (tile_w / segment_width(tile_w));
}

// The tile of culled block `b` = (t * strips + s) * segs + q.
__device__ __forceinline__ int culled_tile(int b, int tile_h, int tile_w) {
  return b / ((tile_h / CULL_ROWS) * (tile_w / segment_width(tile_w)));
}

// The rounding allowance of cull_box: test_face rounds each edge value
// three times before its sign is read (dx, a*dx + b*dy, then + c; the
// kernels build with -fmad=false), which moves it by at most
// ((1 + u)^3 - 1) (|a dx| + |b dy|) <= 3.0000002 u (...), u = 2^-24;
// 4u leaves room for cull_box's own float64 rounding.
constexpr double CULL_ROUNDING = 4.0 / 16777216.0;

// The pixels whose centres lie in the triangle of edges k = 0..2 (a_k X +
// b_k Y + c_k = 0, X, Y relative to the anchor (ax, ay); det[i] the turn of
// edges i and i + 1) each moved out by CULL_ROUNDING (|a_k| mx + |b_k| my):
// (x0, x1, y0, y1) in s, neither clamped nor checked (empty when x0 > x1 or
// y0 > y1).
__device__ __forceinline__ void centre_span(
    const double (&a)[3], const double (&b)[3], const double (&c)[3],
    const double (&det)[3], double ax, double ay, double mx, double my,
    double (&s)[4]) {
  double r[3];                                // edge k moved out: aX + bY = r
  for (int k = 0; k < 3; ++k) {
    r[k] = -(c[k] + CULL_ROUNDING * (fabs(a[k]) * mx + fabs(b[k]) * my));
  }
  double xlo = 0.0, xhi = 0.0, ylo = 0.0, yhi = 0.0;
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    const double x = (r[i] * b[j] - r[j] * b[i]) / det[i];
    const double y = (a[i] * r[j] - a[j] * r[i]) / det[i];
    xlo = i == 0 ? x : fmin(xlo, x);
    xhi = i == 0 ? x : fmax(xhi, x);
    ylo = i == 0 ? y : fmin(ylo, y);
    yhi = i == 0 ? y : fmax(yhi, y);
  }
  // Pixel x's centre is x + 0.5.
  s[0] = ceil(ax + xlo - 0.5);
  s[1] = floor(ax + xhi - 0.5);
  s[2] = ceil(ay + ylo - 0.5);
  s[3] = floor(ay + yhi - 0.5);
}

// The pixels of an hp x wp array at which the face of table row `m` can
// pass test_face's three edge tests, as an inclusive box (xmin, xmax, ymin,
// ymax), clamped to the array; (0, -1, 0, -1) when there are none. It is
// worked out from the row itself, not from the face's vertices: with f32
// rounding, a needle whose far vertices lie thousands of pixels off the
// image passes at pixels tens of pixels past the box of its vertices
// (tests/test_torch_cull.py). Edge k passes at pixel centre p only where
// a_k X + b_k Y + c_k >= -CULL_ROUNDING (|a_k| MX + |b_k| MY) (X, Y =
// p - anchor exactly, MX, MY bounds of their magnitudes over the pixels
// that can pass): the box of the pixel centres inside the triangle of the
// three edges each moved out by that much, whose corners are solved for in
// float64. Two rounds: the first takes MX, MY over the whole array; every
// pixel that passes lies in its box, so the second takes them over that
// box. The second matters for a sliver (edges a few millionths of a radian
// apart), whose corners move by the allowance over the angle: from the
// whole array's MX a face of 8 x 5 pixels gets a box of 113 x 49. A row
// with a non-finite coefficient, or whose edges do not close a triangle,
// gets the whole array; a row with an edge that excludes every pixel (a =
// b = 0, c < 0: an invalid face) gets none. Computed in float64 with
// -fmad=false, it equals raster_fwd.py's csr_cull_boxes_plain bit for bit.
__device__ __forceinline__ int4 cull_box(const float* __restrict__ m,
                                         int hp, int wp) {
  const int4 none = make_int4(0, -1, 0, -1);
  const double ax = m[0];
  const double ay = m[1];
  double a[3], b[3], c[3];
  bool finite = isfinite(ax) && isfinite(ay);
  bool never = false;
  for (int k = 0; k < 3; ++k) {
    a[k] = m[2 + 3 * k];
    b[k] = m[3 + 3 * k];
    c[k] = m[4 + 3 * k];
    finite = finite && isfinite(a[k]) && isfinite(b[k]) && isfinite(c[k]);
    never = never || (a[k] == 0.0 && b[k] == 0.0 && c[k] < 0.0);
  }
  if (!finite) return make_int4(0, wp - 1, 0, hp - 1);
  if (never) return none;
  double det[3];
  int sign = 0;
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    det[i] = a[i] * b[j] - a[j] * b[i];
    const int s = det[i] > 0.0 ? 1 : (det[i] < 0.0 ? -1 : 0);
    // The edges close a triangle when all three turns agree.
    if (s == 0 || (i > 0 && s != sign)) {
      return make_int4(0, wp - 1, 0, hp - 1);
    }
    sign = s;
  }
  double mx = fmax(fabs(0.5 - ax), fabs((wp - 0.5) - ax));
  double my = fmax(fabs(0.5 - ay), fabs((hp - 0.5) - ay));
  double box[4];
  for (int round = 0; round < 2; ++round) {
    centre_span(a, b, c, det, ax, ay, mx, my, box);
    if (!(box[0] <= box[1] && box[2] <= box[3] && box[1] >= 0.0 &&
          box[0] <= wp - 1.0 && box[3] >= 0.0 && box[2] <= hp - 1.0)) {
      return none;
    }
    box[0] = fmax(box[0], 0.0);
    box[1] = fmin(box[1], wp - 1.0);
    box[2] = fmax(box[2], 0.0);
    box[3] = fmin(box[3], hp - 1.0);
    mx = fmax(fabs((box[0] + 0.5) - ax), fabs((box[1] + 0.5) - ax));
    my = fmax(fabs((box[2] + 0.5) - ay), fabs((box[3] + 0.5) - ay));
  }
  return make_int4((int)box[0], (int)box[1], (int)box[2], (int)box[3]);
}

// Scan-convert list[0 .. count) over a CULL_ROWS-row strip of tile `t`, for
// a block of culled_threads(tile_w) threads, and write the strip's pixels,
// face ids and depths. Every thread of the block calls it with the same
// list and count (it synchronises the block).
//   table: [rows, width] f32 face table (17 geometry columns, then 3 per
//          channel); bg, pix: [channels, hp, wp]; fid, zbuf: [hp, wp].
// The list is culled by the faces' cull_box: the result is that of testing
// every listed face at every pixel, bit for bit, because a face cannot pass
// test_face at a pixel outside its cull_box, so the faces left out could
// not have won there.
//   boxes: [rows, 4] int32, cull_box of every table row.
// A batch: each of its threads reads one list entry and that face's box,
// and keeps it if the box meets the strip; warp votes and per-warp counts
// compact the kept faces in list order (ascending: the tie rule holds), and
// only their 14 coefficients are gathered. In the test loop each lane
// checks one kept face's box against its warp's pixels, the warp votes, and
// it tests only the faces that meet it, in order: the skip is
// warp-uniform. A warp's pixels are the strip's 4 rows x WARP_C = 8
// columns when the segment is a multiple of 8 wide (a face a few pixels
// across meets fewer such warps than 1 x 32 runs), else consecutive pixels
// in row order.
__device__ __forceinline__ void raster_strip_culled(
    const float* __restrict__ table, int width, const int* __restrict__ list,
    int count, const int4* __restrict__ boxes, const float* __restrict__ bg,
    float* __restrict__ pix, int* __restrict__ fid, float* __restrict__ zbuf,
    int channels, int hp, int wp, int tile_h, int tile_w, int t) {
  __shared__ int s_id[CULL_BATCH];
  __shared__ int4 s_box[CULL_BATCH];
  __shared__ float s_coef[CULL_BATCH * NCOEF];
  __shared__ int s_kept[CULL_BATCH / 32];    // kept faces per warp's entries

  const int seg_w = segment_width(tile_w);
  const int strips = tile_h / CULL_ROWS;
  const int segs = tile_w / seg_w;
  const int tiles_x = wp / tile_w;
  const int q = blockIdx.x % segs;
  const int s = (blockIdx.x / segs) % strips;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pixels = CULL_ROWS * seg_w;       // threads past it have none
  const int x0 = (t % tiles_x) * tile_w + q * seg_w;
  const int y0 = (t / tiles_x) * tile_h + s * CULL_ROWS;
  // This thread's pixel (r, c) of the strip and its warp's span of pixels,
  // [wx0, wx1] x [wy0, wy1].
  int r, c, wx0, wx1, wy0, wy1;
  if (seg_w % WARP_C == 0) {
    const int wc = tid >> 5;                  // the warp's column group
    r = lane / WARP_C;
    c = wc * WARP_C + lane % WARP_C;
    wx0 = x0 + wc * WARP_C;
    wx1 = wx0 + WARP_C - 1;
    wy0 = y0;
    wy1 = y0 + CULL_ROWS - 1;
  } else {
    r = tid / seg_w;
    c = tid - r * seg_w;
    const int first = tid - lane;
    const int last = min(first + 31, pixels - 1);
    const int r0 = first / seg_w, r1 = last / seg_w;
    wx0 = x0 + (r0 == r1 ? first - r0 * seg_w : 0);
    wx1 = x0 + (r0 == r1 ? last - r1 * seg_w : seg_w - 1);
    wy0 = y0 + r0;
    wy1 = y0 + r1;
  }
  const int x = x0 + c;
  const int y = y0 + r;
  const float xf = (float)x + 0.5f;
  const float yf = (float)y + 0.5f;
  const int batch = min((int)blockDim.x, CULL_BATCH);  // whole warps

  float zb = BIG_Z;
  int best = -1;                              // winning face id
  for (int i0 = 0; i0 < count; i0 += batch) {
    int face = 0;
    int4 box = make_int4(0, -1, 0, -1);
    bool keep = false;
    unsigned vote = 0;
    if (tid < batch) {
      if (i0 + tid < count) {
        face = list[i0 + tid];
        box = boxes[face];
        keep = box_meets(box, x0, x0 + seg_w - 1, y0, y0 + CULL_ROWS - 1);
      }
      vote = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_kept[tid >> 5] = __popc(vote);
    }
    __syncthreads();                          // also: last batch tested
    int kept = 0, before = 0;
    for (int w = 0; w < batch / 32; ++w) {
      const int k = s_kept[w];
      before += w < (tid >> 5) ? k : 0;
      kept += k;
    }
    if (keep) {
      const int at = before + __popc(vote & ((1u << lane) - 1u));
      s_id[at] = face;
      s_box[at] = box;
    }
    __syncthreads();
    if (kept == 0) continue;                  // the same in every thread
    for (int k = tid; k < kept * NCOEF; k += blockDim.x) {
      const int j = k / NCOEF;
      s_coef[k] = table[(long long)s_id[j] * width + (k - j * NCOEF)];
    }
    __syncthreads();
    for (int j0 = 0; j0 < kept; j0 += 32) {
      const int j = j0 + lane;
      const bool meets =
          j < kept && box_meets(s_box[j], wx0, wx1, wy0, wy1);
      unsigned hits = __ballot_sync(0xffffffffu, meets);
      while (hits) {
        const int k = j0 + __ffs(hits) - 1;
        hits &= hits - 1u;
        test_face(s_coef + k * NCOEF, s_id + k, xf, yf, zb, best);
      }
    }
  }
  if (tid < pixels) {
    write_winner(table, width, best, zb, xf, yf, x, y, bg, pix, fid, zbuf,
                 channels, hp, wp);
  }
}

constexpr int BOX_THREADS = 256;

// cull_box of every table row: boxes[f] for f < rows.
__global__ void __launch_bounds__(BOX_THREADS)
cull_boxes_kernel(const float* __restrict__ table, int width, int rows,
                  int4* __restrict__ boxes, int hp, int wp) {
  const int f = blockIdx.x * BOX_THREADS + threadIdx.x;
  if (f < rows) {
    boxes[f] = cull_box(table + (long long)f * width, hp, wp);
  }
}

// Launches cull_boxes_kernel on `stream` (nothing for rows == 0); `boxes`
// is [rows, 4] int32, 16-byte aligned.
inline void launch_cull_boxes(const float* table, int width, int rows,
                              int* boxes, int hp, int wp,
                              cudaStream_t stream) {
  if (rows > 0) {
    cull_boxes_kernel<<<(rows + BOX_THREADS - 1) / BOX_THREADS, BOX_THREADS,
                        0, stream>>>(table, width, rows,
                                     reinterpret_cast<int4*>(boxes), hp, wp);
  }
}

}  // namespace dirt
