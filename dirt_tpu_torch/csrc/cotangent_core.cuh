// The per-pixel cotangent core shared by the backward kernels (packed_bwd.cu;
// fused_bwd.cu and fused_bwd_csr.cu through fused_rows.cuh): the CUDA form
// of raster_bwd.pixel_cotangents_core with the pre-combined (active bit,
// sval) neighbor inputs, for ONE covered pixel.
//
// Every expression is written in the order of the PyTorch function, and the
// sources are built with -fmad=false and IEEE division, so each product, sum
// and quotient rounds like the plain version's.

#pragma once

namespace dirt {

constexpr float A_EPS = 1e-12f;

// Cotangents of the pixel at flat index `p` of [hp, wp] planes (`plane` =
// hp * wp) with respect to its owning face's planes.
//   m:     the owner's 17 geometry columns (triangle_setup's geo layout);
//   dx,dy: pixel center minus the owner's anchor (m[0], m[1]);
//   grad, pix: [C, hp, wp]; sval: [4, hp, wp]; pair_bits: bit n =
//          boundary_cases()[n]'s pair & front test (right, left, below,
//          above).
// Calls put(k, value) once for each of the 12 + 3C columns
// [9 edge | 3 denominator | 3C attribute].
template <class Put>
__device__ __forceinline__ void pixel_cotangents(
    const float* __restrict__ m, float dx, float dy, int channels,
    const float* __restrict__ grad, const float* __restrict__ pix,
    long long plane, long long p, int pair_bits,
    const float* __restrict__ sval, Put put) {
  // Interior term.
  const float den = m[14] * dx + m[15] * dy + m[16];
  const float recip = 1.0f / den;
  float s_acc = 0.0f;
  for (int ch = 0; ch < channels; ++ch) {
    const float g_c = grad[ch * plane + p];
    const float w_c = g_c * recip;
    put(12 + 3 * ch, w_c * dx);
    put(13 + 3 * ch, w_c * dy);
    put(14 + 3 * ch, w_c);
    s_acc = s_acc + g_c * pix[ch * plane + p];
  }
  const float t_den = -recip * s_acc;
  put(9, t_den * dx);
  put(10, t_den * dy);
  put(11, t_den);

  // Boundary term: boundary_cases() = right, left, below, above.
  float a_e[3], b_e[3], e_own[3], acc[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a_e[j] = m[2 + 3 * j];
    b_e[j] = m[3 + 3 * j];
    e_own[j] = a_e[j] * dx + b_e[j] * dy + m[4 + 3 * j];
    acc[j][0] = acc[j][1] = acc[j][2] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const bool horizontal = n < 2;
    const float off = (n == 0 || n == 2) ? 1.0f : -1.0f;
    const bool active = (pair_bits >> n) & 1;
    const float s_val = sval[n * plane + p];
    bool chosen = false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float a_j = a_e[j], b_j = b_e[j], e_j = e_own[j];
      const float slope = horizontal ? a_j : b_j;
      const float e_back = e_j + off * slope;
      const bool crossing = e_j >= 0.0f && e_back < 0.0f && !chosen;
      chosen = chosen || crossing;
      const float denom = fabsf(a_j) + fabsf(b_j);
      const float d_own = horizontal ? dx : dy;
      const bool guard = fabsf(slope) >= A_EPS;
      const float safe = guard ? slope : 1.0f;
      const float coord = d_own - e_j / safe;
      const float d_back = d_own + off;
      const float lo_c = fminf(d_own, d_back);
      const float hi_c = fmaxf(d_own, d_back);
      const float cross = fminf(fmaxf(coord, lo_c), hi_c);
      const float v0 = horizontal ? cross : dx;
      const float v1 = horizontal ? dy : cross;
      const float scale = (active && crossing && guard && denom >= A_EPS)
                              ? s_val / fmaxf(denom, A_EPS)
                              : 0.0f;
      acc[j][0] = acc[j][0] + scale * v0;
      acc[j][1] = acc[j][1] + scale * v1;
      acc[j][2] = acc[j][2] + scale;
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    put(3 * j, acc[j][0]);
    put(3 * j + 1, acc[j][1]);
    put(3 * j + 2, acc[j][2]);
  }
}

}  // namespace dirt
