// The body of the quant_rows kernel as a device function over one (row,
// group) unit, run by one warp, shared by quant_rows.cu (eight units a
// block) and the paired int8 kernels of pair_q.cu (units strided over the
// warps of a cooperative grid). The abs-max is exact in any order and each
// element is rounded alone, so every caller gives bit-equal results.
#pragma once

#include "common.cuh"

// Unit u quantizes group u % n_groups of row u / n_groups: the G values at
// a + u * G (groups tile the rows; G a multiple of 4); scale[u] is its
// scale, so scale is (rows, n_groups) row-major.
__device__ __forceinline__ void quant_rows_unit(const float* __restrict__ a,
                                                signed char* __restrict__ q,
                                                float* __restrict__ scale,
                                                int G, size_t u) {
  const int lane = threadIdx.x & 31;
  const float4* src = reinterpret_cast<const float4*>(a + u * G);
  constexpr int kHeld = 8;  // float4s a lane keeps (G up to 1024)
  float4 v[kHeld];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int c = lane + 32 * i;
    if (c * 4 < G) {
      v[i] = src[c];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                         fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
  }
  for (int c = lane + 32 * kHeld; c * 4 < G; c += 32) {  // wider groups
    const float4 w = src[c];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(w.x), fabsf(w.y)),
                       fmaxf(fabsf(w.z), fabsf(w.w))));
  }
  const float sc = int8_scale(warp_max(m));
  const float inv = __fdiv_rn(1.0f, sc);
  char4* dst = reinterpret_cast<char4*>(q + u * G);
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int c = lane + 32 * i;
    if (c * 4 < G)
      dst[c] = make_char4(int8_round(v[i].x, inv), int8_round(v[i].y, inv),
                          int8_round(v[i].z, inv), int8_round(v[i].w, inv));
  }
  for (int c = lane + 32 * kHeld; c * 4 < G; c += 32) {
    const float4 w = src[c];
    dst[c] = make_char4(int8_round(w.x, inv), int8_round(w.y, inv),
                        int8_round(w.z, inv), int8_round(w.w, inv));
  }
  if (lane == 0) scale[u] = sc;
}
