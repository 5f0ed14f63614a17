// The body of the quant_rows kernel as a device function over one (row,
// group) unit, shared by quant_rows.cu (one block per unit, 128 threads)
// and the paired int8 kernels of pair_q.cu (units strided over a
// cooperative grid, 256 threads). The abs-max is exact in any order, so
// both give bit-equal results.
#pragma once

#include "common.cuh"

// Unit u quantizes group u % n_groups of row u / n_groups: the G values at
// a + u * G (groups tile the rows); scale[u] is its scale, so scale is
// (rows, n_groups) row-major. red: kThreads / 32 floats of shared memory.
template <int kThreads>
__device__ __forceinline__ void quant_rows_unit(const float* __restrict__ a,
                                                signed char* __restrict__ q,
                                                float* __restrict__ scale,
                                                int G, size_t u, float* red) {
  const size_t off = u * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = 0.f;
  for (int c = threadIdx.x; c < G; c += kThreads)
    m = fmaxf(m, fabsf(a[off + c]));
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float sc = int8_scale(m);
  const float inv = __fdiv_rn(1.0f, sc);
  for (int c = threadIdx.x; c < G; c += kThreads)
    q[off + c] = int8_round(a[off + c], inv);
  if (threadIdx.x == 0) scale[u] = sc;
}
