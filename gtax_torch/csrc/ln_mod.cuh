// The body of the ln_mod kernel as a device function over one row, shared
// by ln_mod.cu (one block per row) and the paired int8 kernels of
// pair_q.cu (rows strided over a cooperative grid). Both run it with 256
// threads, so a row's reductions are summed in the same order and the
// results are bit-equal.
#pragma once

#include "common.cuh"

constexpr int kLnThreads = 256;

template <bool MAX>
__device__ __forceinline__ float ln_block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < (kLnThreads / 32) ? red[lane] : 0.f;
    t = MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  t = red[32];
  __syncthreads();
  return t;
}

enum LnMode {
  LN_MODULATE_BF16 = 0,  // bf16(LN(x) * (1 + scale[f] + 1e-6) + shift[f])
  LN_AFFINE_BF16 = 1,    // bf16(LN(x) * weight + bias), fp32 (D,) params
  LN_MODULATE_INT8 = 2,  // the mode-0 row in fp32, int8 + per-row scale
  LN_MODULATE_F32 = 3,   // mode 0 over fp32 x, shift, scale: fp32 out
  LN_AFFINE_F32 = 4,     // mode 1 over fp32 x: fp32 out
  LN_MODULATE_INT8_F32 = 5,  // mode 2 over fp32 x, shift, scale
};

// An element of a bf16 or fp32 row as fp32, and its store: rounded to
// bf16, or as it is.
__device__ __forceinline__ float ld_f(const bf16* p) { return bf2f(*p); }
__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ void st_f(bf16* p, float v) { *p = f2bf(v); }
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }

// One row of ln_mod over x of element type T (bf16, or fp32 for the
// entry point's modes 3, 4 and 5, which run modes 0, 1 and 2 here with T =
// float: the same arithmetic, nothing rounded before the int8 rounding of
// mode 2): LayerNorm in fp32, then
// mode 0: out = T(LN(x) * (1 + scale[f] + 1e-6) + shift[f]), f = row / S,
//         shift/scale T rows of stride p_stride (gtax/nn/layers.py modulate)
// mode 1: out = T(LN(x) * weight + bias), weight/bias fp32 (D,)
// mode 2: the mode-0 row in fp32, quantized: out int8, row_scale[row] fp32
//         (gtax/kernels/quant.py _ln_modulate32 + _quant_rows); the
//         modulate is rounded op by op, as the plain version computes it
// red: 33 floats of shared memory; mod_row: D floats of shared memory
// (mode 2). Needs kLnThreads threads in the block.
template <typename T>
__device__ __forceinline__ void ln_mod_row(
    const T* __restrict__ x, void* __restrict__ out,
    float* __restrict__ row_scale, const void* __restrict__ p0,
    const void* __restrict__ p1, int D, int S, int p_stride, int mode,
    size_t row, float* red, float* mod_row) {
  const T* xr = x + row * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += kLnThreads) s += ld_f(xr + c);
  const float mean = ln_block_reduce<false>(s, red) / D;
  float q = 0.f;
  for (int c = threadIdx.x; c < D; c += kLnThreads) {
    const float d = ld_f(xr + c) - mean;
    q = fmaf(d, d, q);  // explicit, so every caller rounds alike
  }
  const float var = ln_block_reduce<false>(q, red) / D;
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
  if (mode == LN_AFFINE_BF16) {
    T* orow = static_cast<T*>(out) + row * D;
    const float* w = static_cast<const float*>(p0);
    const float* b = static_cast<const float*>(p1);
    for (int c = threadIdx.x; c < D; c += kLnThreads) {
      const float ln = (ld_f(xr + c) - mean) * rstd;
      st_f(orow + c, ln * w[c] + b[c]);
    }
    return;
  }
  const size_t f = row / S;
  const T* shift = static_cast<const T*>(p0) + f * p_stride;
  const T* scale = static_cast<const T*>(p1) + f * p_stride;
  if (mode == LN_MODULATE_BF16) {
    T* orow = static_cast<T*>(out) + row * D;
    for (int c = threadIdx.x; c < D; c += kLnThreads) {
      const float ln = (ld_f(xr + c) - mean) * rstd;
      st_f(orow + c,
           ln * ((1.0f + ld_f(scale + c)) + 1e-6f) + ld_f(shift + c));
    }
    return;
  }
  float amax = 0.f;
  for (int c = threadIdx.x; c < D; c += kLnThreads) {
    const float ln = __fmul_rn(__fsub_rn(ld_f(xr + c), mean), rstd);
    const float m = __fadd_rn(
        __fmul_rn(ln, __fadd_rn(__fadd_rn(1.0f, ld_f(scale + c)), 1e-6f)),
        ld_f(shift + c));
    mod_row[c] = m;
    amax = fmaxf(amax, fabsf(m));
  }
  const float sc = int8_scale(ln_block_reduce<true>(amax, red));
  const float inv = __fdiv_rn(1.0f, sc);
  signed char* orow = static_cast<signed char*>(out) + row * D;
  for (int c = threadIdx.x; c < D; c += kLnThreads)
    orow[c] = int8_round(mod_row[c], inv);
  if (threadIdx.x == 0) row_scale[row] = sc;
}
