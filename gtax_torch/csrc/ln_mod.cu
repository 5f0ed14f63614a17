// LayerNorm rows in fp32, then either the DiT adaLN modulate or an affine,
// written as bf16, or the modulate quantized to int8 with a per-row scale:
// the first stage of every fused branch.
//
// Replaces the LN/modulate prologue that each TPU kernel ran in VMEM
// (gtax/kernels/block.py _ln_modulate32, gtax/kernels/vae_block.py ln) and,
// for the int8 branches, the _quant_rows of the fp32 modulate output that
// follows it (gtax/kernels/quant.py _qdot).
// Bound: bytes. One read of x and one write of the result, a few
// operations per byte; one block per row keeps the reductions in shared
// memory and each row is read from L1 the second and third time. The int8
// mode keeps its fp32 row in shared memory (never in device memory) between
// the abs-max reduction and the rounding pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < (kThreads / 32) ? red[lane] : 0.f;
    t = MAX ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  t = red[32];
  __syncthreads();
  return t;
}

// mode 0: out = bf16(LN(x) * (1 + scale[f] + 1e-6) + shift[f]), f = row / S,
//         shift/scale bf16 rows of stride p_stride (gtax/nn/layers.py modulate)
// mode 1: out = bf16(LN(x) * weight + bias), weight/bias fp32 (D,)
// mode 2: the mode-0 row in fp32, quantized: out int8, row_scale[row] fp32
//         (gtax/kernels/quant.py _ln_modulate32 + _quant_rows); the
//         modulate is rounded op by op, as the plain version computes it
__global__ void ln_mod_kernel(const bf16* __restrict__ x, void* __restrict__ out,
                              float* __restrict__ row_scale,
                              const void* __restrict__ p0,
                              const void* __restrict__ p1, int D, int S,
                              int p_stride, int mode) {
  __shared__ float red[33];
  extern __shared__ float mod_row[];  // D floats in mode 2
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) s += bf2f(xr[c]);
  const float mean = block_reduce<false>(s, red) / D;
  float q = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float d = bf2f(xr[c]) - mean;
    q += d * d;
  }
  const float var = block_reduce<false>(q, red) / D;
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
  if (mode == 1) {
    bf16* orow = static_cast<bf16*>(out) + row * D;
    const float* w = static_cast<const float*>(p0);
    const float* b = static_cast<const float*>(p1);
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float ln = (bf2f(xr[c]) - mean) * rstd;
      orow[c] = f2bf(ln * w[c] + b[c]);
    }
    return;
  }
  const size_t f = row / S;
  const bf16* shift = static_cast<const bf16*>(p0) + f * p_stride;
  const bf16* scale = static_cast<const bf16*>(p1) + f * p_stride;
  if (mode == 0) {
    bf16* orow = static_cast<bf16*>(out) + row * D;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float ln = (bf2f(xr[c]) - mean) * rstd;
      orow[c] = f2bf(ln * ((1.0f + bf2f(scale[c])) + 1e-6f) + bf2f(shift[c]));
    }
    return;
  }
  float amax = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float ln = __fmul_rn(__fsub_rn(bf2f(xr[c]), mean), rstd);
    const float m = __fadd_rn(
        __fmul_rn(ln, __fadd_rn(__fadd_rn(1.0f, bf2f(scale[c])), 1e-6f)),
        bf2f(shift[c]));
    mod_row[c] = m;
    amax = fmaxf(amax, fabsf(m));
  }
  const float sc = int8_scale(block_reduce<true>(amax, red));
  const float inv = __fdiv_rn(1.0f, sc);
  signed char* orow = static_cast<signed char*>(out) + row * D;
  for (int c = threadIdx.x; c < D; c += kThreads)
    orow[c] = int8_round(mod_row[c], inv);
  if (threadIdx.x == 0) row_scale[row] = sc;
}

}  // namespace

GTAX_ENTRY gtax_ln_mod(const void* x, void* out, void* row_scale,
                       const void* p0, const void* p1, int rows, int D, int S,
                       int p_stride, int mode, void* stream) {
  if (rows <= 0 || D <= 0 || S <= 0 || mode < 0 || mode > 2 ||
      (mode == 2 && row_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = mode == 2 ? (size_t)D * sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  ln_mod_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), out, static_cast<float*>(row_scale), p0, p1,
      D, S, p_stride, mode);
  return (int)cudaGetLastError();
}
