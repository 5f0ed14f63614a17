// LayerNorm rows in fp32, then either the DiT adaLN modulate or an affine,
// written as bf16: the first stage of every fused branch.
//
// Replaces the LN/modulate prologue that each TPU kernel ran in VMEM
// (gtax/kernels/block.py _ln_modulate32, gtax/kernels/vae_block.py ln).
// Bound: bytes. One read of x and one write of the result, a few
// operations per byte; one block per row keeps the two reductions in
// shared memory and each row is read from L1 the second and third time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < (kThreads / 32) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  t = red[32];
  __syncthreads();
  return t;
}

// mode 0: out = LN(x) * (1 + scale[f] + 1e-6) + shift[f], f = row / S,
//         shift/scale bf16 rows of stride p_stride (gtax/nn/layers.py modulate)
// mode 1: out = LN(x) * weight + bias, weight/bias fp32 (D,)
__global__ void ln_mod_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                              const void* __restrict__ p0,
                              const void* __restrict__ p1, int D, int S,
                              int p_stride, int mode) {
  __shared__ float red[33];
  const size_t row = blockIdx.x;
  const bf16* xr = x + row * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) s += bf2f(xr[c]);
  const float mean = block_sum(s, red) / D;
  float q = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float d = bf2f(xr[c]) - mean;
    q += d * d;
  }
  const float var = block_sum(q, red) / D;
  const float rstd = 1.0f / sqrtf(var + 1e-6f);
  bf16* orow = out + row * D;
  if (mode == 0) {
    const size_t f = row / S;
    const bf16* shift = static_cast<const bf16*>(p0) + f * p_stride;
    const bf16* scale = static_cast<const bf16*>(p1) + f * p_stride;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float ln = (bf2f(xr[c]) - mean) * rstd;
      orow[c] = f2bf(ln * ((1.0f + bf2f(scale[c])) + 1e-6f) + bf2f(shift[c]));
    }
  } else {
    const float* w = static_cast<const float*>(p0);
    const float* b = static_cast<const float*>(p1);
    for (int c = threadIdx.x; c < D; c += kThreads) {
      const float ln = (bf2f(xr[c]) - mean) * rstd;
      orow[c] = f2bf(ln * w[c] + b[c]);
    }
  }
}

}  // namespace

GTAX_ENTRY gtax_ln_mod(const void* x, void* out, const void* p0, const void* p1,
                       int rows, int D, int S, int p_stride, int mode,
                       void* stream) {
  if (rows <= 0 || D <= 0 || S <= 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  ln_mod_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), p0, p1, D, S,
      p_stride, mode);
  return (int)cudaGetLastError();
}
