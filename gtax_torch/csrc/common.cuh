// Shared helpers of the port's hand-written sm_90a kernels.
//
// Every kernel here is bound through a plain C entry point (ctypes, see
// gtax_torch/kernels/build.py): pointers and the stream arrive as void*,
// sizes as int, and each entry returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// round-to-nearest-even, the rounding of jnp.astype / torch .to(bfloat16)
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Two neighbouring elements (c, c+1) of a row that is fp32 or bf16 in
// memory; c is even, so both loads are naturally aligned.
__device__ __forceinline__ float2 load_pair(const void* base, int is_f32,
                                            size_t idx) {
  if (is_f32) return *reinterpret_cast<const float2*>(
      static_cast<const float*>(base) + idx);
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(
          static_cast<const bf16*>(base) + idx));
}

__device__ __forceinline__ void store_pair(bf16* base, size_t idx, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(base + idx) = __floats2bfloat162_rn(a, b);
}
// the same pair stored to an fp32 row as it is (idx even: 8-byte aligned)
__device__ __forceinline__ void store_pair(float* base, size_t idx, float a,
                                           float b) {
  *reinterpret_cast<float2*>(base + idx) = make_float2(a, b);
}

// Eight bf16 of a row (16 bytes) through the read-only path.
__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// A bias vector that is fp32 or bf16 in memory, as the wrapper was given it.
__device__ __forceinline__ float load_bias(const void* bias, int bias_f32,
                                           int n) {
  return bias_f32 ? static_cast<const float*>(bias)[n]
                  : bf2f(static_cast<const bf16*>(bias)[n]);
}

// 16-byte global -> shared copy; src_bytes < 16 zero-fills the rest (the
// GEMMs' ragged M rows pass 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic symmetric int8 of a row (gtax/kernels/quant.py _quant_rows):
// s = max(amax, 1e-12) * (1/127), q = round_half_even(a * (1/s)); a
// reciprocal then a multiply, each rounded once (no contraction).
__device__ __forceinline__ float int8_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}
__device__ __forceinline__ signed char int8_round(float v, float inv_scale) {
  return (signed char)__float2int_rn(__fmul_rn(v, inv_scale));
}

// Rotary embedding of one interleaved pair (x[c], x[c+1]) in fp32:
// x * cos + rotate_half(x) * sin, rotate_half(x)[c] = -x[c+1],
// rotate_half(x)[c+1] = x[c] (gtax/core/rope.py rotate_half).
__device__ __forceinline__ float2 rope_pair(float2 x, const float* freqs) {
  float s0, c0, s1, c1;
  sincosf(freqs[0], &s0, &c0);
  sincosf(freqs[1], &s1, &c1);
  return make_float2(x.x * c0 + (-x.y) * s0, x.y * c1 + x.x * s1);
}

// Adjoint of rope_pair (gtax/nn/branches.py _rope_transpose): u * cos -
// rotate_half(u * sin), i.e. (u[c] c0 + u[c+1] s1, u[c+1] c1 - u[c] s0),
// each product and sum rounded as the plain version's.
__device__ __forceinline__ float2 rope_pair_t(float2 u, const float* freqs) {
  float s0, c0, s1, c1;
  sincosf(freqs[0], &s0, &c0);
  if (freqs[1] == freqs[0]) {  // the repo's tables repeat each angle
    s1 = s0;
    c1 = c0;
  } else {
    sincosf(freqs[1], &s1, &c1);
  }
  return make_float2(__fadd_rn(__fmul_rn(u.x, c0), __fmul_rn(u.y, s1)),
                     __fsub_rn(__fmul_rn(u.y, c1), __fmul_rn(u.x, s0)));
}

// rope_pair and rope_pair_t with the pair's cos and sin already formed
// (sincosf of freqs[0] -> c0, s0 and of freqs[1] -> c1, s1): the same
// expressions, for a caller that forms each angle's factors once for
// many pairs.
__device__ __forceinline__ float2 rope_pair_cs(float2 x, float c0, float s0,
                                               float c1, float s1) {
  return make_float2(x.x * c0 + (-x.y) * s0, x.y * c1 + x.x * s1);
}
// rope_pair_cs with its roundings fixed: each component's first product
// fused into its sum, the second rounded first (x c0 + (-y s0)), whatever
// code surrounds it, so that two kernels roping the same values give the
// same bits (the fp32 frame attention's rope pass and the fp32 spatial
// pair's qkv epilogue; the compiler may fuse either product of
// rope_pair_cs's sums).
__device__ __forceinline__ float2 rope_pair_fma(float2 x, float4 f) {
  return make_float2(fmaf(x.x, f.x, __fmul_rn(-x.y, f.y)),
                     fmaf(x.y, f.z, __fmul_rn(x.x, f.w)));
}
__device__ __forceinline__ float2 rope_pair_t_cs(float2 u, float c0,
                                                 float s0, float c1,
                                                 float s1) {
  return make_float2(__fadd_rn(__fmul_rn(u.x, c0), __fmul_rn(u.y, s1)),
                     __fsub_rn(__fmul_rn(u.y, c1), __fmul_rn(u.x, s0)));
}

// cos and sin of eight neighbouring angles, each by sincosf as rope_pair
// and rope_pair_t form them (a pair's second angle equal to its first, as
// the repo's tables have it, takes the first's values: the same bits).
__device__ __forceinline__ void sincos8(const float* freqs, float (&c)[8],
                                        float (&s)[8]) {
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    sincosf(freqs[i], &s[i], &c[i]);
    if (freqs[i + 1] == freqs[i]) {
      s[i + 1] = s[i];
      c[i + 1] = c[i];
    } else {
      sincosf(freqs[i + 1], &s[i + 1], &c[i + 1]);
    }
  }
}

// rope_pair_t from fp32 cos and sin tables (gtax's own form: cos/sin of the
// rotary table, as the plain version computes them), entry idx and idx + 1.
__device__ __forceinline__ float2 rope_pair_t_tab(float2 u, const float* cosb,
                                                  const float* sinb,
                                                  size_t idx) {
  const float2 c = *reinterpret_cast<const float2*>(cosb + idx);
  const float2 s = *reinterpret_cast<const float2*>(sinb + idx);
  return make_float2(__fadd_rn(__fmul_rn(u.x, c.x), __fmul_rn(u.y, s.y)),
                     __fsub_rn(__fmul_rn(u.y, c.y), __fmul_rn(u.x, s.x)));
}

// The most dynamic shared memory a block may opt into on sm_90 (227 KB).
constexpr size_t kSmemMax = 232448;

// A kernel's dynamic shared memory above 48 KB, opted into once per larger
// size (opted: the size the kernel already takes, per instantiation).
template <class Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem, size_t& opted) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem <= opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) opted = smem;
  return e;
}

// A probe build of the attention kernels (gtax_torch/kernels/build.py
// probe_library, for gtax_torch/tools/attn_sweep.py) defines this to stop
// them early and time their phases: 0 after staging, 1 after attn_sdpa's
// first pass over the keys or attn_frame_bwd's phase A. The library is
// built without it and runs them whole.
#ifndef GTAX_PROBE_STOP
#define GTAX_PROBE_STOP 2
#endif

#define GTAX_ENTRY extern "C" __attribute__((visibility("default"))) int
