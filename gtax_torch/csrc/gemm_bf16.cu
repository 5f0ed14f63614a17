// bf16 GEMM with fp32 accumulation on the tensor cores and the epilogues
// the fused branches need: C = epilogue(A @ B), A (M, K) row-major bf16,
// B (K, N) row-major bf16 (gtax's (in, out) kernel layout).
//
// Replaces the in-kernel jnp.dot calls of the TPU branch kernels
// (gtax/kernels/block.py _kernel/_mlp_kernel/_temporal_kernel/
// _temporal_step_kernel, gtax/kernels/vae_block.py _vae_block_kernel).
// Bound: at the serving shapes (M = 144..3456 rows, K, N = 1024..4096) the
// weight bytes dominate at small M and the tensor-core rate at large M.
// Design: 64x64 block tiles, 4 warps of 32x32 wmma 16x16x16 fragments, a
// two-stage cp.async ring over K, zero-filled ragged M rows (144 is not a
// multiple of 64), and an epilogue that goes through shared memory so every
// output row is written with coalesced stores. Later work: wgmma + TMA.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int APAD = 8, BPAD = 8, CPAD = 4;
constexpr int kThreads = 128;

enum Epi {
  EPI_F32 = 0,              // fp32 C = acc
  EPI_BIAS_BF16 = 1,        // bf16(acc + bias)
  EPI_BIAS_GELU_TANH = 2,   // bf16(gelu_tanh(acc + bias))
  EPI_BIAS_BF16_GELU = 3,   // bf16(gelu_erf(bf16(acc + bias)))
  EPI_BIAS_GATED = 4,       // bf16(x + gate[row / S] * (acc + bias))
  EPI_BIAS_BF16_RESID = 5,  // bf16(x + bf16(acc + bias))
};

struct TilesAB {
  bf16 a[2][BM][BK + APAD];
  bf16 b[2][BK][BN + BPAD];
};
union Smem {
  TilesAB ab;
  float c[BM][BN + CPAD];
};

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) *
// (x + 0.044715 * x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.0f + tanhf(0.7978845608028654f *
                                   (x + 0.044715f * (x * x * x)))));
}

// exact (erf) GELU; the TPU kernel approximated erf (A-S 7.1.26, abs err
// <= 1.5e-7), erff is exact to a few ulp
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                void* __restrict__ C, const void* __restrict__ bias,
                int bias_f32, const bf16* __restrict__ resid,
                const bf16* __restrict__ gate, int gate_stride, int M, int N,
                int K, int S) {
  __shared__ __align__(128) unsigned char raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 chunks of 8
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 2, c = (chunk & 3) * 8;
      const int gm = m0 + r;
      const bf16* src = A + (size_t)(gm < M ? gm : 0) * K + k0 + c;
      cp_async16(&sm.ab.a[stage][r][c], src, gm < M ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 32 rows x 8 chunks of 8
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 3, c = (chunk & 7) * 8;
      cp_async16(&sm.ab.b[stage][r][c], B + (size_t)(k0 + r) * N + n0 + c, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int KT = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load_tile((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.ab.a[st][wm + i * 16][kk],
                               BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.ab.b[st][kk][wn + j * 16],
                               BN + BPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[wm + i * 16][wn + j * 16], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  // epilogue: each thread takes column pairs, neighbouring threads take
  // neighbouring pairs of one row
  for (int idx = tid; idx < BM * BN / 2; idx += kThreads) {
    const int r = idx / (BN / 2), c = (idx % (BN / 2)) * 2;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    const float v0 = sm.c[r][c], v1 = sm.c[r][c + 1];
    const size_t o = (size_t)gm * N + gn;
    if (EPI == EPI_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(C) + o) =
          make_float2(v0, v1);
      continue;
    }
    const float u0 = v0 + load_bias(bias, bias_f32, gn);
    const float u1 = v1 + load_bias(bias, bias_f32, gn + 1);
    bf16* out = static_cast<bf16*>(C);
    if (EPI == EPI_BIAS_BF16) {
      store_pair(out, o, u0, u1);
    } else if (EPI == EPI_BIAS_GELU_TANH) {
      store_pair(out, o, gelu_tanh(u0), gelu_tanh(u1));
    } else if (EPI == EPI_BIAS_BF16_GELU) {
      store_pair(out, o, gelu_erf(bf16_round(u0)), gelu_erf(bf16_round(u1)));
    } else if (EPI == EPI_BIAS_GATED) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + o));
      const size_t g = (size_t)(gm / S) * gate_stride + gn;
      store_pair(out, o, x.x + bf2f(gate[g]) * u0,
                 x.y + bf2f(gate[g + 1]) * u1);
    } else if (EPI == EPI_BIAS_BF16_RESID) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + o));
      store_pair(out, o, x.x + bf16_round(u0), x.y + bf16_round(u1));
    }
  }
}

}  // namespace

GTAX_ENTRY gtax_gemm_bf16(const void* A, const void* B, void* C,
                          const void* bias, int bias_f32, const void* resid,
                          const void* gate, int gate_stride, int M, int N,
                          int K, int S, int epi, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % BN || K % BK || S <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  const bf16* x = static_cast<const bf16*>(resid);
  const bf16* g = static_cast<const bf16*>(gate);
#define GTAX_GEMM_CASE(E)                                                   \
  case E:                                                                   \
    gemm_kernel<E><<<grid, kThreads, 0, st>>>(a, b, C, bias, bias_f32, x, g, \
                                             gate_stride, M, N, K, S);      \
    break;
  switch (epi) {
    GTAX_GEMM_CASE(EPI_F32)
    GTAX_GEMM_CASE(EPI_BIAS_BF16)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_TANH)
    GTAX_GEMM_CASE(EPI_BIAS_BF16_GELU)
    GTAX_GEMM_CASE(EPI_BIAS_GATED)
    GTAX_GEMM_CASE(EPI_BIAS_BF16_RESID)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GTAX_GEMM_CASE
  return (int)cudaGetLastError();
}
