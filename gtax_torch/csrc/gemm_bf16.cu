// bf16 GEMM with fp32 accumulation on the tensor cores and the epilogues
// the fused branches need: C = epilogue(A @ B), A (M, K) row-major bf16,
// B (K, N) row-major bf16 (gtax's (in, out) kernel layout), or, with
// trans_b, B = W^T for W (N, K) row-major: the input-gradient products
// dY @ W^T of the branch backwards, reading the weight as it is stored.
//
// Replaces the in-kernel jnp.dot calls of the TPU branch kernels
// (gtax/kernels/block.py _kernel/_mlp_kernel/_temporal_kernel/
// _temporal_step_kernel, gtax/kernels/vae_block.py _vae_block_kernel) and
// the dX products of the backward kernels (gtax/kernels/backward.py
// _spatial_bwd_kernel/_temporal_bwd_kernel/_mlp_bwd_kernel: dy @ W^T with
// the gelu' and bf16 epilogues).
// Bound: at the serving shapes (M = 144..3456 rows, K, N = 1024..4096) the
// weight bytes dominate at small M and the tensor-core rate at large M.
// Design: 64x64 block tiles, 4 warps of 32x32 wmma 16x16x16 fragments, a
// two-stage cp.async ring over K, zero-filled ragged M rows (144 is not a
// multiple of 64), and an epilogue that goes through shared memory so every
// output row is written with coalesced stores. The emit_train epilogues
// store a second bf16 output (C2): the pre-gate y, or the pre-GELU h1. The
// gelu' epilogue also sums its fp32 products over each tile's rows, one
// partial per (row tile, column), so the bias gradient is reduced in a
// fixed order (no atomics). Later work: wgmma + TMA.
#include <mma.h>

#include <type_traits>

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
  EPI_BF16 = 6,             // bf16(acc)
  EPI_BIAS_GATED_Y = 7,     // EPI_BIAS_GATED; C2 = bf16(acc + bias)
  EPI_BIAS_GELU_TANH_H = 8, // EPI_BIAS_GELU_TANH; C2 = bf16(acc + bias)
  EPI_DGELU = 9,            // u = gelu'(h) * acc, h = aux (bf16 h1):
                            // C = bf16(u), C2 = bf16(gelu(h)), colsum +=
                            // sum over the tile's rows of u
};

struct TilesAB {
  bf16 a[2][BM][BK + APAD];
  bf16 b[2][BK][BN + BPAD];
};
struct TilesABt {  // trans_b: B tile kept as W rows, [n][k]
  bf16 a[2][BM][BK + APAD];
  bf16 b[2][BN][BK + APAD];
};
union Smem {
  TilesAB ab;
  TilesABt abt;
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

// (gelu(h), gelu'(h)) from one tanh, as gtax/kernels/backward.py
// _gelu_tanh_val_grad32
__device__ __forceinline__ float2 gelu_tanh_val_grad(float h) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (h + a * h * h * h));
  const float du = c * (1.0f + 3.0f * a * h * h);
  return make_float2(0.5f * h * (1.0f + t),
                     0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * du);
}

template <int EPI, bool TB>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                void* __restrict__ C, bf16* __restrict__ C2,
                const bf16* __restrict__ aux, float* __restrict__ colsum,
                const void* __restrict__ bias, int bias_f32,
                const bf16* __restrict__ resid, const bf16* __restrict__ gate,
                int gate_stride, int M, int N, int K, int S) {
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
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kThreads;
      if constexpr (TB) {  // W rows n0..n0+63, 4 chunks of 8 along k each
        const int r = chunk >> 2, c = (chunk & 3) * 8;
        cp_async16(&sm.abt.b[stage][r][c], B + (size_t)(n0 + r) * K + k0 + c,
                   16);
      } else {  // B: 32 rows x 8 chunks of 8
        const int r = chunk >> 3, c = (chunk & 7) * 8;
        cp_async16(&sm.ab.b[stage][r][c], B + (size_t)(k0 + r) * N + n0 + c,
                   16);
      }
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
      using LayoutB = typename std::conditional<TB, wmma::col_major,
                                                wmma::row_major>::type;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.ab.a[st][wm + i * 16][kk],
                               BK + APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (TB)
          wmma::load_matrix_sync(fb[j], &sm.abt.b[st][wn + j * 16][kk],
                                 BK + APAD);
        else
          wmma::load_matrix_sync(fb[j], &sm.ab.b[st][kk][wn + j * 16],
                                 BN + BPAD);
      }
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
    if (gm >= M) {
      if (EPI == EPI_DGELU) sm.c[r][c] = sm.c[r][c + 1] = 0.f;
      continue;
    }
    const float v0 = sm.c[r][c], v1 = sm.c[r][c + 1];
    const size_t o = (size_t)gm * N + gn;
    if (EPI == EPI_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(C) + o) =
          make_float2(v0, v1);
      continue;
    }
    if (EPI == EPI_BF16) {
      store_pair(static_cast<bf16*>(C), o, v0, v1);
      continue;
    }
    if (EPI == EPI_DGELU) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(aux + o));
      const float2 g0 = gelu_tanh_val_grad(h.x), g1 = gelu_tanh_val_grad(h.y);
      const float d0 = g0.y * v0, d1 = g1.y * v1;
      store_pair(static_cast<bf16*>(C), o, d0, d1);
      store_pair(C2, o, g0.x, g1.x);
      sm.c[r][c] = d0;
      sm.c[r][c + 1] = d1;
      continue;
    }
    const float u0 = v0 + load_bias(bias, bias_f32, gn);
    const float u1 = v1 + load_bias(bias, bias_f32, gn + 1);
    bf16* out = static_cast<bf16*>(C);
    if (EPI == EPI_BIAS_BF16) {
      store_pair(out, o, u0, u1);
    } else if (EPI == EPI_BIAS_GELU_TANH || EPI == EPI_BIAS_GELU_TANH_H) {
      store_pair(out, o, gelu_tanh(u0), gelu_tanh(u1));
      if (EPI == EPI_BIAS_GELU_TANH_H) store_pair(C2, o, u0, u1);
    } else if (EPI == EPI_BIAS_BF16_GELU) {
      store_pair(out, o, gelu_erf(bf16_round(u0)), gelu_erf(bf16_round(u1)));
    } else if (EPI == EPI_BIAS_GATED || EPI == EPI_BIAS_GATED_Y) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + o));
      const size_t g = (size_t)(gm / S) * gate_stride + gn;
      store_pair(out, o, x.x + bf2f(gate[g]) * u0,
                 x.y + bf2f(gate[g + 1]) * u1);
      if (EPI == EPI_BIAS_GATED_Y) store_pair(C2, o, u0, u1);
    } else if (EPI == EPI_BIAS_BF16_RESID) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + o));
      store_pair(out, o, x.x + bf16_round(u0), x.y + bf16_round(u1));
    }
  }
  if (EPI == EPI_DGELU) {  // the tile's column sums, rows in order
    __syncthreads();
    if (tid < BN) {
      float acc_c = 0.f;
      for (int r = 0; r < BM; ++r) acc_c += sm.c[r][tid];
      colsum[(size_t)blockIdx.y * N + n0 + tid] = acc_c;
    }
  }
}

}  // namespace

// trans_b = 0: B (K, N) row-major; trans_b = 1: B is W (N, K) row-major and
// the product is A @ W^T. C2: the second bf16 output of the emit_train and
// gelu' epilogues; aux: the bf16 h1 the gelu' epilogue reads; colsum:
// (ceil(M / 64), N) fp32 per-tile column sums of the gelu' epilogue.
GTAX_ENTRY gtax_gemm_bf16(const void* A, const void* B, void* C, void* C2,
                          const void* aux, void* colsum, const void* bias,
                          int bias_f32, const void* resid, const void* gate,
                          int gate_stride, int M, int N, int K, int S, int epi,
                          int trans_b, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % BN || K % BK || S <= 0)
    return (int)cudaErrorInvalidValue;
  const bool needs_c2 = epi == EPI_BIAS_GATED_Y ||
                        epi == EPI_BIAS_GELU_TANH_H || epi == EPI_DGELU;
  if ((needs_c2 && C2 == nullptr) ||
      (epi == EPI_DGELU && (aux == nullptr || colsum == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  bf16* c2 = static_cast<bf16*>(C2);
  const bf16* h = static_cast<const bf16*>(aux);
  float* cs = static_cast<float*>(colsum);
  const bf16* x = static_cast<const bf16*>(resid);
  const bf16* g = static_cast<const bf16*>(gate);
#define GTAX_GEMM_CASE(E)                                                    \
  case E:                                                                    \
    if (trans_b)                                                             \
      gemm_kernel<E, true><<<grid, kThreads, 0, st>>>(                       \
          a, b, C, c2, h, cs, bias, bias_f32, x, g, gate_stride, M, N, K, S); \
    else                                                                     \
      gemm_kernel<E, false><<<grid, kThreads, 0, st>>>(                      \
          a, b, C, c2, h, cs, bias, bias_f32, x, g, gate_stride, M, N, K, S); \
    break;
  switch (epi) {
    GTAX_GEMM_CASE(EPI_F32)
    GTAX_GEMM_CASE(EPI_BIAS_BF16)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_TANH)
    GTAX_GEMM_CASE(EPI_BIAS_BF16_GELU)
    GTAX_GEMM_CASE(EPI_BIAS_GATED)
    GTAX_GEMM_CASE(EPI_BIAS_BF16_RESID)
    GTAX_GEMM_CASE(EPI_BF16)
    GTAX_GEMM_CASE(EPI_BIAS_GATED_Y)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_TANH_H)
    GTAX_GEMM_CASE(EPI_DGELU)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GTAX_GEMM_CASE
  return (int)cudaGetLastError();
}
