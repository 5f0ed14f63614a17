// The body of the gemm_s8 kernel as a device function over one 64x64
// output tile, shared by gemm_s8.cu (one block per tile, 128 threads) and
// the paired int8 kernels of pair_q.cu (tiles strided over a cooperative
// grid, 256 threads). The int32 sums of a K group are exact whatever the
// thread layout, and each output element folds its groups in order in one
// thread, so both callers give bit-equal results. See gemm_s8.cu for the
// arithmetic and the tile layout.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm_s8 {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int kSlab = 16;  // bytes of one wmma k-step of A, n-step of B
constexpr int CPAD = 4;

enum Epi {
  EPI_F32 = 0,            // fp32 C = y
  EPI_BIAS_GELU_F32 = 1,  // fp32 C = gelu_tanh(y + bias)
  EPI_BIAS_GATED = 2,     // bf16 C = x + gate[row / S] * (y + bias)
};

struct Smem {
  signed char a[2][BK / kSlab][BM][kSlab];
  signed char b[2][BN / kSlab][BK][kSlab];
  int c[BM][BN + CPAD];  // one K group's int32 sums, on their way to fp32
};

// C = epilogue(dequant(A @ B)): A (M, K) int8 with fp32 scales sa (M,
// n_groups), B (K, N) int8 with fp32 column scales ws; bias (N,) fp32 or
// bf16; resid (M, N) bf16 and gate per-frame bf16 rows of gate_stride,
// frame = row / S.
struct Args {
  const signed char* A;
  const signed char* B;
  void* C;
  const float* sa;
  int n_groups, tiles_per_group;
  const float* ws;
  const void* bias;
  int bias_f32;
  const bf16* resid;
  const bf16* gate;
  int gate_stride;
  int M, N, K, S;
};

__host__ __device__ inline int m_tiles(int M) { return (M + BM - 1) / BM; }
__host__ __device__ inline int n_tiles(int N) { return N / BN; }

// jax.nn.gelu(approximate=True), each op rounded once as the plain version
// computes it
__device__ __forceinline__ float gelu_tanh_rn(float h) {
  const float h3 = __fmul_rn(__fmul_rn(h, h), h);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(h, __fmul_rn(0.044715f, h3)));
  return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// Output tile (tm, tn). kThreads is 128 or 256; warps 0-3 run the tensor
// cores, every thread loads and folds. The caller separates two tiles that
// reuse `sm` with a __syncthreads().
template <int EPI, int kThreads>
__device__ __forceinline__ void tile(Smem& sm, const Args& p, int tm, int tn) {
  using namespace nvcuda;
  static_assert(kThreads % 128 == 0, "whole warpgroups of threads");
  constexpr int kPairs = BM * BN / 2 / kThreads;  // column pairs per thread
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool mma_warp = warp < 4;
  const int m0 = tm * BM, n0 = tn * BN;
  const int wm = ((warp & 3) >> 1) * 32, wn = (warp & 1) * 32;
  const int M = p.M, N = p.N, K = p.K;

  auto load_tile = [&](int stage, int k0) {
    for (int chunk = tid; chunk < BM * (BK / kSlab); chunk += kThreads) {
      const int r = chunk >> 2, s = chunk & 3;  // A: 64 rows x 4 slabs
      const int gm = m0 + r;
      const signed char* src =
          p.A + (size_t)(gm < M ? gm : 0) * K + k0 + s * kSlab;
      cp_async16(&sm.a[stage][s][r][0], src, gm < M ? 16 : 0);
    }
    for (int chunk = tid; chunk < BK * (BN / kSlab); chunk += kThreads) {
      const int r = chunk >> 2, s = chunk & 3;  // B: 64 k-rows x 4 slabs
      cp_async16(&sm.b[stage][s][r][0],
                 p.B + (size_t)(k0 + r) * N + n0 + s * kSlab, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  float facc[kPairs][2];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) facc[q][0] = facc[q][1] = 0.f;

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
    if (mma_warp) {
#pragma unroll
      for (int ks = 0; ks < BK / kSlab; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &sm.a[st][ks][wm + i * 16][0], kSlab);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], &sm.b[st][(wn + j * 16) / kSlab][ks * kSlab][0], kSlab);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
    if ((kt + 1) % p.tiles_per_group) continue;
    // end of K group g: fold its int32 sums into the fp32 accumulators
    const int g = (kt + 1) / p.tiles_per_group - 1;
    if (mma_warp) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(&sm.c[wm + i * 16][wn + j * 16], acc[i][j],
                                  BN + CPAD, wmma::mem_row_major);
          wmma::fill_fragment(acc[i][j], 0);
        }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int idx = tid + q * kThreads;
      const int r = idx >> 5, c = (idx & 31) * 2;
      const int gm = m0 + r;
      const float s = gm < M ? p.sa[(size_t)gm * p.n_groups + g] : 0.f;
      facc[q][0] =
          __fadd_rn(facc[q][0], __fmul_rn(__int2float_rn(sm.c[r][c]), s));
      facc[q][1] =
          __fadd_rn(facc[q][1], __fmul_rn(__int2float_rn(sm.c[r][c + 1]), s));
    }
    // the next group's store comes after at least two more __syncthreads
  }

  // epilogue: neighbouring threads take neighbouring column pairs of a row
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int idx = tid + q * kThreads;
    const int r = idx >> 5, c = (idx & 31) * 2;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    const float y0 = __fmul_rn(facc[q][0], p.ws[gn]);
    const float y1 = __fmul_rn(facc[q][1], p.ws[gn + 1]);
    const size_t o = (size_t)gm * N + gn;
    if (EPI == EPI_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) =
          make_float2(y0, y1);
      continue;
    }
    const float u0 = __fadd_rn(y0, load_bias(p.bias, p.bias_f32, gn));
    const float u1 = __fadd_rn(y1, load_bias(p.bias, p.bias_f32, gn + 1));
    if (EPI == EPI_BIAS_GELU_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) =
          make_float2(gelu_tanh_rn(u0), gelu_tanh_rn(u1));
    } else {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.resid + o));
      const size_t gi = (size_t)(gm / p.S) * p.gate_stride + gn;
      store_pair(static_cast<bf16*>(p.C), o,
                 __fadd_rn(x.x, __fmul_rn(bf2f(p.gate[gi]), u0)),
                 __fadd_rn(x.y, __fmul_rn(bf2f(p.gate[gi + 1]), u1)));
    }
  }
}

}  // namespace gemm_s8
