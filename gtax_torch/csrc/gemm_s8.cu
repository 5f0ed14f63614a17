// W8A8 GEMM on the int8 tensor cores with exact int32 accumulation:
// C = epilogue(dequant(A @ B)), A (M, K) row-major int8 activations with
// fp32 scales per (row, K group), B (K, N) row-major int8 weights (gtax's
// (in, out) kernel layout) with fp32 scales per column.
//
// Replaces the int8 dots of the TPU int8 branch kernels
// (gtax/kernels/quant.py _qdot in _spatial_kernel_q, _temporal_kernel_q
// and _temporal_step_kernel_q; the fc1 and per-H-chunk fc2 dots of
// _mlp_kernel_q).
// Dequantization is the TPU kernels', rounded op by op (no contraction):
//   acc_f = sum over K groups g, in order, of float(acc_int32_g) * sa[row, g]
//   y     = acc_f * ws[col]
// One group (G = K) is _qdot's (acc * sa) * ws; G = 512 is _mlp_kernel_q's
// fc2, which requantizes the GELU output per H-chunk and so cannot be one
// int32 product over K = 4096. Epilogues: y in fp32 (qkv); tanh-GELU(y + b)
// in fp32 (fc1); bf16(x + gate[row / S] * (y + b)) (out-projection, fc2).
// Bound: at the serving shapes (M = 144..1152, K, N = 1024..4096) the int8
// weight bytes at small M, the int8 tensor-core rate at large M.
// Design: gemm_bf16.cu's shape, 64x64 block tiles, 4 warps of 32x32
// wmma 16x16x16 s8 fragments with int accumulators, a two-stage cp.async
// ring over K tiles of 64 bytes, zero-filled ragged M rows. wmma wants
// 32-byte aligned fragment pointers, and a 16-deep int8 k-step is only 16
// bytes, so shared memory holds each tile as 16-byte slabs: A as [k-slab]
// [row][16], B as [n-slab][k][16]. At the end of each K group the int32
// fragments go through shared memory into fp32 accumulators that each
// thread keeps in registers for its 16 column pairs. Later work: wgmma + TMA.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int kSlab = 16;  // bytes of one wmma k-step of A, n-step of B
constexpr int CPAD = 4;
constexpr int kThreads = 128;
constexpr int kPairs = BM * BN / 2 / kThreads;  // column pairs per thread

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

// jax.nn.gelu(approximate=True), each op rounded once as the plain version
// computes it
__device__ __forceinline__ float gelu_tanh_rn(float h) {
  const float h3 = __fmul_rn(__fmul_rn(h, h), h);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(h, __fmul_rn(0.044715f, h3)));
  return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_s8_kernel(const signed char* __restrict__ A,
                   const signed char* __restrict__ B, void* __restrict__ C,
                   const float* __restrict__ sa, int n_groups,
                   int tiles_per_group, const float* __restrict__ ws,
                   const void* __restrict__ bias, int bias_f32,
                   const bf16* __restrict__ resid,
                   const bf16* __restrict__ gate, int gate_stride, int M,
                   int N, int K, int S) {
  __shared__ __align__(128) Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 slabs
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 2, s = chunk & 3;
      const int gm = m0 + r;
      const signed char* src = A + (size_t)(gm < M ? gm : 0) * K + k0 + s * kSlab;
      cp_async16(&sm.a[stage][s][r][0], src, gm < M ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 64 k-rows x 4 slabs of 16 columns
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 2, s = chunk & 3;
      cp_async16(&sm.b[stage][s][r][0],
                 B + (size_t)(k0 + r) * N + n0 + s * kSlab, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  float facc[kPairs][2];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) facc[p][0] = facc[p][1] = 0.f;

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
    for (int ks = 0; ks < BK / kSlab; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[st][ks][wm + i * 16][0], kSlab);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[st][(wn + j * 16) / kSlab][ks * kSlab][0],
                               kSlab);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if ((kt + 1) % tiles_per_group) continue;
    // end of K group g: fold its int32 sums into the fp32 accumulators
    const int g = (kt + 1) / tiles_per_group - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(&sm.c[wm + i * 16][wn + j * 16], acc[i][j],
                                BN + CPAD, wmma::mem_row_major);
        wmma::fill_fragment(acc[i][j], 0);
      }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx >> 5, c = (idx & 31) * 2;
      const int gm = m0 + r;
      const float s = gm < M ? sa[(size_t)gm * n_groups + g] : 0.f;
      facc[p][0] = __fadd_rn(facc[p][0], __fmul_rn(__int2float_rn(sm.c[r][c]), s));
      facc[p][1] =
          __fadd_rn(facc[p][1], __fmul_rn(__int2float_rn(sm.c[r][c + 1]), s));
    }
    // the next group's store comes after at least two more __syncthreads
  }

  // epilogue: neighbouring threads take neighbouring column pairs of a row
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int idx = tid + p * kThreads;
    const int r = idx >> 5, c = (idx & 31) * 2;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M) continue;
    const float y0 = __fmul_rn(facc[p][0], ws[gn]);
    const float y1 = __fmul_rn(facc[p][1], ws[gn + 1]);
    const size_t o = (size_t)gm * N + gn;
    if (EPI == EPI_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(C) + o) =
          make_float2(y0, y1);
      continue;
    }
    const float u0 = __fadd_rn(y0, load_bias(bias, bias_f32, gn));
    const float u1 = __fadd_rn(y1, load_bias(bias, bias_f32, gn + 1));
    if (EPI == EPI_BIAS_GELU_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(C) + o) =
          make_float2(gelu_tanh_rn(u0), gelu_tanh_rn(u1));
    } else {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + o));
      const size_t gi = (size_t)(gm / S) * gate_stride + gn;
      store_pair(static_cast<bf16*>(C), o,
                 __fadd_rn(x.x, __fmul_rn(bf2f(gate[gi]), u0)),
                 __fadd_rn(x.y, __fmul_rn(bf2f(gate[gi + 1]), u1)));
    }
  }
}

}  // namespace

// sa: (M, K / group) fp32 activation scales; ws: (N,) fp32 weight scales;
// bias: (N,) fp32 or bf16 (epilogues 1, 2); resid: (M, N) bf16 and gate:
// per-frame bf16 rows of gate_stride, frame = row / S (epilogue 2).
GTAX_ENTRY gtax_gemm_s8(const void* A, const void* B, void* C, const void* sa,
                        int group, const void* ws, const void* bias,
                        int bias_f32, const void* resid, const void* gate,
                        int gate_stride, int M, int N, int K, int S, int epi,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % BN || K % BK || group <= 0 ||
      group % BK || K % group || S <= 0 || sa == nullptr || ws == nullptr ||
      (epi != EPI_F32 && bias == nullptr) ||
      (epi == EPI_BIAS_GATED && (resid == nullptr || gate == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  const signed char* a = static_cast<const signed char*>(A);
  const signed char* b = static_cast<const signed char*>(B);
  const float* s = static_cast<const float*>(sa);
  const float* w = static_cast<const float*>(ws);
  const bf16* x = static_cast<const bf16*>(resid);
  const bf16* g = static_cast<const bf16*>(gate);
  const int n_groups = K / group, tpg = group / BK;
#define GTAX_GEMM_S8_CASE(E)                                                 \
  case E:                                                                    \
    gemm_s8_kernel<E><<<grid, kThreads, 0, st>>>(a, b, C, s, n_groups, tpg,  \
                                                 w, bias, bias_f32, x, g,    \
                                                 gate_stride, M, N, K, S);   \
    break;
  switch (epi) {
    GTAX_GEMM_S8_CASE(EPI_F32)
    GTAX_GEMM_S8_CASE(EPI_BIAS_GELU_F32)
    GTAX_GEMM_S8_CASE(EPI_BIAS_GATED)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GTAX_GEMM_S8_CASE
  return (int)cudaGetLastError();
}
