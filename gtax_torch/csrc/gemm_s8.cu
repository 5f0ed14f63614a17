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
#include "gemm_s8.cuh"

namespace {

using gemm_s8::BM;
using gemm_s8::BN;
using gemm_s8::BK;
using gemm_s8::EPI_F32;
using gemm_s8::EPI_BIAS_GELU_F32;
using gemm_s8::EPI_BIAS_GATED;

constexpr int kThreads = 128;

// one block per output tile; the body is gemm_s8::tile (gemm_s8.cuh)
template <int EPI>
__global__ void __launch_bounds__(kThreads)
    gemm_s8_kernel(const gemm_s8::Args p) {
  __shared__ __align__(128) gemm_s8::Smem sm;
  gemm_s8::tile<EPI, kThreads>(sm, p, blockIdx.y, blockIdx.x);
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
  const dim3 grid(gemm_s8::n_tiles(N), gemm_s8::m_tiles(M));
  cudaStream_t st = (cudaStream_t)stream;
  const gemm_s8::Args p{
      static_cast<const signed char*>(A), static_cast<const signed char*>(B),
      C, static_cast<const float*>(sa), K / group, group / BK,
      static_cast<const float*>(ws), bias, bias_f32,
      static_cast<const bf16*>(resid), static_cast<const bf16*>(gate),
      gate_stride, M, N, K, S};
#define GTAX_GEMM_S8_CASE(E)                          \
  case E:                                             \
    gemm_s8_kernel<E><<<grid, kThreads, 0, st>>>(p);  \
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
