// W8A8 GEMM on the int8 tensor cores with exact int32 accumulation:
// C = epilogue(dequant(A @ B)), A (M, K) row-major int8 activations with
// fp32 scales per (row, K group), B (K, N) int8 weights (gtax's (in, out)
// kernel) stored column-major, i.e. W^T (N, K) row-major, with fp32
// scales per column.
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
// in fp32 (fc1); bf16(x + gate[row / S] * (y + b)) (out-projection, fc2),
// or that sum unrounded over fp32 x and gate (the fp32 int8 branches,
// gtax's kernels at x.dtype = float32: an instantiation of its own, so the
// bf16 epilogue's code does not change).
// For int8-forward training (the emit_train outputs of the TPU kernels:
// _mlp_kernel_q's pre-GELU h1, the three kernels' pre-gate y) the last two
// also store bf16(y + b) from the same fp32 value, after the split sum
// where K is split; over fp32 activations (x.dtype = float32) epilogues
// 5-7, instantiations of their own, store y + b unrounded.
// Bound: at the serving shapes (M = 144..1152, K, N = 1024..4096) the int8
// weight bytes at small M, the int8 tensor-core rate at large M.
// Design: the weight-streaming tile of gemm_s8.cuh (all rows up to 320 in
// one unit, split K summed over the grid after a barrier, a TMA ring of
// up to eight stages, wgmma s8), a block per work unit up to what fits on
// the card at once; the K chunk comes from the wrapper's plan
// (gtax_torch/kernels/quant.py s8_plan). It replaced PR 2's 64x64 wmma
// tile, whose two-stage cp.async ring walked K one 8 KB step at a time.
#include <algorithm>

#include "gemm_s8.cuh"

namespace {

using gemm_s8::kThreads;

// the body is gemm_s8::gemm (gemm_s8.cuh): units strided over the grid,
// then the split sum's slices
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   const gemm_s8::Args p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  gemm_s8::Ring r = gemm_s8::ring_init(smem);
  gemm_s8::gemm<EPI>(r, &ma, &mb, p);
}

// One block per unit, up to the blocks that fit on the card at once; a
// cooperative launch where the chunks' partials are summed after a grid
// barrier.
template <int EPI>
int launch(const void* A, const void* B, gemm_s8::Args p, cudaStream_t st) {
  CUtensorMap ma, mb;
  int rc = sm90::make_map(&ma, A, p.M, p.K, 64, 1);
  if (rc) return rc;
  rc = sm90::make_map(&mb, B, p.N, p.K, 64, 1);
  if (rc) return rc;
  constexpr size_t smem = gemm_s8::kSmemBytes + 1024;
  static size_t opted = 0;
  static int capacity = 0;  // co-resident blocks (device 0 of the process)
  cudaError_t e = opt_in_smem(gemm_s8_kernel<EPI>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  if (capacity == 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gemm_s8_kernel<EPI>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm <= 0) return (int)cudaErrorLaunchOutOfResources;
    capacity = per_sm * sm90::sm_count();
  }
  const int blocks =
      std::min(gemm_s8::units(p.M, p.N, p.K, p.k_chunk), capacity);
  if (gemm_s8::splits(p.K, p.k_chunk) == 1) {
    gemm_s8_kernel<EPI><<<blocks, kThreads, smem, st>>>(ma, mb, p);
    return (int)cudaGetLastError();
  }
  void* args[] = {&ma, &mb, &p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gemm_s8_kernel<EPI>), dim3(blocks),
      dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// A: (M, K) int8; B: W^T, (N, K) int8 row-major; sa: (M, K / group) fp32
// activation scales; ws: (N,) fp32 weight scales; bias: (N,) fp32 or bf16
// (epilogues 1-4); resid: (M, N) bf16 and gate: per-frame bf16 rows of
// gate_stride, frame = row / S (epilogue 2; both fp32 and C fp32 for
// epilogue 4, the fp32 int8 branches' gated residual, which stores no C2);
// k_chunk: the split-K chunk;
// part: (ceil(K / k_chunk), M, N) int32, unused with one chunk; C2: null,
// or (M, N) bf16 of y + bias (epilogues 1, 2 and 3); epilogues 5, 6 and 7
// are 1, 3 and 4 with C2 (M, N) fp32 of y + bias, which they must have.
GTAX_ENTRY gtax_gemm_s8(const void* A, const void* B, void* C, void* C2,
                        const void* sa, int group, const void* ws,
                        const void* bias, int bias_f32, const void* resid,
                        const void* gate, int gate_stride, int M, int N,
                        int K, int S, int epi, int k_chunk, void* part,
                        void* stream) {
  gemm_s8::Args p{
      C, static_cast<const float*>(sa), group > 0 ? K / group : 0, group,
      static_cast<const float*>(ws), bias, bias_f32, resid, gate,
      gate_stride, M, N, K, S, k_chunk, static_cast<int*>(part)};
  p.C2 = static_cast<bf16*>(C2);
  using namespace gemm_s8;
  if (!valid(p) || S <= 0 || sa == nullptr || ws == nullptr ||
      (epi != gemm_s8::EPI_F32 && bias == nullptr) ||
      ((epi == gemm_s8::EPI_F32 || epi == gemm_s8::EPI_BIAS_GATED_F32) &&
       C2 != nullptr) ||
      ((epi == gemm_s8::EPI_BIAS_GATED_F32_Y ||
        epi == gemm_s8::EPI_BIAS_GELU_F32_H ||
        epi == gemm_s8::EPI_BIAS_GELU_ERF_F32_H) &&
       (C2 == nullptr || reinterpret_cast<uintptr_t>(C2) % 8)) ||
      ((epi == gemm_s8::EPI_BIAS_GATED || epi == gemm_s8::EPI_BIAS_GATED_F32 ||
        epi == gemm_s8::EPI_BIAS_GATED_F32_Y) &&
       (resid == nullptr || gate == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (epi) {
    case gemm_s8::EPI_F32:
      return launch<gemm_s8::EPI_F32>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GELU_F32:
      return launch<gemm_s8::EPI_BIAS_GELU_F32>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GATED:
      return launch<gemm_s8::EPI_BIAS_GATED>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GELU_ERF_F32:
      return launch<gemm_s8::EPI_BIAS_GELU_ERF_F32>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GATED_F32:
      return launch<gemm_s8::EPI_BIAS_GATED_F32>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GELU_F32_H:
      return launch<gemm_s8::EPI_BIAS_GELU_F32_H>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GELU_ERF_F32_H:
      return launch<gemm_s8::EPI_BIAS_GELU_ERF_F32_H>(A, B, p, st);
    case gemm_s8::EPI_BIAS_GATED_F32_Y:
      return launch<gemm_s8::EPI_BIAS_GATED_F32_Y>(A, B, p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tile the wrappers plan from: {rows, columns, k-step} of a unit and
// the most K chunks of a GEMM.
GTAX_ENTRY gtax_gemm_s8_consts(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = gemm_s8::kRows;
  o[1] = gemm_s8::BN;
  o[2] = gemm_s8::BK;
  o[3] = gemm_s8::kMaxSplits;
  return 0;
}
