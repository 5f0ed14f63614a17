// The int8 GEMM's training form (gemm_s8_train.cuh): the C entry point and
// the kernels of its epilogues 0, 2, 4 and 7 (EPI_F32 and the gated
// residuals); gemm_s8_train_gelu.cu holds the GELU epilogues'.
#include "gemm_s8_train.cuh"

using s8t::Args;
using s8t::Quant;

// gtax_gemm_s8's arguments without the split (k_chunk, part), then hq, hs:
// null, or fc1's requantized GELU rows: hq (M, N) int8 and hs (M, N / 512)
// fp32, as quant_rows over each 512-column group of gelu(y + bias); C is
// then not written (null), and C2 holds y + bias as gtax_gemm_s8's does.
// The kernels built are those #7-#9 run: EPI_F32 with one K group (qkv),
// the gated epilogues with one or several (out, fc2), the GELU epilogues
// (1, 3, 5 and 6) with one and the requantization (fc1); any other
// combination is refused. The tile follows the groups: 128 x 256 columns
// with one, 128 x 128 with several (N a multiple of it).
GTAX_ENTRY gtax_gemm_s8_train(const void* A, const void* B, void* C,
                              void* C2, const void* sa, int group,
                              const void* ws, const void* bias, int bias_f32,
                              const void* resid, const void* gate,
                              int gate_stride, int M, int N, int K, int S,
                              int epi, void* hq, void* hs,
                              void* stream) {
  namespace e = gemm_s8;
  Args p{C, static_cast<const float*>(sa), group > 0 ? K / group : 0,
         group, static_cast<const float*>(ws), bias, bias_f32, resid, gate,
         gate_stride, M, N, K, S, K, nullptr};
  p.C2 = static_cast<bf16*>(C2);
  const Quant qo{static_cast<signed char*>(hq), static_cast<float*>(hs)};
  const bool quant = hq != nullptr;
  const bool gelu = epi == e::EPI_BIAS_GELU_F32 ||
                    epi == e::EPI_BIAS_GELU_ERF_F32 ||
                    epi == e::EPI_BIAS_GELU_F32_H ||
                    epi == e::EPI_BIAS_GELU_ERF_F32_H;
  const bool c2_required = epi == e::EPI_BIAS_GATED_F32_Y ||
                           epi == e::EPI_BIAS_GELU_F32_H ||
                           epi == e::EPI_BIAS_GELU_ERF_F32_H;
  const bool gated = epi == e::EPI_BIAS_GATED ||
                     epi == e::EPI_BIAS_GATED_F32 ||
                     epi == e::EPI_BIAS_GATED_F32_Y;
  using s8t::BK;
  const int tile_n = p.n_groups == 1 ? 256 : 128;
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || group <= 0 || K % group ||
      group % BK || S <= 0 || sa == nullptr || ws == nullptr ||
      N % tile_n || epi < 0 || epi > 7 ||
      (epi == e::EPI_F32 && p.n_groups != 1) ||
      (epi != e::EPI_F32 && bias == nullptr) ||
      ((epi == e::EPI_F32 || epi == e::EPI_BIAS_GATED_F32) &&
       C2 != nullptr) ||
      (c2_required &&
       (C2 == nullptr || reinterpret_cast<uintptr_t>(C2) % 8)) ||
      (gated && (resid == nullptr || gate == nullptr)) ||
      (quant ? (!gelu || p.n_groups != 1 || N % s8t::kQGroup ||
                hs == nullptr)
             : (gelu || C == nullptr || hs != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (gelu) return s8t::launch_gelu(A, B, p, qo, epi, st);
  switch (epi) {
    case e::EPI_F32:
      return s8t::launch_tile<e::EPI_F32>(A, B, p, qo, st);
    case e::EPI_BIAS_GATED:
      return s8t::launch_tile<e::EPI_BIAS_GATED>(A, B, p, qo, st);
    case e::EPI_BIAS_GATED_F32:
      return s8t::launch_tile<e::EPI_BIAS_GATED_F32>(A, B, p, qo, st);
    default:
      return s8t::launch_tile<e::EPI_BIAS_GATED_F32_Y>(A, B, p, qo, st);
  }
}
