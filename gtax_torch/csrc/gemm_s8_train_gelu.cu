// The int8 GEMM's training form (gemm_s8_train.cuh): the kernels of its
// GELU epilogues (fc1: 1 and 3, and 5 and 6 with the fp32 second output),
// each with the requantization of the GELU rows (a cluster of two 128 x
// 256 tiles a 512-column group), built beside gemm_s8_train.cu.
#include "gemm_s8_train.cuh"

namespace s8t {

int launch_gelu(const void* A, const void* B, const Args& p, const Quant& qo,
                int epi, cudaStream_t st) {
  namespace e = gemm_s8;
  constexpr int P = kQGroup / 256;
  switch (epi) {
    case e::EPI_BIAS_GELU_F32:
      return launch<e::EPI_BIAS_GELU_F32, 256, P>(A, B, p, qo, st);
    case e::EPI_BIAS_GELU_ERF_F32:
      return launch<e::EPI_BIAS_GELU_ERF_F32, 256, P>(A, B, p, qo, st);
    case e::EPI_BIAS_GELU_F32_H:
      return launch<e::EPI_BIAS_GELU_F32_H, 256, P>(A, B, p, qo, st);
    case e::EPI_BIAS_GELU_ERF_F32_H:
      return launch<e::EPI_BIAS_GELU_ERF_F32_H, 256, P>(A, B, p, qo, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace s8t
