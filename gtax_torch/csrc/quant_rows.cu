// Dynamic symmetric int8 quantization of fp32 rows, one scale per (row,
// group of G columns): the activation side of the W8A8 GEMMs.
//
// Replaces the in-kernel _quant_rows calls of the TPU int8 branch kernels
// (gtax/kernels/quant.py _quant_rows, called by _qdot on the attention
// output with G = D, and by _mlp_kernel_q on each H-chunk of the GELU
// output with G = the chunk width).
// Bound: bytes. One fp32 read and one int8 write per element. One warp
// per (row, group) reduces the abs-max with shuffles, holding its values
// in registers, and rounds them.
#include "quant_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = kThreads / 32;  // one unit a warp

// the body is quant_rows_unit (quant_rows.cuh)
__global__ void __launch_bounds__(kThreads)
    quant_rows_kernel(const float* __restrict__ a, signed char* __restrict__ q,
                      float* __restrict__ scale, int G, size_t units) {
  const size_t u = (size_t)blockIdx.x * kUnits + (threadIdx.x >> 5);
  if (u < units) quant_rows_unit(a, q, scale, G, u);
}

}  // namespace

// a: (rows, cols) fp32 row-major; q: (rows, cols) int8; scale: (rows,
// cols / G) fp32; G a multiple of 4.
GTAX_ENTRY gtax_quant_rows(const void* a, void* q, void* scale, int rows,
                           int cols, int G, void* stream) {
  if (rows <= 0 || cols <= 0 || G <= 0 || G % 4 || cols % G)
    return (int)cudaErrorInvalidValue;
  const size_t units = (size_t)rows * (size_t)(cols / G);
  const unsigned blocks = (unsigned)((units + kUnits - 1) / kUnits);
  quant_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<signed char*>(q),
      static_cast<float*>(scale), G, units);
  return (int)cudaGetLastError();
}
