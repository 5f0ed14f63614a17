// LayerNorm rows in fp32, then either the DiT adaLN modulate or an affine,
// written as bf16, or the modulate quantized to int8 with a per-row scale:
// the first stage of every fused branch. The fp32 branches (modes 3 and
// 4) read fp32 rows and store the modulate or the affine unrounded; the
// fp32 int8 branches (mode 5) quantize the modulate of fp32 rows.
//
// Replaces the LN/modulate prologue that each TPU kernel ran in VMEM
// (gtax/kernels/block.py _ln_modulate32, gtax/kernels/vae_block.py ln) and,
// for the int8 branches, the _quant_rows of the fp32 modulate output that
// follows it (gtax/kernels/quant.py _qdot).
// Bound: bytes. One read of x and one write of the result, a few
// operations per byte; one block per row keeps the reductions in shared
// memory and each row is read from L1 the second and third time. The int8
// mode keeps its fp32 row in shared memory (never in device memory) between
// the abs-max reduction and the rounding pass.
#include <type_traits>

#include "ln_mod.cuh"

namespace {

// one block per row; the body is ln_mod_row (ln_mod.cuh) over rows of T.
// Over fp32 rows a programmatic dependent may launch at once (the fp32
// persistent GEMM loads its first weights, then waits for this grid's end)
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    ln_mod_kernel(const T* __restrict__ x, void* __restrict__ out,
                  float* __restrict__ row_scale, const void* __restrict__ p0,
                  const void* __restrict__ p1, int D, int S, int p_stride,
                  int mode) {
  if constexpr (std::is_same<T, float>::value)
    asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float red[33];
  extern __shared__ float mod_row[];  // D floats in mode 2
  ln_mod_row(x, out, row_scale, p0, p1, D, S, p_stride, mode, blockIdx.x,
             red, mod_row);
}

}  // namespace

GTAX_ENTRY gtax_ln_mod(const void* x, void* out, void* row_scale,
                       const void* p0, const void* p1, int rows, int D, int S,
                       int p_stride, int mode, void* stream) {
  const bool int8 = mode == LN_MODULATE_INT8 || mode == LN_MODULATE_INT8_F32;
  if (rows <= 0 || D <= 0 || S <= 0 || mode < 0 ||
      mode > LN_MODULATE_INT8_F32 || (int8 && row_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = int8 ? (size_t)D * sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode >= LN_MODULATE_F32)  // modes 0, 1 and 2 over fp32 rows
    ln_mod_kernel<float><<<rows, kLnThreads, smem, st>>>(
        static_cast<const float*>(x), out, static_cast<float*>(row_scale),
        p0, p1, D, S, p_stride,
        mode == LN_MODULATE_INT8_F32 ? LN_MODULATE_INT8
                                     : mode - LN_MODULATE_F32);
  else
    ln_mod_kernel<bf16><<<rows, kLnThreads, smem, st>>>(
        static_cast<const bf16*>(x), out, static_cast<float*>(row_scale), p0,
        p1, D, S, p_stride, mode);
  return (int)cudaGetLastError();
}
