// The paired int8 kernel's device code and launch templates, shared by
// pair_q.cu (the entry points, the tanh-GELU kernels) and pair_q_exact.cu
// (the exact-GELU kernels, compiled apart so that the two nvcc runs go in
// parallel). See pair_q.cu for the design.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "attn_frame.cuh"
#include "attn_temporal.cuh"
#include "gemm_s8.cuh"
#include "ln_mod.cuh"
#include "quant_rows.cuh"

namespace cg = cooperative_groups;

namespace pairq {

constexpr int kThreads = 256;
static_assert(kThreads == kLnThreads && kThreads == kAttnWarps * 32 &&
                  kThreads == kTemporalWarps * 32 &&
                  kThreads == gemm_s8::kThreads,
              "the shared device functions assume 256 threads");
constexpr int kGemms = 4;  // qkv, out-projection, fc1, fc2

struct PairArgs {
  // the half-block's rows (M = frames * S) and per-frame adaLN vectors,
  // bf16 rows of the given strides
  const bf16* x;
  const bf16 *sh1, *sc1, *g1, *sh2, *sc2, *g2;
  int p1_stride, g1_stride, p2_stride, g2_stride;
  // fp32 column scales of the int8 weights; biases fp32 or bf16
  const float *qkv_s, *out_s, *w1_s, *w2_s;
  const void *out_b, *b1, *b2;
  int out_b_f32, b1_f32, b2_f32;
  const float* freqs;         // spatial (S, hd); temporal (T, hd)
  const bf16 *k_ctx, *v_ctx;  // temporal: (B * n_ctx * S, D)
  bf16* out;
  // workspace, in the order of workspace_layout
  signed char* mq1;
  float* ms1;
  float* qkv;
  float* att;
  signed char* aq;
  float* as;
  bf16* xm;
  signed char* mq2;
  float* ms2;
  float* h;
  signed char* hq;
  float* hs;
  int* part;
  int k_chunk[kGemms];
  int M, S, D, Hd, G, num_heads;
  int B, n_live, n_ctx, valid_mask;  // temporal
  unsigned long long* stamps;        // the phase probe's clock stamps
  int exact_gelu;                    // fc1's GELU: 1 exact, 0 tanh
};

// The GEMMs' operands: A, the int8 activation rows, and B, the int8
// weights read as W^T (gemm_s8.cuh), one map each.
struct PairMaps {
  CUtensorMap a[kGemms];
  CUtensorMap b[kGemms];
};

// The exact-GELU kernels' launch (pair_q_exact.cu): launch_gelu<hd,
// temporal, true>, or cudaErrorInvalidValue for another head dim.
__attribute__((visibility("hidden"))) int launch_exact(
    int hd, bool temporal, const PairArgs& a, const PairMaps& maps,
    cudaStream_t st);

}  // namespace pairq

// The device code and the launch templates: internal to each source that
// includes them (their static locals, the cached grid, must not be shared
// with another library of these sources, such as the phase probe's).
namespace {

using namespace pairq;

// The phase probe (gtax_torch/tools/split.py, through build.py's
// pair_probe_library): a copy built with GTAX_PAIR_PROBE defined stamps
// %globaltimer from thread 0 of every block at the kernel's start, after
// each phase's work and after each grid barrier, kStamps a block, into
// the workspace past its buffers. The library is built without it.
#ifdef GTAX_PAIR_PROBE
// 18 phase stamps, then gemm_s8::kUnitStamps for each GEMM phase
constexpr int kStamps = 18 + 4 * gemm_s8::kUnitStamps;
__device__ __forceinline__ void stamp(const PairArgs& a, int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    a.stamps[(size_t)blockIdx.x * kStamps + i] = t;
  }
}
#else
__device__ __forceinline__ void stamp(const PairArgs&, int) {}
#endif

__host__ __device__ inline size_t align256(size_t n) {
  return (n + 255) & ~(size_t)255;
}

constexpr int kBuffers = 13;

// (N, K) of the pair's four GEMMs
inline void gemm_shapes(int D, int Hd, int (*nk)[2]) {
  const int s[kGemms][2] = {{3 * D, D}, {D, D}, {Hd, D}, {D, Hd}};
  for (int i = 0; i < kGemms; ++i) nk[i][0] = s[i][0], nk[i][1] = s[i][1];
}

// Byte sizes of the workspace buffers, in carving order; each starts on a
// 256-byte boundary. The last is the split-K partials of the GEMM whose
// chunks need the most. gtax_torch/kernels/pair.py computes the same
// total.
inline size_t workspace_layout(int M, int D, int Hd, int G,
                               const int* k_chunk, size_t* sizes) {
  const size_t m = (size_t)M;
  int nk[kGemms][2];
  gemm_shapes(D, Hd, nk);
  size_t part = 0;
  for (int i = 0; i < kGemms; ++i) {
    const size_t sp = gemm_s8::splits(nk[i][1], k_chunk[i]);
    if (sp > 1) part = std::max(part, sp * m * nk[i][0] * 4);
  }
  const size_t s[kBuffers] = {
      m * D,     m * 4,      m * 3 * D * 4, m * D * 4,       m * D,
      m * 4,     m * D * 2,  m * D,         m * 4,           m * Hd * 4,
      m * Hd,    m * (Hd / G) * 4,          part};
  size_t total = 0;
  for (int i = 0; i < kBuffers; ++i) {
    sizes[i] = s[i];
    total += align256(s[i]);
  }
  return total;
}

__device__ __forceinline__ gemm_s8::Args gemm_args(
    const PairArgs& a, int i, void* C, const float* sa, int group,
    const float* ws, const void* bias, int bias_f32, const bf16* resid,
    const bf16* gate, int gate_stride, int N, int K) {
  return gemm_s8::Args{C,     sa,   K / group,   group,      ws,
                       bias,  bias_f32, resid,   gate,       gate_stride,
                       a.M,   N,    K,           a.S,        a.k_chunk[i],
                       a.part
#ifdef GTAX_PAIR_PROBE
                       , a.stamps + (size_t)blockIdx.x * kStamps + 18 +
                             i * gemm_s8::kUnitStamps
#endif
  };
}

__device__ __forceinline__ void ln_phase(const PairArgs& a, const bf16* x,
                                         const bf16* sh, const bf16* sc,
                                         int p_stride, signed char* q,
                                         float* s, float* red,
                                         float* mod_row) {
  for (int r = blockIdx.x; r < a.M; r += gridDim.x) {
    ln_mod_row(x, q, s, sh, sc, a.D, a.S, p_stride, LN_MODULATE_INT8, r, red,
               mod_row);
    __syncthreads();
  }
}

__device__ __forceinline__ void quant_phase(const float* in, signed char* q,
                                            float* s, int G, size_t units) {
  constexpr int kWarps = kThreads / 32;  // one unit a warp
  for (size_t u = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       u < units; u += (size_t)gridDim.x * kWarps)
    quant_rows_unit(in, q, s, G, u);
}

// EXACT: fc1's GELU is the exact one (an instantiation of its own, so the
// tanh form's kernel is the one the sequential wrappers' code makes)
template <int HD, bool TEMPORAL, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    pair_q_kernel(const PairArgs a, const __grid_constant__ PairMaps maps) {
  extern __shared__ unsigned char smem_raw[];
  // the GEMM ring, whose barriers lie past every other phase's buffers
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  cg::grid_group grid = cg::this_grid();
  float* red = reinterpret_cast<float*>(smem);  // 33 floats (ln)
  float* mod_row = red + 64;                    // D floats (ln)
  gemm_s8::Ring ring = gemm_s8::ring_init(smem);
  const int M = a.M, D = a.D, S = a.S;
  stamp(a, 0);

  // the four GEMMs
  const gemm_s8::Args qkv = gemm_args(a, 0, a.qkv, a.ms1, D, a.qkv_s,
                                      nullptr, 0, nullptr, nullptr, 0, 3 * D,
                                      D);
  const gemm_s8::Args proj = gemm_args(a, 1, a.xm, a.as, D, a.out_s, a.out_b,
                                       a.out_b_f32, a.x, a.g1, a.g1_stride,
                                       D, D);
  const gemm_s8::Args fc1 = gemm_args(a, 2, a.h, a.ms2, D, a.w1_s, a.b1,
                                      a.b1_f32, nullptr, nullptr, 0, a.Hd,
                                      D);
  const gemm_s8::Args fc2 = gemm_args(a, 3, a.out, a.hs, a.G, a.w2_s, a.b2,
                                      a.b2_f32, a.xm, a.g2, a.g2_stride, D,
                                      a.Hd);

  // 1. LN/modulate -> int8
  ln_phase(a, a.x, a.sh1, a.sc1, a.p1_stride, a.mq1, a.ms1, red, mod_row);
  stamp(a, 1);
  grid.sync();
  stamp(a, 2);
  // 2. qkv GEMM, fp32 out
  gemm_s8::gemm<gemm_s8::EPI_F32>(ring, &maps.a[0], &maps.b[0], qkv);
  stamp(a, 3);
  grid.sync();
  stamp(a, 4);
  // 3. attention, fp32 out
  if (TEMPORAL) {
    const int units = a.B * S * a.num_heads;
    const int warp = threadIdx.x >> 5;
    for (int i = blockIdx.x; i * kTemporalWarps < units; i += gridDim.x)
      attn_temporal_unit<HD>(i * kTemporalWarps + warp, a.qkv, a.freqs,
                             a.k_ctx, a.v_ctx, a.att, 1, nullptr, nullptr,
                             nullptr, a.B, a.n_live, a.n_ctx, S, D,
                             a.num_heads, a.valid_mask);
  } else {
    const int qtiles = (S + kAttnQTile - 1) / kAttnQTile;
    const int units = qtiles * a.num_heads * (M / S);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int qt = u % qtiles, hn = u / qtiles;
      attn_frame_unit<HD>(smem, a.qkv, 1, a.freqs, a.att, 1, nullptr,
                          nullptr, nullptr, S, D, HD, qt, hn % a.num_heads,
                          hn / a.num_heads);
      __syncthreads();
    }
  }
  stamp(a, 5);
  grid.sync();
  stamp(a, 6);
  // 4. quantize the attention rows
  quant_phase(a.att, a.aq, a.as, D, (size_t)M);
  stamp(a, 7);
  grid.sync();
  stamp(a, 8);
  // 5. out-projection + bias + gated residual -> bf16 xm (the seam)
  gemm_s8::gemm<gemm_s8::EPI_BIAS_GATED>(ring, &maps.a[1], &maps.b[1], proj);
  stamp(a, 9);
  grid.sync();
  stamp(a, 10);
  // 6. LN/modulate of xm -> int8
  ln_phase(a, a.xm, a.sh2, a.sc2, a.p2_stride, a.mq2, a.ms2, red, mod_row);
  stamp(a, 11);
  grid.sync();
  stamp(a, 12);
  // 7. fc1 + bias + GELU, fp32
  gemm_s8::gemm<EXACT ? gemm_s8::EPI_BIAS_GELU_ERF_F32
                      : gemm_s8::EPI_BIAS_GELU_F32>(ring, &maps.a[2],
                                                    &maps.b[2], fc1);
  stamp(a, 13);
  grid.sync();
  stamp(a, 14);
  // 8. per-chunk quantization of the GELU output
  quant_phase(a.h, a.hq, a.hs, a.G, (size_t)M * (a.Hd / a.G));
  stamp(a, 15);
  grid.sync();
  stamp(a, 16);
  // 9. fc2 over the chunks (K groups) + bias + gated residual
  gemm_s8::gemm<gemm_s8::EPI_BIAS_GATED>(ring, &maps.a[3], &maps.b[3], fc2);
  stamp(a, 17);
}

// Dynamic shared memory: the GEMM ring (and its barriers) from a
// 1024-aligned base; every other phase's buffers fit in the ring's data.
template <int HD, bool TEMPORAL>
size_t smem_bytes(int S, int D) {
  size_t other = (64 + (size_t)D) * 4;
  if (!TEMPORAL) other = std::max(other, attn_frame_smem<HD>(S));
  return other > (size_t)gemm_s8::kRingBytes ? 0
                                             : gemm_s8::kSmemBytes + 1024;
}

// Blocks that fit on the card at once (the cooperative grid), or a
// negative CUDA error. Queried once per device and shared-memory size.
template <int HD, bool TEMPORAL, bool EXACT = false>
int grid_blocks(int S, int D, size_t* smem_out) {
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  const size_t smem = smem_bytes<HD, TEMPORAL>(S, D);
  if (smem == 0 || smem > kSmemMax) return -(int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  *smem_out = smem;
  if (dev == cached_dev && smem == cached_smem) return cached_blocks;
  const void* fn =
      reinterpret_cast<const void*>(pair_q_kernel<HD, TEMPORAL, EXACT>);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int sms = 0, coop = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -(int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm <= 0) return -(int)cudaErrorLaunchOutOfResources;
  cached_dev = dev;
  cached_smem = smem;
  cached_blocks = per_sm * sms;
  return cached_blocks;
}

template <int HD, bool TEMPORAL, bool EXACT>
int launch_gelu(const PairArgs& a, const PairMaps& maps, cudaStream_t st) {
  size_t smem = 0;
  const int blocks = grid_blocks<HD, TEMPORAL, EXACT>(a.S, a.D, &smem);
  if (blocks < 0) return -blocks;
  void* params[] = {const_cast<PairArgs*>(&a), const_cast<PairMaps*>(&maps)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pair_q_kernel<HD, TEMPORAL, EXACT>),
      dim3(blocks), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
