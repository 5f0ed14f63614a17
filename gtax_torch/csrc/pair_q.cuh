// The paired int8 kernel's device code, launch templates and entry body,
// shared by pair_q.cu (the bf16 entry points, the tanh-GELU kernels),
// pair_q_exact.cu (the exact-GELU kernels), pair_q_f32.cu and
// pair_q_f32_exact.cu (the fp32 forms), each compiled apart so that the
// nvcc runs go in parallel. See pair_q.cu for the design.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "attn_f32.cuh"
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

// The activations (x, the adaLN vectors, the context cache, the seam xm
// and out) are of the kernel's type T: bf16, or fp32 for the fp32 forms.
struct PairArgs {
  // the half-block's rows (M = frames * S) and per-frame adaLN vectors,
  // rows of the given strides
  const void* x;
  const void *sh1, *sc1, *g1, *sh2, *sc2, *g2;
  int p1_stride, g1_stride, p2_stride, g2_stride;
  // fp32 column scales of the int8 weights; biases fp32 or bf16
  const float *qkv_s, *out_s, *w1_s, *w2_s;
  const void *out_b, *b1, *b2;
  int out_b_f32, b1_f32, b2_f32;
  const float* freqs;         // spatial (S, hd); temporal (T, hd)
  const void *k_ctx, *v_ctx;  // temporal: (B * n_ctx * S, D)
  void* out;
  // workspace, in the order of workspace_layout
  signed char* mq1;
  float* ms1;
  float* qkv;
  float* att;
  signed char* aq;
  float* as;
  void* xm;
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
  int attn_shape;  // the fp32 spatial attention's query tile (attn_f32.cuh)
};

// The GEMMs' operands: A, the int8 activation rows, and B, the int8
// weights read as W^T (gemm_s8.cuh), one map each.
struct PairMaps {
  CUtensorMap a[kGemms];
  CUtensorMap b[kGemms];
};

// The exact-GELU kernels' launches (pair_q_exact.cu, pair_q_f32_exact.cu):
// launch_gelu<hd, temporal, true, T>, or cudaErrorInvalidValue for another
// head dim.
__attribute__((visibility("hidden"))) int launch_exact(
    int hd, bool temporal, const PairArgs& a, const PairMaps& maps,
    cudaStream_t st);
__attribute__((visibility("hidden"))) int launch_f32_exact(
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
// 256-byte boundary. The seam xm has elem bytes an element (the kernel's
// type); the last is the split-K partials of the GEMM whose chunks need
// the most. gtax_torch/kernels/pair.py computes the same total.
inline size_t workspace_layout(int M, int D, int Hd, int G,
                               const int* k_chunk, size_t elem,
                               size_t* sizes) {
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
      m * 4,     m * D * elem, m * D,       m * 4,           m * Hd * 4,
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
    const float* ws, const void* bias, int bias_f32, const void* resid,
    const void* gate, int gate_stride, int N, int K) {
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

template <typename T>
__device__ __forceinline__ void ln_phase(const PairArgs& a, const T* x,
                                         const void* sh, const void* sc,
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

// The fp32 spatial attention phase: units (query tile of F::QT rows, head,
// frame) strided over the cooperative grid, each on the first F::THREADS
// threads of its block over the roped rows of a.qkv (rows 3D apart; q at
// column 0, k at D, v at 2D) into a.att; the block's barrier after each
// unit frees the shared memory for the next.
template <int HD, class F>
__device__ __forceinline__ void frame_f32_units(const PairArgs& a,
                                                float* fsm) {
  static_assert(F::THREADS <= kThreads, "a unit runs on part of a block");
  const int S = a.S, D3 = 3 * a.D;
  const int qtiles = (S + F::QT - 1) / F::QT;
  const int units = qtiles * a.num_heads * (a.M / S);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int qt = u % qtiles, hn = u / qtiles;
    const int h = hn % a.num_heads, n = hn / a.num_heads;
    if (threadIdx.x < F::THREADS) {
      const float* base = a.qkv + (size_t)n * S * D3 + (size_t)h * HD;
      frame_f32_unit<HD, F>(fsm, base, D3, base + a.D, D3, base + 2 * a.D,
                            D3, a.att + (size_t)n * S * a.D + (size_t)h * HD,
                            a.D, S, qt * F::QT, 1.0f / sqrtf((float)HD),
                            [] {});  // phase 2's barrier is behind
    }
    __syncthreads();
  }
}

// EXACT: fc1's GELU is the exact one (an instantiation of its own, so the
// tanh form's kernel is the one the sequential wrappers' code makes). T:
// the activations' type, bf16 or float (the fp32 forms: every device
// function is the fp32 sequential kernels', nothing rounded below fp32
// but the int8 activations, and the attention on the CUDA cores).
template <int HD, bool TEMPORAL, bool EXACT, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    pair_q_kernel(const PairArgs a, const __grid_constant__ PairMaps maps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kGated =
      kF32 ? gemm_s8::EPI_BIAS_GATED_F32 : gemm_s8::EPI_BIAS_GATED;
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

  // the four GEMMs; the fp32 spatial form's qkv product ropes q and k in
  // its epilogue by phase 1's factors (in a.h)
  gemm_s8::Args qkv = gemm_args(a, 0, a.qkv, a.ms1, D, a.qkv_s, nullptr, 0,
                                nullptr, nullptr, 0, 3 * D, D);
  qkv.rope = reinterpret_cast<const float4*>(a.h);
  qkv.rope_hd = HD;
  const gemm_s8::Args proj = gemm_args(a, 1, a.xm, a.as, D, a.out_s, a.out_b,
                                       a.out_b_f32, a.x, a.g1, a.g1_stride,
                                       D, D);
  const gemm_s8::Args fc1 = gemm_args(a, 2, a.h, a.ms2, D, a.w1_s, a.b1,
                                      a.b1_f32, nullptr, nullptr, 0, a.Hd,
                                      D);
  const gemm_s8::Args fc2 = gemm_args(a, 3, a.out, a.hs, a.G, a.w2_s, a.b2,
                                      a.b2_f32, a.xm, a.g2, a.g2_stride, D,
                                      a.Hd);

  // 1. LN/modulate -> int8; the fp32 spatial form also reduces each rope
  // angle once here, the factors of every (position, pair of dims) into
  // a.h (free until fc1), for phase 2's epilogue
  if constexpr (kF32 && !TEMPORAL) {
    float4* cs = reinterpret_cast<float4*>(a.h);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < S * (HD / 2);
         i += gridDim.x * kThreads)
      cs[i] = rope_factors(a.freqs + (size_t)(i / (HD / 2)) * HD +
                           2 * (i % (HD / 2)));
  }
  ln_phase(a, static_cast<const T*>(a.x), a.sh1, a.sc1, a.p1_stride, a.mq1,
           a.ms1, red, mod_row);
  stamp(a, 1);
  grid.sync();
  stamp(a, 2);
  // 2. qkv GEMM, fp32 out (the fp32 spatial form's q and k roped)
  gemm_s8::gemm<kF32 && !TEMPORAL ? gemm_s8::EPI_F32_ROPE
                                  : gemm_s8::EPI_F32>(ring, &maps.a[0],
                                                      &maps.b[0], qkv);
  stamp(a, 3);
  grid.sync();
  stamp(a, 4);
  // 3. attention, fp32 out
  if constexpr (TEMPORAL) {
    const int units = a.B * S * a.num_heads;
    const int warp = threadIdx.x >> 5;
    for (int i = blockIdx.x; i * kTemporalWarps < units; i += gridDim.x)
      attn_temporal_unit<HD, T>(i * kTemporalWarps + warp, a.qkv, a.freqs,
                                static_cast<const T*>(a.k_ctx),
                                static_cast<const T*>(a.v_ctx), a.att, 1,
                                nullptr, nullptr, nullptr, a.B, a.n_live,
                                a.n_ctx, S, D, a.num_heads, a.valid_mask);
  } else if constexpr (kF32) {
    // the units of the call's query tile over the roped rows, each on its
    // shape's first threads
    switch (a.attn_shape) {
#define GTAX_CASE(I, ...)                                              \
  case I:                                                              \
    frame_f32_units<HD, __VA_ARGS__>(a, reinterpret_cast<float*>(smem)); \
    break;
      GTAX_F32_FRAME_SHAPES(GTAX_CASE)
#undef GTAX_CASE
    }
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
  // 5. out-projection + bias + gated residual -> xm (the seam, in T)
  gemm_s8::gemm<kGated>(ring, &maps.a[1], &maps.b[1], proj);
  stamp(a, 9);
  grid.sync();
  stamp(a, 10);
  // 6. LN/modulate of xm -> int8
  ln_phase(a, static_cast<const T*>(a.xm), a.sh2, a.sc2, a.p2_stride, a.mq2,
           a.ms2, red, mod_row);
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
  gemm_s8::gemm<kGated>(ring, &maps.a[3], &maps.b[3], fc2);
  stamp(a, 17);
}

// Dynamic shared memory: the GEMM ring (and its barriers) from a
// 1024-aligned base; every other phase's buffers fit in the ring's data
// (the fp32 frame attention's largest shape: 110 KB at head dim 64).
template <int HD, bool TEMPORAL, typename T>
size_t smem_bytes(int S, int D) {
  size_t other = (64 + (size_t)D) * 4;
  if (!TEMPORAL)
    other = std::max(other, std::is_same<T, float>::value
                                ? f32_frame_smem<HD>()
                                : attn_frame_smem<HD>(S));
  return other > (size_t)gemm_s8::kRingBytes ? 0
                                             : gemm_s8::kSmemBytes + 1024;
}

// Blocks that fit on the card at once (the cooperative grid), or a
// negative CUDA error. Queried once per device and shared-memory size.
template <int HD, bool TEMPORAL, bool EXACT = false, typename T = bf16>
int grid_blocks(int S, int D, size_t* smem_out) {
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  const size_t smem = smem_bytes<HD, TEMPORAL, T>(S, D);
  if (smem == 0 || smem > kSmemMax) return -(int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  *smem_out = smem;
  if (dev == cached_dev && smem == cached_smem) return cached_blocks;
  const void* fn =
      reinterpret_cast<const void*>(pair_q_kernel<HD, TEMPORAL, EXACT, T>);
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

template <int HD, bool TEMPORAL, bool EXACT, typename T = bf16>
int launch_gelu(const PairArgs& a, const PairMaps& maps, cudaStream_t st) {
  size_t smem = 0;
  const int blocks = grid_blocks<HD, TEMPORAL, EXACT, T>(a.S, a.D, &smem);
  if (blocks < 0) return -blocks;
  void* params[] = {const_cast<PairArgs*>(&a), const_cast<PairMaps*>(&maps)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pair_q_kernel<HD, TEMPORAL, EXACT, T>),
      dim3(blocks), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The entry points' parameters (gtax_pair_q, gtax_pair_q_f32; see pair_q.cu)
// and their names, in order.
#define GTAX_PAIR_PARAMS                                                     \
  int temporal, const void *x, const void *sh1, const void *sc1,             \
      const void *g1, const void *sh2, const void *sc2, const void *g2,      \
      int p1_stride, int g1_stride, int p2_stride, int g2_stride,            \
      const void *qkv_q, const void *qkv_s, const void *out_q,               \
      const void *out_s, const void *out_b, int out_b_f32,                   \
      const void *w1_q, const void *w1_s, const void *b1, int b1_f32,        \
      const void *w2_q, const void *w2_s, const void *b2, int b2_f32,        \
      const void *freqs, const void *k_ctx, const void *v_ctx, void *out,    \
      void *ws, long long ws_bytes, int M, int S, int D, int Hd, int G,      \
      int num_heads, int B, int n_live, int n_ctx, int valid_mask,           \
      int kc_qkv, int kc_out, int kc_fc1, int kc_fc2, int exact_gelu,        \
      int attn_shape, void *stream
#define GTAX_PAIR_ARGS                                                       \
  temporal, x, sh1, sc1, g1, sh2, sc2, g2, p1_stride, g1_stride, p2_stride,  \
      g2_stride, qkv_q, qkv_s, out_q, out_s, out_b, out_b_f32, w1_q, w1_s,   \
      b1, b1_f32, w2_q, w2_s, b2, b2_f32, freqs, k_ctx, v_ctx, out, ws,      \
      ws_bytes, M, S, D, Hd, G, num_heads, B, n_live, n_ctx, valid_mask,     \
      kc_qkv, kc_out, kc_fc1, kc_fc2, exact_gelu, attn_shape, stream

// The body of an entry point over activations of type T: checks the
// shapes, carves the workspace, makes the GEMMs' tensor maps, and launches
// through launch(hd, temporal, ...); blocks(temporal, hd, S, D) is the
// cooperative grid of T's kernels (the probe's stamps need it).
template <typename T>
int pair_call(int (*blocks)(int, int, int, int),
              int (*launch)(int, bool, const PairArgs&, const PairMaps&,
                            cudaStream_t),
              GTAX_PAIR_PARAMS) {
  if (M <= 0 || S <= 0 || M % S || D <= 0 || D % gemm_s8::BN ||
      D % gemm_s8::BK || num_heads <= 0 || D % num_heads || Hd <= 0 ||
      Hd % gemm_s8::BN || G <= 0 || G % gemm_s8::BK || Hd % G ||
      x == nullptr || out == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (temporal &&
      (B <= 0 || n_live <= 0 || n_ctx <= 0 || n_live + n_ctx > kMaxT ||
       (size_t)B * n_live * S != (size_t)M || k_ctx == nullptr ||
       v_ctx == nullptr))
    return (int)cudaErrorInvalidValue;
  // the fp32 spatial attention's shape: one of S's kind; its rope factors
  // (S x hd / 2 of 16 bytes) fit in the GELU rows' buffer
  if (std::is_same<T, float>::value && !temporal &&
      (!(D / num_heads == 32 ? f32_frame_shape_ok<32>(attn_shape, S)
                             : f32_frame_shape_ok<64>(attn_shape, S)) ||
       Hd < 2 * (D / num_heads)))
    return (int)cudaErrorInvalidValue;
  const int chunks[kGemms] = {kc_qkv, kc_out, kc_fc1, kc_fc2};
  int nk[kGemms][2];
  gemm_shapes(D, Hd, nk);
  for (int i = 0; i < kGemms; ++i) {
    const int group = i == 3 ? G : nk[i][1];
    gemm_s8::Args p{};
    p.n_groups = nk[i][1] / group;
    p.group = group;
    p.M = M;
    p.N = nk[i][0];
    p.K = nk[i][1];
    p.S = S;
    p.k_chunk = chunks[i];
    p.part = static_cast<int*>(ws);
    if (!gemm_s8::valid(p)) return (int)cudaErrorInvalidValue;
  }
  size_t sizes[kBuffers];
  const size_t carved =
      workspace_layout(M, D, Hd, G, chunks, sizeof(T), sizes);
  unsigned long long* stamps = nullptr;
#ifdef GTAX_PAIR_PROBE
  // the probe's stamps follow the buffers: kStamps per block of the grid
  const int grid = blocks(temporal, D / num_heads, S, D);
  if (grid < 0) return -grid;
  if ((size_t)ws_bytes < carved + (size_t)grid * kStamps * 8)
    return (int)cudaErrorInvalidValue;
  stamps = reinterpret_cast<unsigned long long*>(static_cast<char*>(ws) +
                                                 carved);
#else
  (void)blocks;
#endif
  if ((size_t)ws_bytes < carved) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  void* buf[kBuffers];
  for (int i = 0; i < kBuffers; ++i) {
    buf[i] = w;
    w += align256(sizes[i]);
  }
  PairArgs a{
      x, sh1, sc1, g1, sh2, sc2, g2,
      p1_stride, g1_stride, p2_stride, g2_stride,
      static_cast<const float*>(qkv_s), static_cast<const float*>(out_s),
      static_cast<const float*>(w1_s), static_cast<const float*>(w2_s),
      out_b, b1, b2, out_b_f32, b1_f32, b2_f32,
      static_cast<const float*>(freqs), k_ctx, v_ctx, out,
      static_cast<signed char*>(buf[0]), static_cast<float*>(buf[1]),
      static_cast<float*>(buf[2]), static_cast<float*>(buf[3]),
      static_cast<signed char*>(buf[4]), static_cast<float*>(buf[5]),
      buf[6], static_cast<signed char*>(buf[7]),
      static_cast<float*>(buf[8]), static_cast<float*>(buf[9]),
      static_cast<signed char*>(buf[10]), static_cast<float*>(buf[11]),
      static_cast<int*>(buf[12]),
      {kc_qkv, kc_out, kc_fc1, kc_fc2},
      M, S, D, Hd, G, num_heads, B, n_live, n_ctx, valid_mask, stamps,
      exact_gelu, attn_shape};
  // the GEMMs' operands: the int8 rows of the workspace, and the weights
  PairMaps maps;
  const void* act[kGemms] = {a.mq1, a.aq, a.mq2, a.hq};
  const void* wt[kGemms] = {qkv_q, out_q, w1_q, w2_q};
  for (int i = 0; i < kGemms; ++i) {
    int rc = sm90::make_map(&maps.a[i], act[i], M, nk[i][1], 64, 1);
    if (rc) return rc;
    rc = sm90::make_map(&maps.b[i], wt[i], nk[i][0], nk[i][1], 64, 1);
    if (rc) return rc;
  }
  return launch(D / num_heads, temporal != 0, a, maps,
                (cudaStream_t)stream);
}

// The launches of T's kernels at head dims 32 and 64 with fc1's GELU exact
// (EXACT) or tanh: each mode is instantiated by a source of its own.
template <typename T, bool EXACT>
int launch_hd(int hd, bool temporal, const PairArgs& a, const PairMaps& maps,
              cudaStream_t st) {
  switch (hd * 2 + temporal) {
    case 64:
      return launch_gelu<32, false, EXACT, T>(a, maps, st);
    case 65:
      return launch_gelu<32, true, EXACT, T>(a, maps, st);
    case 128:
      return launch_gelu<64, false, EXACT, T>(a, maps, st);
    case 129:
      return launch_gelu<64, true, EXACT, T>(a, maps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The cooperative grid of T's (tanh-GELU) kernels, or minus a CUDA error.
template <typename T>
int blocks_hd(int temporal, int hd, int S, int D) {
  size_t smem = 0;
  switch (hd * 2 + (temporal != 0)) {
    case 64:
      return grid_blocks<32, false, false, T>(S, D, &smem);
    case 65:
      return grid_blocks<32, true, false, T>(S, D, &smem);
    case 128:
      return grid_blocks<64, false, false, T>(S, D, &smem);
    case 129:
      return grid_blocks<64, true, false, T>(S, D, &smem);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace
