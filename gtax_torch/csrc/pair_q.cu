// The paired int8 (W8A8) serving kernels: an attention branch and the MLP
// branch that follows it, one half of a DiT block, as ONE cooperative
// launch.
//
// Replaces gtax/kernels/pair.py fused_spatial_pair_q (pallas_call at :227,
// body _spatial_pair_kernel_q :114) and fused_temporal_pair_q (:303, body
// _temporal_pair_kernel_q :152): the spatial branch (or the incremental
// temporal step over the cached context K/V) then the MLP branch, equal to
// the sequential int8 wrappers of gtax_torch/kernels/quant.py. The TPU kernel
// keeps its intermediates in VMEM scratch and runs the attention under the
// first MLP chunk's grid step; Hopper has no sequential grid, so here every
// block of a grid that fits on the card at once walks nine phases, each
// striding its work units (rows, GEMM units of gemm_s8.cuh's weight-
// streaming tile, attention units) over the blocks, with a grid-wide
// barrier (cooperative_groups grid sync) between phases:
//   1. LN/modulate of x -> int8 rows + row scales          (ln_mod_row)
//   2. qkv GEMM, fp32 out                                  (gemm_s8 units)
//   3. attention, fp32 out: per (query tile, head, frame) for the spatial
//      branch (attn_frame_unit), per (batch, site, head) over the cached
//      context for the temporal step (attn_temporal_unit)
//   4. row quantization of the attention output   (quant_rows_unit, a warp)
//   5. out-projection + bias + gated residual -> bf16 xm   (gemm_s8 units)
//   6. LN/modulate of xm -> int8                           (ln_mod_row)
//   7. fc1 + bias + tanh-GELU, fp32                        (gemm_s8 units)
//   8. per-chunk quantization of the GELU output  (quant_rows_unit, a warp)
//   9. fc2 over the chunks as K groups, folded in chunk order, + bias +
//      gated residual -> out                               (gemm_s8 units)
// Every phase is the device function the sequential kernels run (the
// *.cuh headers), so the result is bit-equal to the sequential launches:
// xm is rounded to bf16 where the sequential pair stores it
// (gtax/kernels/pair.py:139), and fc2's groups fold in chunk order.
// Intermediates live in one workspace the wrapper allocates (about 12 MB
// at two frames, inside the 50 MB L2), with the GEMMs' split-K partials
// (one region the four GEMM phases share, read through L2 only); no other
// buffer is written after it was read within a launch, so no block can
// see a stale cached line. The GEMM phases' K chunks come from the wrapper's
// plan (gtax_torch/kernels/pair.py), and their operands arrive by TMA
// through tensor maps the entry point makes (cached on the host).
// Bound: bytes, the 12 MB of int8 weights at one or two frames. What the
// pair saves is host work and launches: one launch for nine.
#include <cooperative_groups.h>

#include <algorithm>

#include "attn_frame.cuh"
#include "attn_temporal.cuh"
#include "gemm_s8.cuh"
#include "ln_mod.cuh"
#include "quant_rows.cuh"

namespace cg = cooperative_groups;

namespace {

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
};

// The GEMMs' operands: A, the int8 activation rows, and B, the int8
// weights read as W^T (gemm_s8.cuh), one map each.
struct PairMaps {
  CUtensorMap a[kGemms];
  CUtensorMap b[kGemms];
};

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

template <int HD, bool TEMPORAL>
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
  // 7. fc1 + bias + tanh-GELU, fp32
  gemm_s8::gemm<gemm_s8::EPI_BIAS_GELU_F32>(ring, &maps.a[2], &maps.b[2],
                                            fc1);
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
template <int HD, bool TEMPORAL>
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
  const void* fn = reinterpret_cast<const void*>(pair_q_kernel<HD, TEMPORAL>);
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

template <int HD, bool TEMPORAL>
int launch(const PairArgs& a, const PairMaps& maps, cudaStream_t st) {
  size_t smem = 0;
  const int blocks = grid_blocks<HD, TEMPORAL>(a.S, a.D, &smem);
  if (blocks < 0) return -blocks;
  void* params[] = {const_cast<PairArgs*>(&a), const_cast<PairMaps*>(&maps)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pair_q_kernel<HD, TEMPORAL>),
      dim3(blocks), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool TEMPORAL>
int grid_blocks_for(int hd, int S, int D) {
  size_t smem = 0;
  switch (hd) {
    case 32:
      return grid_blocks<32, TEMPORAL>(S, D, &smem);
    case 64:
      return grid_blocks<64, TEMPORAL>(S, D, &smem);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The cooperative grid's block count for these shapes (what a launch
// uses), or minus a CUDA error code.
GTAX_ENTRY gtax_pair_q_blocks(int temporal, int hd, int S, int D) {
  return temporal ? grid_blocks_for<true>(hd, S, D)
                  : grid_blocks_for<false>(hd, S, D);
}

// One paired half-block. x: (M, D) bf16 rows, M = frames * S (spatial) or
// B * n_live * S (temporal, frame-major within a batch element);
// sh*/sc*/g*: per-frame bf16 rows of the given strides (shift and scale of
// a branch share theirs); *_q int8 (in, out) kernels stored column-major
// (W^T row-major), *_s fp32 column scales, biases fp32 (*_f32 = 1) or
// bf16; Hd the MLP width, G its chunk width; freqs: spatial (S, hd) rope
// table, temporal (n_ctx + n_live, hd); k_ctx/v_ctx: temporal only;
// valid_mask: bit j = window slot j is real; kc_*: the K chunks of the
// qkv, out-projection, fc1 and fc2 GEMMs (gemm_s8.cuh); ws: workspace of
// at least the bytes workspace_layout gives.
GTAX_ENTRY gtax_pair_q(
    int temporal, const void* x, const void* sh1, const void* sc1,
    const void* g1, const void* sh2, const void* sc2, const void* g2,
    int p1_stride, int g1_stride, int p2_stride, int g2_stride,
    const void* qkv_q, const void* qkv_s, const void* out_q,
    const void* out_s, const void* out_b, int out_b_f32, const void* w1_q,
    const void* w1_s, const void* b1, int b1_f32, const void* w2_q,
    const void* w2_s, const void* b2, int b2_f32, const void* freqs,
    const void* k_ctx, const void* v_ctx, void* out, void* ws,
    long long ws_bytes, int M, int S, int D, int Hd, int G, int num_heads,
    int B, int n_live, int n_ctx, int valid_mask, int kc_qkv, int kc_out,
    int kc_fc1, int kc_fc2, void* stream) {
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
  const size_t carved = workspace_layout(M, D, Hd, G, chunks, sizes);
  unsigned long long* stamps = nullptr;
#ifdef GTAX_PAIR_PROBE
  // the probe's stamps follow the buffers: kStamps per block of the grid
  const int blocks = temporal ? grid_blocks_for<true>(D / num_heads, S, D)
                              : grid_blocks_for<false>(D / num_heads, S, D);
  if (blocks < 0) return -blocks;
  if ((size_t)ws_bytes < carved + (size_t)blocks * kStamps * 8)
    return (int)cudaErrorInvalidValue;
  stamps = reinterpret_cast<unsigned long long*>(static_cast<char*>(ws) +
                                                 carved);
#endif
  if ((size_t)ws_bytes < carved) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  void* buf[kBuffers];
  for (int i = 0; i < kBuffers; ++i) {
    buf[i] = w;
    w += align256(sizes[i]);
  }
  PairArgs a{
      static_cast<const bf16*>(x),
      static_cast<const bf16*>(sh1), static_cast<const bf16*>(sc1),
      static_cast<const bf16*>(g1), static_cast<const bf16*>(sh2),
      static_cast<const bf16*>(sc2), static_cast<const bf16*>(g2),
      p1_stride, g1_stride, p2_stride, g2_stride,
      static_cast<const float*>(qkv_s), static_cast<const float*>(out_s),
      static_cast<const float*>(w1_s), static_cast<const float*>(w2_s),
      out_b, b1, b2, out_b_f32, b1_f32, b2_f32,
      static_cast<const float*>(freqs),
      static_cast<const bf16*>(k_ctx), static_cast<const bf16*>(v_ctx),
      static_cast<bf16*>(out),
      static_cast<signed char*>(buf[0]), static_cast<float*>(buf[1]),
      static_cast<float*>(buf[2]), static_cast<float*>(buf[3]),
      static_cast<signed char*>(buf[4]), static_cast<float*>(buf[5]),
      static_cast<bf16*>(buf[6]), static_cast<signed char*>(buf[7]),
      static_cast<float*>(buf[8]), static_cast<float*>(buf[9]),
      static_cast<signed char*>(buf[10]), static_cast<float*>(buf[11]),
      static_cast<int*>(buf[12]),
      {kc_qkv, kc_out, kc_fc1, kc_fc2},
      M, S, D, Hd, G, num_heads, B, n_live, n_ctx, valid_mask, stamps};
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
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = D / num_heads;
  if (temporal) {
    switch (hd) {
      case 32:
        return launch<32, true>(a, maps, st);
      case 64:
        return launch<64, true>(a, maps, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32:
      return launch<32, false>(a, maps, st);
    case 64:
      return launch<64, false>(a, maps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
