// Causal attention across the frames of a window at each spatial site.
// Two kernels:
//   - attn_window (the bf16 temporal branch's full window: serving, the
//     prefill's emit_kv and training's emit_train): q, k, v come in as bf16
//     rows after rope, stored by the qkv product's epilogue
//     (gtax_gemm_rope_qkv), which also makes them the emitted K/V cache and
//     residuals; each lane owns 16 bytes (8 dims) of a row, a head's hd / 8
//     lanes sum a score by a butterfly (attn_window_lane, attn_temporal.cuh);
//   - attn_temporal (the bf16 step over the cached context, the int8
//     branches): one warp per (batch element, site, head), each lane owning
//     two of the head's dims, reading the fp32 qkv product and applying rope
//     itself (attn_temporal_unit, shared with pair_q.cu).
//
// Replaces the attention cores of the TPU temporal kernels
// (gtax/kernels/block.py _temporal_attention_core for the full window,
// with the emit_kv context-cache output, and _temporal_step_core for the
// incremental step, whose live rows attend to the cached roped context K/V
// and to themselves; for training, the emit_train residuals: roped q and k
// and cast v). The additive bias is built here from the slot
// validity bits exactly as temporal_preamble builds it: causal, a key
// slot is open if valid or on the diagonal, closed slots get -1e30.
// Rounding: rope in fp32, q/k/v cast to bf16, fp32 scores and softmax,
// probabilities cast to bf16, PV accumulated in fp32 (the TPU kernel
// rounded each product and partial sum to bf16; the bf16 tolerance covers
// the difference), stored as bf16 or, for the int8 temporal branches that
// quantize the attention output, as the fp32 sums. The two kernels add a
// score's products in another order (ROADMAP.md section C).
// Bound: bytes. A window holds at most 8 frames, so each site-head does at
// most 36 length-d dot products; each kernel reads its rows once with
// coalesced lane loads and keeps everything else in registers. At the B=16
// training step attn_window moves 94.4 MB (q, k, v in, the output out).
// The fp32 branches (#3 and #4 at x.dtype = float32) take the fp32 forms of
// both: attn_window_f32 over fp32 post-rope q, k, v (four dims a lane, so
// a lane's rows stay in registers at T = 8) and attn_temporal_f32 over an
// fp32 context cache, which the fp32 int8 temporal branch (#8 at x.dtype =
// float32) also runs over its full window, rope on load from the int8 qkv
// product's fp32 rows, with fp32 K/V stores; nothing is rounded,
// probabilities included.
#include <initializer_list>

#include "attn_temporal.cuh"

namespace {

// kTemporalWarps units per block, one per warp; the body is
// attn_temporal_unit (attn_temporal.cuh)
template <int HD>
__global__ void __launch_bounds__(kTemporalWarps * 32)
    attn_temporal_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ freqs,
                         const bf16* __restrict__ k_ctx,
                         const bf16* __restrict__ v_ctx, void* __restrict__ out,
                         int out_f32, bf16* __restrict__ q_out,
                         bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                         int B, int n_q, int q_off, int S, int D, int H,
                         int valid_mask) {
  attn_temporal_unit<HD>(blockIdx.x * kTemporalWarps + (threadIdx.x >> 5),
                         qkv, freqs, k_ctx, v_ctx, out, out_f32, q_out, k_out,
                         v_out, B, n_q, q_off, S, D, H, valid_mask);
}

template <int HD>
int launch(const float* qkv, const float* freqs, const bf16* kc,
           const bf16* vc, void* out, int out_f32, bf16* qo, bf16* ko,
           bf16* vo, int B, int n_q, int q_off, int S, int D, int H,
           int valid_mask, cudaStream_t st) {
  const int units = B * S * H;
  const int blocks = (units + kTemporalWarps - 1) / kTemporalWarps;
  attn_temporal_kernel<HD><<<blocks, kTemporalWarps * 32, 0, st>>>(
      qkv, freqs, kc, vc, out, out_f32, qo, ko, vo, B, n_q, q_off, S, D, H,
      valid_mask);
  return (int)cudaGetLastError();
}

// The full-window kernel over bf16 post-rope q, k, v: kWindowThreads
// lanes a block, the body attn_window_lane (attn_temporal.cuh).
template <int HD, int T>
__global__ void __launch_bounds__(kWindowThreads)
    attn_window_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int B, int S, int D, int valid_mask) {
  attn_window_lane<HD, T>((long long)blockIdx.x * kWindowThreads +
                              threadIdx.x,
                          q, k, v, out, B, S, D, valid_mask);
}

template <int HD, int T>
int launch_window(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                  int B, int S, int D, int valid_mask, cudaStream_t st) {
  const long long lanes = (long long)B * S * (D / kLaneDims);
  const long long blocks = (lanes + kWindowThreads - 1) / kWindowThreads;
  attn_window_kernel<HD, T><<<(unsigned)blocks, kWindowThreads, 0, st>>>(
      q, k, v, out, B, S, D, valid_mask);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_window_t(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                    int B, int T, int S, int D, int valid_mask,
                    cudaStream_t st) {
  switch (T) {
#define GTAX_WINDOW_CASE(N) \
  case N:                   \
    return launch_window<HD, N>(q, k, v, out, B, S, D, valid_mask, st);
    GTAX_WINDOW_CASE(1)
    GTAX_WINDOW_CASE(2)
    GTAX_WINDOW_CASE(3)
    GTAX_WINDOW_CASE(4)
    GTAX_WINDOW_CASE(5)
    GTAX_WINDOW_CASE(6)
    GTAX_WINDOW_CASE(7)
    GTAX_WINDOW_CASE(8)
#undef GTAX_WINDOW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- fp32

// The fp32 unit, attn_temporal_unit with KV = float: the step over an fp32
// context cache, or the full window (q_off = 0) with optional fp32 K/V
// outputs (the fp32 int8 prefill's emit_kv: rope on load from the int8
// qkv product's fp32 rows) and, with them, the roped Q (the fp32 int8
// branch's emit_train residuals).
template <int HD>
__global__ void __launch_bounds__(kTemporalWarps * 32)
    attn_temporal_f32_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ freqs,
                             const float* __restrict__ k_ctx,
                             const float* __restrict__ v_ctx,
                             float* __restrict__ out, float* __restrict__ q_out,
                             float* __restrict__ k_out,
                             float* __restrict__ v_out, int B, int n_q,
                             int q_off, int S, int D, int H, int valid_mask) {
  attn_temporal_unit<HD, float>(
      blockIdx.x * kTemporalWarps + (threadIdx.x >> 5), qkv, freqs, k_ctx,
      v_ctx, out, 1, q_out, k_out, v_out, B, n_q, q_off, S, D, H,
      valid_mask);
}

template <int HD>
int launch_f32(const float* qkv, const float* freqs, const float* kc,
               const float* vc, float* out, float* qo, float* ko, float* vo,
               int B, int n_q, int q_off, int S, int D, int H, int valid_mask,
               cudaStream_t st) {
  const int blocks = (B * S * H + kTemporalWarps - 1) / kTemporalWarps;
  attn_temporal_f32_kernel<HD><<<blocks, kTemporalWarps * 32, 0, st>>>(
      qkv, freqs, kc, vc, out, qo, ko, vo, B, n_q, q_off, S, D, H,
      valid_mask);
  return (int)cudaGetLastError();
}

// The full window over fp32 post-rope q, k, v: attn_window_lane_f32.
template <int HD, int T>
__global__ void __launch_bounds__(kWindowThreads)
    attn_window_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int B, int S, int D,
                           int valid_mask) {
  attn_window_lane_f32<HD, T>(
      (long long)blockIdx.x * kWindowThreads + threadIdx.x, q, k, v, out, B,
      S, D, valid_mask);
}

template <int HD>
int launch_window_f32(const float* q, const float* k, const float* v,
                      float* out, int B, int T, int S, int D, int valid_mask,
                      cudaStream_t st) {
  const long long lanes = (long long)B * S * (D / kLaneDimsF32);
  const unsigned blocks =
      (unsigned)((lanes + kWindowThreads - 1) / kWindowThreads);
  switch (T) {
#define GTAX_WINDOW_CASE(N)                                                \
  case N:                                                                  \
    attn_window_f32_kernel<HD, N><<<blocks, kWindowThreads, 0, st>>>(      \
        q, k, v, out, B, S, D, valid_mask);                                \
    return (int)cudaGetLastError();
    GTAX_WINDOW_CASE(1)
    GTAX_WINDOW_CASE(2)
    GTAX_WINDOW_CASE(3)
    GTAX_WINDOW_CASE(4)
    GTAX_WINDOW_CASE(5)
    GTAX_WINDOW_CASE(6)
    GTAX_WINDOW_CASE(7)
    GTAX_WINDOW_CASE(8)
#undef GTAX_WINDOW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B * T * S, D) bf16, frame-major within each batch element,
// q and k after rope (the qkv product's rope epilogue, gtax_gemm_rope_qkv);
// T in 1 .. kMaxT; valid_mask: bit j = window slot j holds a real frame.
// The full-window attention of the temporal branch, frames j <= i.
GTAX_ENTRY gtax_attn_temporal_window(const void* q, const void* k,
                                     const void* v, void* out, int B, int T,
                                     int S, int D, int num_heads,
                                     int valid_mask, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || S <= 0 || num_heads <= 0 ||
      D % num_heads)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_window_t<32>(qb, kb, vb, o, B, T, S, D, valid_mask, st);
    case 64:
      return launch_window_t<64>(qb, kb, vb, o, B, T, S, D, valid_mask, st);
    case 128:
      return launch_window_t<128>(qb, kb, vb, o, B, T, S, D, valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// qkv: (B * n_q * S, 3D) fp32, frame-major within each batch element, the
// n_q query frames sitting at window slots q_off .. q_off + n_q - 1;
// freqs: (q_off + n_q, hd) fp32 temporal rotary table;
// k_ctx/v_ctx: (B * q_off * S, D) bf16 roped context cache (q_off > 0);
// out: (B * n_q * S, D) fp32 (out_f32 = 1) or bf16;
// k_out/v_out: optional (B * n_q * S, D) bf16 outputs of the roped K and
// cast V (the context cache a prefill emits); q_out: optional, with k_out,
// the roped Q (the emit_train residuals); valid_mask: bit j = slot j holds a
// real frame.
GTAX_ENTRY gtax_attn_temporal(const void* qkv, const void* freqs,
                              const void* k_ctx, const void* v_ctx, void* out,
                              int out_f32, void* q_out, void* k_out,
                              void* v_out, int B, int n_q, int q_off, int S,
                              int D, int num_heads, int valid_mask,
                              void* stream) {
  if (B <= 0 || n_q <= 0 || q_off < 0 || n_q + q_off > kMaxT || S <= 0 ||
      num_heads <= 0 || D % num_heads ||
      (q_off > 0 && (k_ctx == nullptr || v_ctx == nullptr)) ||
      ((k_out == nullptr) != (v_out == nullptr)) ||
      (q_out != nullptr && k_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* f = static_cast<const float*>(freqs);
  const bf16* kc = static_cast<const bf16*>(k_ctx);
  const bf16* vc = static_cast<const bf16*>(v_ctx);
  bf16* qo = static_cast<bf16*>(q_out);
  bf16* ko = static_cast<bf16*>(k_out);
  bf16* vo = static_cast<bf16*>(v_out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch<32>(q, f, kc, vc, out, out_f32, qo, ko, vo, B, n_q, q_off,
                        S, D, num_heads, valid_mask, st);
    case 64:
      return launch<64>(q, f, kc, vc, out, out_f32, qo, ko, vo, B, n_q, q_off,
                        S, D, num_heads, valid_mask, st);
    case 128:
      return launch<128>(q, f, kc, vc, out, out_f32, qo, ko, vo, B, n_q,
                         q_off, S, D, num_heads, valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 forms of the two entry points above: the full window over q,
// k, v, out (B * T * S, D) fp32 (q and k after rope:
// gtax_gemm_f32_rope_qkv), and gtax_attn_temporal's arguments in fp32:
// qkv (B * n_q * S, 3D), the fp32 context cache k_ctx / v_ctx
// (B * q_off * S, D), out (B * n_q * S, D), and the optional fp32 K/V
// outputs k_out / v_out (B * n_q * S, D), with q_out (only beside them)
// the roped Q. Nothing is rounded.
GTAX_ENTRY gtax_attn_temporal_window_f32(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int T, int S, int D, int num_heads,
                                         int valid_mask, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || S <= 0 || num_heads <= 0 ||
      D % num_heads)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_window_f32<32>(qf, kf, vf, o, B, T, S, D, valid_mask, st);
    case 64:
      return launch_window_f32<64>(qf, kf, vf, o, B, T, S, D, valid_mask, st);
    case 128:
      return launch_window_f32<128>(qf, kf, vf, o, B, T, S, D, valid_mask,
                                    st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 step of #4: attn_step_lane_f32, one thread a lane.
template <int HD, int T>
__global__ void __launch_bounds__(kWindowThreads)
    attn_step_f32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ freqs,
                         const float* __restrict__ k_ctx,
                         const float* __restrict__ v_ctx,
                         float* __restrict__ out, int B, int q_off, int S,
                         int D, int valid_mask) {
  asm volatile("griddepcontrol.launch_dependents;");
  attn_step_lane_f32<HD, T>(
      (long long)blockIdx.x * kWindowThreads + threadIdx.x, qkv, freqs,
      k_ctx, v_ctx, out, B, q_off, S, D, valid_mask);
}

template <int HD, int T>
int launch_step_f32(const float* qkv, const float* freqs, const float* kc,
                    const float* vc, float* out, int B, int q_off, int S,
                    int D, int valid_mask, cudaStream_t st) {
  const long long lanes = (long long)B * S * (D / kLaneDimsF32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((lanes + kWindowThreads - 1) /
                                kWindowThreads));
  cfg.blockDim = dim3(kWindowThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];  // a programmatic dependent of the qkv product
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_step_f32_kernel<HD, T>,
                                           qkv, freqs, kc, vc, out, B, q_off,
                                           S, D, valid_mask);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_step_f32_t(int T, const float* qkv, const float* freqs,
                      const float* kc, const float* vc, float* out, int B,
                      int q_off, int S, int D, int valid_mask,
                      cudaStream_t st) {
  switch (T) {
#define GTAX_STEP_CASE(N)                                                \
  case N:                                                                \
    return launch_step_f32<HD, N>(qkv, freqs, kc, vc, out, B, q_off, S, D, \
                                  valid_mask, st);
    GTAX_STEP_CASE(1)
    GTAX_STEP_CASE(2)
    GTAX_STEP_CASE(3)
    GTAX_STEP_CASE(4)
    GTAX_STEP_CASE(5)
    GTAX_STEP_CASE(6)
    GTAX_STEP_CASE(7)
    GTAX_STEP_CASE(8)
#undef GTAX_STEP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// #4's fp32 step: out (B n_q S, D) fp32 = the live frames' attention (the
// fp32 qkv rows (B n_q S, 3D), rope on load at slots q_off ..) over the
// fp32 cache k_ctx / v_ctx (B q_off S, D, post-rope) and themselves
// (attn_step_lane_f32); every row 16-byte aligned, q_off + n_q <= kMaxT.
GTAX_ENTRY gtax_attn_step_f32(const void* qkv, const void* freqs,
                              const void* k_ctx, const void* v_ctx,
                              void* out, int B, int n_q, int q_off, int S,
                              int D, int num_heads, int valid_mask,
                              void* stream) {
  if (B <= 0 || n_q <= 0 || q_off < 0 || n_q + q_off > kMaxT || S <= 0 ||
      num_heads <= 0 || D % num_heads || D % kLaneDimsF32 ||
      (q_off > 0 && (k_ctx == nullptr || v_ctx == nullptr)))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {qkv, k_ctx, v_ctx, (const void*)out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* f = static_cast<const float*>(freqs);
  const float* kc = static_cast<const float*>(k_ctx);
  const float* vc = static_cast<const float*>(v_ctx);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  const int T = n_q + q_off;
  switch (D / num_heads) {
    case 32:
      return launch_step_f32_t<32>(T, q, f, kc, vc, o, B, q_off, S, D,
                                   valid_mask, st);
    case 64:
      return launch_step_f32_t<64>(T, q, f, kc, vc, o, B, q_off, S, D,
                                   valid_mask, st);
    case 128:
      return launch_step_f32_t<128>(T, q, f, kc, vc, o, B, q_off, S, D,
                                    valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

GTAX_ENTRY gtax_attn_temporal_f32(const void* qkv, const void* freqs,
                                  const void* k_ctx, const void* v_ctx,
                                  void* out, void* q_out, void* k_out,
                                  void* v_out, int B, int n_q, int q_off,
                                  int S, int D, int num_heads, int valid_mask,
                                  void* stream) {
  if (B <= 0 || n_q <= 0 || q_off < 0 || n_q + q_off > kMaxT || S <= 0 ||
      num_heads <= 0 || D % num_heads ||
      (q_off > 0 && (k_ctx == nullptr || v_ctx == nullptr)) ||
      ((k_out == nullptr) != (v_out == nullptr)) ||
      (q_out != nullptr && k_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* f = static_cast<const float*>(freqs);
  const float* kc = static_cast<const float*>(k_ctx);
  const float* vc = static_cast<const float*>(v_ctx);
  float* o = static_cast<float*>(out);
  float* qo = static_cast<float*>(q_out);
  float* ko = static_cast<float*>(k_out);
  float* vo = static_cast<float*>(v_out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_f32<32>(q, f, kc, vc, o, qo, ko, vo, B, n_q, q_off, S, D,
                            num_heads, valid_mask, st);
    case 64:
      return launch_f32<64>(q, f, kc, vc, o, qo, ko, vo, B, n_q, q_off, S, D,
                            num_heads, valid_mask, st);
    case 128:
      return launch_f32<128>(q, f, kc, vc, o, qo, ko, vo, B, n_q, q_off, S,
                             D, num_heads, valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
