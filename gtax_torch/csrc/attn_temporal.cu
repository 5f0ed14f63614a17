// Causal attention across the frames of a window at each spatial site,
// per (batch element, site, head): one warp, each lane owning two of the
// head's dims.
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
// quantize the attention output, as the fp32 sums.
// Bound: bytes. A window holds at most 8 frames, so each site-head does at
// most 36 length-d dot products; the kernel reads q/k/v once with
// coalesced 8-byte lane loads and keeps everything else in registers.
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

}  // namespace

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
