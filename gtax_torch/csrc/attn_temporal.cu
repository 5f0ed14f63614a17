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
#include "common.cuh"

namespace {

constexpr int kMaxT = 8;
constexpr int kWarps = 8;

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_temporal_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ freqs,
                         const bf16* __restrict__ k_ctx,
                         const bf16* __restrict__ v_ctx, void* __restrict__ out,
                         int out_f32, bf16* __restrict__ q_out,
                         bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                         int B, int n_q, int q_off, int S, int D, int H,
                         int valid_mask) {
  constexpr int P = HD >= 64 ? HD / 64 : 1;  // dim pairs per lane
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= B * S * H) return;
  const int lane = threadIdx.x & 31;
  const int h = unit % H, s = (unit / H) % S, b = unit / (H * S);
  const float scale = 1.0f / sqrtf((float)HD);

  float2 q[kMaxT][P], kl[kMaxT][P], vl[kMaxT][P];  // live frames
  float2 kc[kMaxT][P], vc[kMaxT][P];               // cached context frames
#pragma unroll
  for (int f = 0; f < kMaxT; ++f) {
    if (f >= n_q) break;
    const size_t row = ((size_t)b * n_q + f) * S + s;
    const float* base = qkv + row * 3 * D + (size_t)h * HD;
    const float* fr = freqs + (size_t)(q_off + f) * HD;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c >= HD) continue;
      const float2 qv = rope_pair(*reinterpret_cast<const float2*>(base + c),
                                  fr + c);
      const float2 kv = rope_pair(
          *reinterpret_cast<const float2*>(base + D + c), fr + c);
      const float2 vv = *reinterpret_cast<const float2*>(base + 2 * D + c);
      q[f][p] = make_float2(bf16_round(qv.x), bf16_round(qv.y));
      kl[f][p] = make_float2(bf16_round(kv.x), bf16_round(kv.y));
      vl[f][p] = make_float2(bf16_round(vv.x), bf16_round(vv.y));
      if (k_out != nullptr) {
        const size_t o = row * D + (size_t)h * HD + c;
        store_pair(k_out, o, kv.x, kv.y);
        store_pair(v_out, o, vv.x, vv.y);
        if (q_out != nullptr) store_pair(q_out, o, qv.x, qv.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j >= q_off) break;
    const size_t o = (((size_t)b * q_off + j) * S + s) * D + (size_t)h * HD;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c >= HD) continue;
      kc[j][p] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(k_ctx + o + c));
      vc[j][p] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(v_ctx + o + c));
    }
  }

  auto dot = [&](const float2 (&a)[P], const float2 (&k)[P]) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (2 * lane + 64 * p < HD) {
        acc = fmaf(a[p].x, k[p].x, acc);
        acc = fmaf(a[p].y, k[p].y, acc);
      }
    return warp_sum(acc);
  };
  auto bias = [&](int qs, int ks) {
    return (((valid_mask >> ks) & 1) || ks == qs) ? 0.0f : -1e30f;
  };

#pragma unroll
  for (int i = 0; i < kMaxT; ++i) {
    if (i >= n_q) break;
    const int qs = q_off + i;  // the query's window slot
    float sc[kMaxT], sl[kMaxT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j >= q_off) break;
      sc[j] = dot(q[i], kc[j]) * scale + bias(qs, j);
      mx = fmaxf(mx, sc[j]);
    }
#pragma unroll
    for (int f = 0; f < kMaxT; ++f) {
      if (f > i) break;
      sl[f] = dot(q[i], kl[f]) * scale + bias(qs, q_off + f);
      mx = fmaxf(mx, sl[f]);
    }
    // keys in window-slot order: context slots, then live slots <= i
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j >= q_off) break;
      sc[j] = expf(sc[j] - mx);
      den += sc[j];
    }
#pragma unroll
    for (int f = 0; f < kMaxT; ++f) {
      if (f > i) break;
      sl[f] = expf(sl[f] - mx);
      den += sl[f];
    }
    float2 acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j >= q_off) break;
      const float pr = bf16_round(sc[j] / den);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[p].x = fmaf(pr, vc[j][p].x, acc[p].x);
        acc[p].y = fmaf(pr, vc[j][p].y, acc[p].y);
      }
    }
#pragma unroll
    for (int f = 0; f < kMaxT; ++f) {
      if (f > i) break;
      const float pr = bf16_round(sl[f] / den);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[p].x = fmaf(pr, vl[f][p].x, acc[p].x);
        acc[p].y = fmaf(pr, vl[f][p].y, acc[p].y);
      }
    }
    const size_t o = (((size_t)b * n_q + i) * S + s) * D + (size_t)h * HD;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c >= HD) continue;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o + c) = acc[p];
      else
        store_pair(static_cast<bf16*>(out), o + c, acc[p].x, acc[p].y);
    }
  }
}

template <int HD>
int launch(const float* qkv, const float* freqs, const bf16* kc,
           const bf16* vc, void* out, int out_f32, bf16* qo, bf16* ko,
           bf16* vo, int B, int n_q, int q_off, int S, int D, int H,
           int valid_mask, cudaStream_t st) {
  const int units = B * S * H;
  attn_temporal_kernel<HD><<<(units + kWarps - 1) / kWarps, kWarps * 32, 0,
                             st>>>(qkv, freqs, kc, vc, out, out_f32, qo, ko,
                                   vo, B, n_q, q_off, S, D, H, valid_mask);
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
