// The body of the attn_temporal kernel as a device function over one
// (batch element, site, head) unit, run by one warp, shared by
// attn_temporal.cu (kTemporalWarps units per block) and the paired int8
// kernels of pair_q.cu (units strided over a cooperative grid). A unit's
// arithmetic does not depend on which warp takes it, so the results are
// bit-equal. See attn_temporal.cu for the rounding points.
#pragma once

#include "common.cuh"

constexpr int kMaxT = 8;
constexpr int kTemporalWarps = 8;

// unit = (b * S + s) * H + h; warps whose unit is past B * S * H return.
template <int HD>
__device__ __forceinline__ void attn_temporal_unit(
    int unit, const float* __restrict__ qkv, const float* __restrict__ freqs,
    const bf16* __restrict__ k_ctx, const bf16* __restrict__ v_ctx,
    void* __restrict__ out, int out_f32, bf16* __restrict__ q_out,
    bf16* __restrict__ k_out, bf16* __restrict__ v_out, int B, int n_q,
    int q_off, int S, int D, int H, int valid_mask) {
  constexpr int P = HD >= 64 ? HD / 64 : 1;  // dim pairs per lane
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

// ------------------------------------- full window over bf16 q, k and v
//
// The layout of the full-window kernels over the bf16 post-rope q, k and v
// rows that the qkv product's rope epilogue stores (attn_temporal.cu
// attn_window, attn_bwd.cu attn_temporal_bwd): thread `gl` of the grid is
// the lane of dims [8 g, 8 g + 8) of site (b, s), g = gl % (D / 8), and
// loads and stores 16 bytes (eight bf16) of a row at a time. A head's
// HD / 8 lanes are an aligned group of a warp, so a dot product is the
// lane's eight products summed in order, then summed over the group by a
// butterfly of log2(HD / 8) shuffles (3 at hd 64). The window's T frames
// are a template parameter: every register array has the call's size, and
// all T frames' rows are loaded before the first score.

constexpr int kLaneDims = 8;  // a lane's dims: 16 bytes of bf16
constexpr int kWindowThreads = 256;

// The lane's place: the row of its site in frame 0 of its batch element
// (frame t is row + t * S) and its dims' columns, or live = false for the
// threads past the last site, which load nothing, store nothing and only
// join the shuffles.
struct WindowLane {
  bool live;
  size_t row;  // b * T * S + s
  int col;     // 8 g, the lane's first column of the row
  int hcol;    // 8 g % HD, its first dim within its head
};

template <int HD, int T>
__device__ __forceinline__ WindowLane window_lane(long long gl, int B, int S,
                                                  int D) {
  const int G = D / kLaneDims;
  WindowLane w;
  w.live = gl < (long long)B * S * G;
  const long long site = w.live ? gl / G : 0;
  const int g = (int)(gl - site * G);
  const long long b = site / S, s = site - b * S;
  w.row = (size_t)(b * T) * S + s;
  w.col = g * kLaneDims;
  w.hcol = w.col % HD;
  return w;
}

// The sum of v over the L lanes of an aligned group; every lane of the
// group gets it.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's eight products a[i] * b[i], added in order (fp32).
__device__ __forceinline__ float dot8(const float (&a)[8], uint4 b) {
  float f[8];
  unpack8(b, f);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(a[i], f[i], acc);
  return acc;
}

// The additive mask of temporal_preamble: causal, a key slot open when
// valid or on the diagonal, -1e30 when closed.
__device__ __forceinline__ float window_bias(int valid_mask, int qs, int ks) {
  return (((valid_mask >> ks) & 1) || ks == qs) ? 0.0f : -1e30f;
}

// One lane of the full-window forward: out = softmax(q k^T / sqrt(hd) +
// bias) v per (site, head), frames j <= i. Rounding as attn_temporal_unit:
// fp32 scores and softmax (expf, e / den), probabilities rounded to bf16,
// PV summed in fp32 in key order, one bf16 rounding of the output; only the
// order of a score's products differs (eight in a lane, then the lanes).
template <int HD, int T>
__device__ __forceinline__ void attn_window_lane(
    long long gl, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int B, int S, int D,
    int valid_mask) {
  constexpr int L = HD / kLaneDims;
  const WindowLane w = window_lane<HD, T>(gl, B, S, D);
  const float scale = 1.0f / sqrtf((float)HD);
  auto at = [&](int t) { return (w.row + (size_t)t * S) * D + w.col; };
  uint4 qr[T], kr[T], vr[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    qr[t] = w.live ? ldg16(q + at(t)) : z;
    kr[t] = w.live ? ldg16(k + at(t)) : z;
    vr[t] = w.live ? ldg16(v + at(t)) : z;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float qi[8], sc[T];
    unpack8(qr[i], qi);
#pragma unroll
    for (int j = 0; j <= i; ++j) sc[j] = dot8(qi, kr[j]);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      sc[j] = group_sum<L>(sc[j]) * scale + window_bias(valid_mask, i, j);
      mx = fmaxf(mx, sc[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      sc[j] = expf(sc[j] - mx);
      den += sc[j];
    }
    float acc[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[d] = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float pr = bf16_round(sc[j] / den);
      float vj[8];
      unpack8(vr[j], vj);
#pragma unroll
      for (int d = 0; d < 8; ++d) acc[d] = fmaf(pr, vj[d], acc[d]);
    }
    if (w.live) *reinterpret_cast<uint4*>(out + at(i)) = pack8(acc);
  }
}
