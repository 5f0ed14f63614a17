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

// T itself, where deduction must not look (the cache pointers may be null)
template <typename T>
struct same_as {
  using type = T;
};

// A value at the rounding points of the unit's type: bf16-rounded for the
// bf16 branches, as it is for the fp32 ones.
template <typename KV>
__device__ __forceinline__ float kv_round(float v) {
  return v;
}
template <>
__device__ __forceinline__ float kv_round<bf16>(float v) {
  return bf16_round(v);
}

// A context pair (c, c + 1) of the K/V cache, bf16 or fp32, as fp32.
__device__ __forceinline__ float2 load_ctx(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_ctx(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// unit = (b * S + s) * H + h; warps whose unit is past B * S * H return.
// KV = bf16: the bf16 branches' rounding (q, k, v and the probabilities
// cast to bf16, a bf16 context cache, bf16 q/k/v outputs); KV = float: the
// fp32 branches', with nothing rounded, an fp32 cache, an fp32 output
// (out_f32 = 1) and fp32 q/k/v outputs (the fp32 int8 prefill's K/V cache).
template <int HD, typename KV = bf16>
__device__ __forceinline__ void attn_temporal_unit(
    int unit, const float* __restrict__ qkv, const float* __restrict__ freqs,
    const typename same_as<KV>::type* __restrict__ k_ctx,
    const typename same_as<KV>::type* __restrict__ v_ctx,
    void* __restrict__ out, int out_f32,
    typename same_as<KV>::type* __restrict__ q_out,
    typename same_as<KV>::type* __restrict__ k_out,
    typename same_as<KV>::type* __restrict__ v_out, int B, int n_q,
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
      q[f][p] = make_float2(kv_round<KV>(qv.x), kv_round<KV>(qv.y));
      kl[f][p] = make_float2(kv_round<KV>(kv.x), kv_round<KV>(kv.y));
      vl[f][p] = make_float2(kv_round<KV>(vv.x), kv_round<KV>(vv.y));
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
      kc[j][p] = load_ctx(k_ctx + o + c);
      vc[j][p] = load_ctx(v_ctx + o + c);
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
      const float pr = kv_round<KV>(sc[j] / den);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        acc[p].x = fmaf(pr, vc[j][p].x, acc[p].x);
        acc[p].y = fmaf(pr, vc[j][p].y, acc[p].y);
      }
    }
#pragma unroll
    for (int f = 0; f < kMaxT; ++f) {
      if (f > i) break;
      const float pr = kv_round<KV>(sl[f] / den);
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

// ------------------------------------- full window over fp32 q, k and v
//
// The fp32 branches' full window (gtax's temporal kernel at x.dtype =
// float32: nothing rounded, probabilities included), over the fp32
// post-rope q, k, v rows of gtax_gemm_f32_rope_qkv. As the bf16 lanes
// above, but a lane owns four dims (16 bytes of fp32), so its registers
// hold 12 T floats of rows (96 at T = 8) where eight dims would take 192;
// a head's HD / 4 lanes are an aligned group of a warp (a whole warp at
// hd 128) and sum a score by a butterfly of log2(HD / 4) shuffles.

constexpr int kLaneDimsF32 = 4;

template <int HD, int T>
__device__ __forceinline__ void attn_window_lane_f32(
    long long gl, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int B, int S,
    int D, int valid_mask) {
  constexpr int L = HD / kLaneDimsF32;
  const int G = D / kLaneDimsF32;
  const bool live = gl < (long long)B * S * G;
  const long long site = live ? gl / G : 0;
  const int col = (int)(gl - site * G) * kLaneDimsF32;
  const long long b = site / S, s = site - b * S;
  const size_t row = (size_t)(b * T) * S + s;
  const float scale = 1.0f / sqrtf((float)HD);
  auto at = [&](int t) { return (row + (size_t)t * S) * D + col; };
  float4 qr[T], kr[T], vr[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[t] = live ? __ldg(reinterpret_cast<const float4*>(q + at(t))) : z;
    kr[t] = live ? __ldg(reinterpret_cast<const float4*>(k + at(t))) : z;
    vr[t] = live ? __ldg(reinterpret_cast<const float4*>(v + at(t))) : z;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float sc[T];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = 0.f;  // the lane's four products, in order
      acc = fmaf(qr[i].x, kr[j].x, acc);
      acc = fmaf(qr[i].y, kr[j].y, acc);
      acc = fmaf(qr[i].z, kr[j].z, acc);
      acc = fmaf(qr[i].w, kr[j].w, acc);
      sc[j] = group_sum<L>(acc) * scale + window_bias(valid_mask, i, j);
      mx = fmaxf(mx, sc[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      sc[j] = expf(sc[j] - mx);
      den += sc[j];
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float pr = sc[j] / den;
      o.x = fmaf(pr, vr[j].x, o.x);
      o.y = fmaf(pr, vr[j].y, o.y);
      o.z = fmaf(pr, vr[j].z, o.z);
      o.w = fmaf(pr, vr[j].w, o.w);
    }
    if (live) *reinterpret_cast<float4*>(out + at(i)) = o;
  }
}

// The fp32 step (#4 at x.dtype = float32): the live frames' rows of the
// fp32 qkv product (rope on load) against the fp32 cache of the context
// slots (post-rope), one lane four dims (16 bytes) of a site's row, a
// head's HD / 4 lanes an aligned group summing a score by a butterfly.
// Each (slot, dim) angle is reduced once a lane (sincosf, a pair's second
// angle taking the first's values where the table repeats it, as
// rope_pair_t does) and the factors rope both the slot's q and its k. Keys
// in window-slot order (context, then live slots <= the query's), scores
// and softmax as attn_temporal_unit's, nothing rounded; only a score's
// product order differs from attn_temporal_unit's (four in a lane, then
// the lanes). T = q_off + n_q slots; the live frames are slots q_off ..
// T - 1.
template <int HD, int T>
__device__ __forceinline__ void attn_step_lane_f32(
    long long gl, const float* __restrict__ qkv,
    const float* __restrict__ freqs, const float* __restrict__ k_ctx,
    const float* __restrict__ v_ctx, float* __restrict__ out, int B,
    int q_off, int S, int D, int valid_mask) {
  constexpr int L = HD / kLaneDimsF32;
  const int G = D / kLaneDimsF32, n_q = T - q_off;
  const bool live = gl < (long long)B * S * G;
  const long long site = live ? gl / G : 0;
  const int col = (int)(gl - site * G) * kLaneDimsF32, hc = col % HD;
  const long long b = site / S, s = site - b * S;
  const float scale = 1.0f / sqrtf((float)HD);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 q[T], k[T], v[T];  // by window slot; q at the live slots
#pragma unroll
  for (int t = 0; t < T; ++t) {
    q[t] = z;
    // the cache is the grid before's input: the qkv rows, that grid's
    // output, are read after its end (a no-op unless launched as its
    // programmatic dependent)
    if (t == q_off) asm volatile("griddepcontrol.wait;" ::: "memory");
    if (t < q_off) {
      const size_t o = ((size_t)(b * q_off + t) * S + s) * D + col;
      k[t] = live ? __ldg(reinterpret_cast<const float4*>(k_ctx + o)) : z;
      v[t] = live ? __ldg(reinterpret_cast<const float4*>(v_ctx + o)) : z;
      continue;
    }
    const size_t row = (size_t)(b * n_q + (t - q_off)) * S + s;
    const float* base = qkv + row * 3 * D + col;
    const float4 qv =
        live ? __ldg(reinterpret_cast<const float4*>(base)) : z;
    const float4 kv =
        live ? __ldg(reinterpret_cast<const float4*>(base + D)) : z;
    v[t] = live ? __ldg(reinterpret_cast<const float4*>(base + 2 * D)) : z;
    const float* fr = freqs + (size_t)t * HD + hc;
    float c[4], sn[4];
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      sincosf(fr[i], &sn[i], &c[i]);
      if (fr[i + 1] == fr[i]) {
        sn[i + 1] = sn[i];
        c[i + 1] = c[i];
      } else {
        sincosf(fr[i + 1], &sn[i + 1], &c[i + 1]);
      }
    }
    const float2 q0 = rope_pair_cs(make_float2(qv.x, qv.y), c[0], sn[0],
                                   c[1], sn[1]);
    const float2 q1 = rope_pair_cs(make_float2(qv.z, qv.w), c[2], sn[2],
                                   c[3], sn[3]);
    const float2 k0 = rope_pair_cs(make_float2(kv.x, kv.y), c[0], sn[0],
                                   c[1], sn[1]);
    const float2 k1 = rope_pair_cs(make_float2(kv.z, kv.w), c[2], sn[2],
                                   c[3], sn[3]);
    q[t] = make_float4(q0.x, q0.y, q1.x, q1.y);
    k[t] = make_float4(k0.x, k0.y, k1.x, k1.y);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (i < q_off) continue;  // the live query slots
    float sc[T];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = 0.f;  // the lane's four products, in order
      acc = fmaf(q[i].x, k[j].x, acc);
      acc = fmaf(q[i].y, k[j].y, acc);
      acc = fmaf(q[i].z, k[j].z, acc);
      acc = fmaf(q[i].w, k[j].w, acc);
      sc[j] = group_sum<L>(acc) * scale + window_bias(valid_mask, i, j);
      mx = fmaxf(mx, sc[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      sc[j] = expf(sc[j] - mx);
      den += sc[j];
    }
    float4 o = z;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float pr = sc[j] / den;
      o.x = fmaf(pr, v[j].x, o.x);
      o.y = fmaf(pr, v[j].y, o.y);
      o.z = fmaf(pr, v[j].z, o.z);
      o.w = fmaf(pr, v[j].w, o.w);
    }
    const size_t r = (size_t)(b * n_q + (i - q_off)) * S + s;
    if (live) *reinterpret_cast<float4*>(out + r * D + col) = o;
  }
}
