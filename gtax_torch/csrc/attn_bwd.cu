// Attention backward of the DiT branches, from the emitted post-rope q/k and
// cast v (the emit_train residuals): per-frame spatial attention
// (attn_frame_bwd) and causal temporal attention at each site
// (attn_temporal_bwd). Each recomputes the probabilities P, writes the
// attention output O = P V that the out-projection's weight gradient needs,
// and writes dq, dk (rope adjoint applied) and dv into one (rows, 3D) bf16
// buffer laid out as the qkv projection's output.
//
// Replaces the attention parts of gtax/kernels/backward.py
// _spatial_bwd_kernel (the per-head recompute and backward loops and
// _rope_transpose_rows) and _temporal_bwd_kernel (the causal frame-pair
// loops with the additive slot bias of temporal_preamble: causal, a key
// slot open when valid or on the diagonal, -1e30 when closed).
// Math and rounding as the TPU kernels: fp32 scores and softmax,
//   dV = bf16(P)^T dO, dP = dO V^T, dS = bf16(P * (dP - rowsum(dP * P)) / sqrt(d)),
//   dQ = dS K, dK = dS^T Q  (fp32 sums), rope adjoint in fp32, one bf16
// rounding of each output. The temporal scores sum q*k in fp32 where the
// TPU kernel rounds each product to bf16, as the port's forward does.
// Bound: operations for the spatial kernel (six S x S x d products per
// (frame, head): the scores, dP, O, dQ, dK, dV); bytes for the temporal one
// (T <= 8 keys per query).
// Design (first version): the products run on the fp32 pipes. attn_frame_bwd
// keeps one (frame, head) in shared memory: Q, K, V, dO (bf16) and the
// bf16 P and dS matrices (S = 144: 163 KB, hence the dynamic shared-memory
// opt-in). Phase A, one warp per query row: scores, softmax, dP, dS, then
// O and dQ; phase B, one warp per key row: dK and dV from the columns of
// dS and P. attn_temporal_bwd is one warp per (batch element, site, head),
// each lane owning two of the head's dims, everything in registers.
// Later work: tensor-core products (mma.sync / wgmma).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxT = 8;

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_frame_bwd_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ freqs,
                          bf16* __restrict__ dqkv, bf16* __restrict__ ao,
                          int S, int D, int rot) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = HD + 2;  // padded K/V rows: lanes reading a key each
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KS;
  bf16* Qs = Vs + (size_t)S * KS;
  bf16* Os = Qs + (size_t)S * HD;  // dO
  bf16* Ps = Os + (size_t)S * HD;  // bf16(P), [query][key]
  bf16* Gs = Ps + (size_t)S * S;   // dS, [query][key]
  float* pbuf = reinterpret_cast<float*>(Gs + (size_t)S * S);
  float* dpbuf = pbuf + (size_t)kWarps * S;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x;
  const size_t row0 = (size_t)blockIdx.y * S;
  const size_t D3 = 3 * (size_t)D;
  const float scale = 1.0f / sqrtf((float)HD);

  for (int idx = threadIdx.x; idx < S * (HD / 2); idx += kWarps * 32) {
    const int j = idx / (HD / 2), c = (idx % (HD / 2)) * 2;
    const size_t g = (row0 + j) * D + (size_t)h * HD + c;
    typedef __nv_bfloat162 b2;
    *reinterpret_cast<b2*>(Ks + (size_t)j * KS + c) =
        *reinterpret_cast<const b2*>(k + g);
    *reinterpret_cast<b2*>(Vs + (size_t)j * KS + c) =
        *reinterpret_cast<const b2*>(v + g);
    *reinterpret_cast<b2*>(Qs + (size_t)j * HD + c) =
        *reinterpret_cast<const b2*>(q + g);
    *reinterpret_cast<b2*>(Os + (size_t)j * HD + c) =
        *reinterpret_cast<const b2*>(dout + g);
  }
  __syncthreads();

  auto dot_row = [&](const float (&r)[HD], const bf16* base) {
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(base);
    float acc = 0.f;
#pragma unroll
    for (int c2 = 0; c2 < HD / 2; ++c2) {
      const float2 kv = __bfloat1622float2(kr[c2]);
      acc = fmaf(r[2 * c2], kv.x, acc);
      acc = fmaf(r[2 * c2 + 1], kv.y, acc);
    }
    return acc;
  };

  // phase A: one warp per query row i
  float* pb = pbuf + (size_t)warp * S;
  float* db = dpbuf + (size_t)warp * S;
  for (int i = warp; i < S; i += kWarps) {
    float rv[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) rv[c] = bf2f(Qs[(size_t)i * HD + c]);
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float s = dot_row(rv, Ks + (size_t)j * KS) * scale;
      pb[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pb[j] - mx);
      pb[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < HD; ++c) rv[c] = bf2f(Os[(size_t)i * HD + c]);
    float dsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float p = pb[j] / sum;
      const float dp = dot_row(rv, Vs + (size_t)j * KS);
      pb[j] = p;
      db[j] = dp;
      dsum += dp * p;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < S; j += 32) {
      const float p = pb[j];
      Ps[(size_t)i * S + j] = f2bf(p);
      Gs[(size_t)i * S + j] = f2bf((p * (db[j] - dsum)) * scale);
    }
    __syncwarp();
    for (int c = lane * 2; c < HD; c += 64) {
      float2 o = make_float2(0.f, 0.f), dq = make_float2(0.f, 0.f);
      for (int j = 0; j < S; ++j) {
        const float p = bf2f(Ps[(size_t)i * S + j]);
        const float g = bf2f(Gs[(size_t)i * S + j]);
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Vs + (size_t)j * KS + c));
        const float2 kv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Ks + (size_t)j * KS + c));
        o.x = fmaf(p, vv.x, o.x);
        o.y = fmaf(p, vv.y, o.y);
        dq.x = fmaf(g, kv.x, dq.x);
        dq.y = fmaf(g, kv.y, dq.y);
      }
      store_pair(ao, (row0 + i) * D + (size_t)h * HD + c, o.x, o.y);
      if (c < rot) dq = rope_pair_t(dq, freqs + (size_t)i * rot + c);
      store_pair(dqkv, (row0 + i) * D3 + (size_t)h * HD + c, dq.x, dq.y);
    }
    __syncwarp();
  }
  __syncthreads();

  // phase B: one warp per key row j
  for (int j = warp; j < S; j += kWarps) {
    for (int c = lane * 2; c < HD; c += 64) {
      float2 dk = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
      for (int i = 0; i < S; ++i) {
        const float g = bf2f(Gs[(size_t)i * S + j]);
        const float p = bf2f(Ps[(size_t)i * S + j]);
        const float2 qv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Qs + (size_t)i * HD + c));
        const float2 ov = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Os + (size_t)i * HD + c));
        dk.x = fmaf(g, qv.x, dk.x);
        dk.y = fmaf(g, qv.y, dk.y);
        dv.x = fmaf(p, ov.x, dv.x);
        dv.y = fmaf(p, ov.y, dv.y);
      }
      if (c < rot) dk = rope_pair_t(dk, freqs + (size_t)j * rot + c);
      const size_t o = (row0 + j) * D3 + (size_t)h * HD + c;
      store_pair(dqkv, o + D, dk.x, dk.y);
      store_pair(dqkv, o + 2 * (size_t)D, dv.x, dv.y);
    }
  }
}

template <int HD>
size_t frame_smem_bytes(int S) {
  return (size_t)S * (HD + 2) * 2 * 2 + (size_t)S * HD * 2 * 2 +
         (size_t)S * S * 2 * 2 + (size_t)kWarps * S * 4 * 2;
}

template <int HD>
int launch_frame(const bf16* q, const bf16* k, const bf16* v,
                 const bf16* dout, const float* freqs, bf16* dqkv, bf16* ao,
                 int n_frames, int S, int D, int rot, cudaStream_t st) {
  const size_t smem = frame_smem_bytes<HD>(S);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_frame_bwd_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(D / HD, n_frames);
  attn_frame_bwd_kernel<HD><<<grid, kWarps * 32, smem, st>>>(
      q, k, v, dout, freqs, dqkv, ao, S, D, rot);
  return (int)cudaGetLastError();
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_temporal_bwd_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ freqs,
                             bf16* __restrict__ dqkv, bf16* __restrict__ ao,
                             int B, int T, int S, int D, int H,
                             int valid_mask) {
  constexpr int P = HD >= 64 ? HD / 64 : 1;  // dim pairs per lane
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= B * S * H) return;
  const int lane = threadIdx.x & 31;
  const int h = unit % H, s = (unit / H) % S, b = unit / (H * S);
  const float scale = 1.0f / sqrtf((float)HD);
  const size_t D3 = 3 * (size_t)D;

  float2 qf[kMaxT][P], kf[kMaxT][P], vf[kMaxT][P], gf[kMaxT][P];
  float2 dq[kMaxT][P], dk[kMaxT][P], dv[kMaxT][P];
  auto off = [&](int t, int p) {
    return (((size_t)b * T + t) * S + s) * D + (size_t)h * HD + 2 * lane +
           64 * p;
  };
  auto ld = [](const bf16* base, size_t o) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(base + o));
  };
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t >= T) break;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      dq[t][p] = dk[t][p] = dv[t][p] = make_float2(0.f, 0.f);
      qf[t][p] = kf[t][p] = vf[t][p] = gf[t][p] = make_float2(0.f, 0.f);
      if (2 * lane + 64 * p >= HD) continue;
      const size_t o = off(t, p);
      qf[t][p] = ld(q, o);
      kf[t][p] = ld(k, o);
      vf[t][p] = ld(v, o);
      gf[t][p] = ld(dout, o);
    }
  }
  auto dot = [&](const float2 (&a)[P], const float2 (&c)[P]) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (2 * lane + 64 * p < HD) {
        acc = fmaf(a[p].x, c[p].x, acc);
        acc = fmaf(a[p].y, c[p].y, acc);
      }
    return warp_sum(acc);
  };

#pragma unroll
  for (int i = 0; i < kMaxT; ++i) {
    if (i >= T) break;
    float pr[kMaxT], dp[kMaxT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j > i) break;
      const bool open = ((valid_mask >> j) & 1) || j == i;
      pr[j] = dot(qf[i], kf[j]) * scale + (open ? 0.0f : -1e30f);
      mx = fmaxf(mx, pr[j]);
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j > i) break;
      pr[j] = expf(pr[j] - mx);
      den += pr[j];
    }
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j > i) break;
      pr[j] = pr[j] / den;
      dp[j] = dot(gf[i], vf[j]);
      dsum += dp[j] * pr[j];
    }
    float2 o[P];
#pragma unroll
    for (int p = 0; p < P; ++p) o[p] = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j > i) break;
      const float pb = bf16_round(pr[j]);
      const float ds = bf16_round((pr[j] * (dp[j] - dsum)) * scale);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        o[p].x = fmaf(pb, vf[j][p].x, o[p].x);
        o[p].y = fmaf(pb, vf[j][p].y, o[p].y);
        dq[i][p].x = fmaf(ds, kf[j][p].x, dq[i][p].x);
        dq[i][p].y = fmaf(ds, kf[j][p].y, dq[i][p].y);
        dk[j][p].x = fmaf(ds, qf[i][p].x, dk[j][p].x);
        dk[j][p].y = fmaf(ds, qf[i][p].y, dk[j][p].y);
        dv[j][p].x = fmaf(pb, gf[i][p].x, dv[j][p].x);
        dv[j][p].y = fmaf(pb, gf[i][p].y, dv[j][p].y);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (2 * lane + 64 * p < HD) store_pair(ao, off(i, p), o[p].x, o[p].y);
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    if (t >= T) break;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = 2 * lane + 64 * p;
      if (c >= HD) continue;
      const float* fr = freqs + (size_t)t * HD + c;
      const float2 gq = rope_pair_t(dq[t][p], fr);
      const float2 gk = rope_pair_t(dk[t][p], fr);
      const size_t o = (((size_t)b * T + t) * S + s) * D3 + (size_t)h * HD + c;
      store_pair(dqkv, o, gq.x, gq.y);
      store_pair(dqkv, o + D, gk.x, gk.y);
      store_pair(dqkv, o + 2 * (size_t)D, dv[t][p].x, dv[t][p].y);
    }
  }
}

template <int HD>
int launch_temporal(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* freqs, bf16* dqkv,
                    bf16* ao, int B, int T, int S, int D, int H,
                    int valid_mask, cudaStream_t st) {
  const int units = B * S * H;
  attn_temporal_bwd_kernel<HD><<<(units + kWarps - 1) / kWarps, kWarps * 32,
                                 0, st>>>(q, k, v, dout, freqs, dqkv, ao, B,
                                          T, S, D, H, valid_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, ao: (n_frames * S, D) bf16, head h in columns
// [h * hd, (h + 1) * hd); freqs: (S, rot) fp32, the forward's rotary table
// (rot = 0: no rope); dqkv: (n_frames * S, 3D) bf16.
GTAX_ENTRY gtax_attn_frame_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* freqs,
                               void* dqkv, void* ao, int n_frames, int S,
                               int D, int num_heads, int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || rot > D / num_heads)
    return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *gb = static_cast<const bf16*>(dout);
  const float* f = static_cast<const float*>(freqs);
  bf16* dst = static_cast<bf16*>(dqkv);
  bf16* o = static_cast<bf16*>(ao);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_frame<32>(qb, kb, vb, gb, f, dst, o, n_frames, S, D, rot,
                              st);
    case 64:
      return launch_frame<64>(qb, kb, vb, gb, f, dst, o, n_frames, S, D, rot,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, dout, ao: (B * T * S, D) bf16, frame-major within each batch
// element; freqs: (T, hd) fp32 temporal rotary table; dqkv: (B * T * S, 3D)
// bf16; valid_mask: bit j = window slot j holds a real frame.
GTAX_ENTRY gtax_attn_temporal_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* freqs,
                                  void* dqkv, void* ao, int B, int T, int S,
                                  int D, int num_heads, int valid_mask,
                                  void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || S <= 0 || num_heads <= 0 ||
      D % num_heads)
    return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *gb = static_cast<const bf16*>(dout);
  const float* f = static_cast<const float*>(freqs);
  bf16* dst = static_cast<bf16*>(dqkv);
  bf16* o = static_cast<bf16*>(ao);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_temporal<32>(qb, kb, vb, gb, f, dst, o, B, T, S, D,
                                 num_heads, valid_mask, st);
    case 64:
      return launch_temporal<64>(qb, kb, vb, gb, f, dst, o, B, T, S, D,
                                 num_heads, valid_mask, st);
    case 128:
      return launch_temporal<128>(qb, kb, vb, gb, f, dst, o, B, T, S, D,
                                  num_heads, valid_mask, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
