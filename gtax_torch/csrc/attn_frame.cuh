// The body of the attn_frame kernel as a device function over one
// (query tile, head, frame) unit, shared by attn_frame.cu (one block per
// unit) and the paired int8 kernels of pair_q.cu (units strided over a
// cooperative grid). Both run it with kAttnWarps warps; a query row's
// arithmetic does not depend on which warp or block takes it, so the
// results are bit-equal. See attn_frame.cu for the rounding points.
#pragma once

#include "common.cuh"

constexpr int kAttnWarps = 8;
constexpr int kAttnQTile = 64;

// Dynamic shared memory of one unit: K (padded rows) and V of the head,
// a q row and a probability row per warp.
template <int HD>
__host__ __device__ inline size_t attn_frame_smem(int S) {
  return (size_t)S * (HD + 2) * 2 + (size_t)S * HD * 2 +
         kAttnWarps * HD * 4 + (size_t)kAttnWarps * S * 4;
}

// Query tile qt (rows qt * 64 ..), head h, frame n.
template <int HD>
__device__ __forceinline__ void attn_frame_unit(
    unsigned char* smem, const void* __restrict__ qkv, int qkv_f32,
    const float* __restrict__ freqs, void* __restrict__ out, int out_f32,
    bf16* __restrict__ q_out, bf16* __restrict__ k_out,
    bf16* __restrict__ v_out, int S, int D, int rot, int qt, int h, int n) {
  constexpr int KS = HD + 2;  // padded K row (bf16 elements)
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KS;
  float* qbuf = reinterpret_cast<float*>(Vs + (size_t)S * HD);
  float* pbuf = qbuf + kAttnWarps * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = qt * kAttnQTile;
  const size_t row0 = (size_t)n * S;
  const size_t D3 = 3 * (size_t)D;
  const float scale = 1.0f / sqrtf((float)HD);

  for (int idx = threadIdx.x; idx < S * (HD / 2); idx += kAttnWarps * 32) {
    const int j = idx / (HD / 2), c = (idx % (HD / 2)) * 2;
    const size_t base = (row0 + j) * D3 + (size_t)h * HD + c;
    float2 k = load_pair(qkv, qkv_f32, base + D);
    const float2 v = load_pair(qkv, qkv_f32, base + 2 * (size_t)D);
    if (c < rot) k = rope_pair(k, freqs + (size_t)j * rot + c);
    store_pair(Ks, (size_t)j * KS + c, k.x, k.y);
    store_pair(Vs, (size_t)j * HD + c, v.x, v.y);
    if (k_out != nullptr && qt == 0) {  // one query tile stores K, V
      const size_t o = (row0 + j) * D + (size_t)h * HD + c;
      store_pair(k_out, o, k.x, k.y);
      store_pair(v_out, o, v.x, v.y);
    }
  }
  __syncthreads();

  float* qb = qbuf + warp * HD;
  float* pb = pbuf + (size_t)warp * S;
  const int q_end = min(q0 + kAttnQTile, S);
  for (int r = q0 + warp; r < q_end; r += kAttnWarps) {
    const size_t base = (row0 + r) * D3 + (size_t)h * HD;
    for (int c = lane * 2; c < HD; c += 64) {
      float2 q = load_pair(qkv, qkv_f32, base + c);
      if (c < rot) q = rope_pair(q, freqs + (size_t)r * rot + c);
      qb[c] = bf16_round(q.x);
      qb[c + 1] = bf16_round(q.y);
      if (q_out != nullptr)
        store_pair(q_out, (row0 + r) * D + (size_t)h * HD + c, q.x, q.y);
    }
    __syncwarp();
    float qr[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = qb[c];

    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(Ks + (size_t)j * KS);
      float acc = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < HD / 2; ++c2) {
        const float2 kv = __bfloat1622float2(kr[c2]);
        acc = fmaf(qr[2 * c2], kv.x, acc);
        acc = fmaf(qr[2 * c2 + 1], kv.y, acc);
      }
      const float s = acc * scale;
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
    for (int j = lane; j < S; j += 32) pb[j] = bf16_round(pb[j] / sum);
    __syncwarp();

    for (int c = lane * 2; c < HD; c += 64) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float p = pb[j];
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Vs + (size_t)j * HD + c));
        a0 = fmaf(p, v.x, a0);
        a1 = fmaf(p, v.y, a1);
      }
      const size_t o = (row0 + r) * D + (size_t)h * HD + c;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(a0, a1);
      else
        store_pair(static_cast<bf16*>(out), o, a0, a1);
    }
    __syncwarp();
  }
}
