// Multi-head attention with an additive (S, S) bias, per (query tile,
// head, row): the kernel of the `pallas` attention backend.
//
// Replaces gtax/kernels/attention.py fused_sdpa (_fused_sdpa_flat, pallas_call
// at :90, body _attn_kernel :60: heads-first (N, S, d)) and
// fused_mha_token_major (_mha_token_major_flat, pallas_call at :198, body
// _mha_kernel :154: token-major (N, S, h*d), heads as d-wide column slices).
// One kernel covers both layouts: element (n, s, head, c) of q, k or v sits
// at n * S * ld + s * ld + head * d + c, with ld = d and one head for the
// heads-first layout, ld >= h * d for the token-major one (a q/k/v view of
// a fused qkv row has ld = 3 * h * d). The output is dense, ld_out = h * d.
// Rounding points are gtax's: fp32 scores, times d^-1/2, plus the bias
// (-1e30 where masked, never -inf, so a fully masked row averages V
// uniformly as gtax's does); max-subtracted exp; e / sum(e) in fp32; the
// probabilities cast to bf16 before PV; PV summed in fp32; a bf16 output.
// Bound: operations at S = 576 (S^2 * d per head), bytes at S <= 144. As
// attn_frame: each block stages its head's K and V in shared memory (K rows
// padded by two elements so a warp's lanes, one key each, hit distinct
// banks; 170 KB at S = 576) and eight warps stream up to 64 query rows
// against them on the fp32 pipes. Later work: tensor-core QK^T and PV.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQTile = 64;

template <int HD>
size_t smem_bytes(int S) {
  return (size_t)S * (HD + 2) * 2 + (size_t)S * HD * 2 + kWarps * HD * 4 +
         (size_t)kWarps * S * 4;
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_sdpa_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int S, int q_ld, int k_ld, int v_ld, int o_ld,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = HD + 2;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KS;
  float* qbuf = reinterpret_cast<float*>(Vs + (size_t)S * HD);
  float* pbuf = qbuf + kWarps * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQTile;
  const size_t hc = (size_t)blockIdx.y * HD;  // the head's first column
  const size_t n = blockIdx.z;
  const bf16* qn = q + n * S * q_ld + hc;
  const bf16* kn = k + n * S * k_ld + hc;
  const bf16* vn = v + n * S * v_ld + hc;
  bf16* on = out + n * S * o_ld + hc;

  for (int idx = threadIdx.x; idx < S * (HD / 2); idx += kWarps * 32) {
    const int j = idx / (HD / 2), c = (idx % (HD / 2)) * 2;
    *reinterpret_cast<__nv_bfloat162*>(Ks + (size_t)j * KS + c) =
        *reinterpret_cast<const __nv_bfloat162*>(kn + (size_t)j * k_ld + c);
    *reinterpret_cast<__nv_bfloat162*>(Vs + (size_t)j * HD + c) =
        *reinterpret_cast<const __nv_bfloat162*>(vn + (size_t)j * v_ld + c);
  }
  __syncthreads();

  float* qb = qbuf + warp * HD;
  float* pb = pbuf + (size_t)warp * S;
  const int q_end = min(q0 + kQTile, S);
  for (int r = q0 + warp; r < q_end; r += kWarps) {
    for (int c = lane * 2; c < HD; c += 64) {
      const float2 qv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qn + (size_t)r * q_ld + c));
      qb[c] = qv.x;
      qb[c + 1] = qv.y;
    }
    __syncwarp();
    float qr[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = qb[c];

    const float* brow = bias + (size_t)r * S;
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
      const float s = __fadd_rn(__fmul_rn(acc, scale), brow[j]);
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
    for (int j = lane; j < S; j += 32) pb[j] = bf16_round(__fdiv_rn(pb[j], sum));
    __syncwarp();

    for (int c = lane * 2; c < HD; c += 64) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float p = pb[j];
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Vs + (size_t)j * HD + c));
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      store_pair(on, (size_t)r * o_ld + c, a0, a1);
    }
    __syncwarp();
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* bias,
           bf16* out, int N, int S, int H, int q_ld, int k_ld, int v_ld,
           int o_ld, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>(S);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_sdpa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kQTile - 1) / kQTile, H, N);
  attn_sdpa_kernel<HD><<<grid, kWarps * 32, smem, st>>>(
      q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16, N rows of S tokens whose token stride is q_ld / k_ld /
// v_ld elements (row stride S * ld), head h in columns [h * hd, (h + 1) *
// hd); bias: (S, S) fp32 additive; out: (N, S, o_ld) bf16, o_ld >= H * hd;
// scale: the score scale d^-1/2 as the caller rounds it to fp32.
GTAX_ENTRY gtax_attn_sdpa(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int N, int S,
                          int num_heads, int hd, int q_ld, int k_ld, int v_ld,
                          int o_ld, float scale, void* stream) {
  if (N <= 0 || S <= 0 || num_heads <= 0 || bias == nullptr ||
      q_ld < num_heads * hd || k_ld < num_heads * hd ||
      v_ld < num_heads * hd || o_ld < num_heads * hd || q_ld % 2 ||
      k_ld % 2 || v_ld % 2 || o_ld % 2)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(qp, kp, vp, b, o, N, S, num_heads, q_ld, k_ld, v_ld,
                        o_ld, scale, st);
    case 64:
      return launch<64>(qp, kp, vp, b, o, N, S, num_heads, q_ld, k_ld, v_ld,
                        o_ld, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
