// Non-causal attention over the S tokens of one frame, per (frame, head,
// query tile), with rotary embedding applied to q and k as they load.
//
// Replaces the attention core of the TPU spatial branch
// (gtax/kernels/block.py _spatial_attention_core: full-d axial pixel rope,
// fp32 qkv in) and of the VAE block (gtax/kernels/vae_block.py
// _vae_block_kernel: bf16 qkv in, rope on the first `rot` dims of a head).
// Rounding points follow the TPU kernels: rope in fp32, q/k/v cast to bf16,
// scores and softmax in fp32, probabilities cast to bf16 before PV, fp32
// PV, then a bf16 output, or the fp32 sums themselves for the int8 spatial
// branch, which quantizes them unrounded (gtax/kernels/quant.py
// _spatial_kernel_q). For training (emit_train, the residuals of
// gtax/kernels/block.py _spatial_attention_core's qkv_out) it also stores
// the roped q and k and the cast v as bf16, exactly the values it attends
// with.
// Bound: operations (S^2 * d per head) at S = 576, bytes at S = 144. This
// first version runs the two products on the fp32 pipes, one warp per query
// row: each block stages the head's roped K and V once in shared memory
// (up to 170 KB at S = 576, hence the dynamic shared-memory opt-in) and
// eight warps stream 64 query rows against it. K rows are padded by two
// elements so the lanes of a warp, one key each, hit distinct banks.
// Later work: tensor-core QK^T and PV (mma.sync / wgmma).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQTile = 64;

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_frame_kernel(const void* __restrict__ qkv, int qkv_f32,
                      const float* __restrict__ freqs, void* __restrict__ out,
                      int out_f32, bf16* __restrict__ q_out,
                      bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                      int S, int D, int rot) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = HD + 2;  // padded K row (bf16 elements)
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KS;
  float* qbuf = reinterpret_cast<float*>(Vs + (size_t)S * HD);
  float* pbuf = qbuf + kWarps * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y;
  const size_t row0 = (size_t)blockIdx.z * S;
  const size_t D3 = 3 * (size_t)D;
  const float scale = 1.0f / sqrtf((float)HD);

  for (int idx = threadIdx.x; idx < S * (HD / 2); idx += kWarps * 32) {
    const int j = idx / (HD / 2), c = (idx % (HD / 2)) * 2;
    const size_t base = (row0 + j) * D3 + (size_t)h * HD + c;
    float2 k = load_pair(qkv, qkv_f32, base + D);
    const float2 v = load_pair(qkv, qkv_f32, base + 2 * (size_t)D);
    if (c < rot) k = rope_pair(k, freqs + (size_t)j * rot + c);
    store_pair(Ks, (size_t)j * KS + c, k.x, k.y);
    store_pair(Vs, (size_t)j * HD + c, v.x, v.y);
    if (k_out != nullptr && blockIdx.x == 0) {  // one query tile stores K, V
      const size_t o = (row0 + j) * D + (size_t)h * HD + c;
      store_pair(k_out, o, k.x, k.y);
      store_pair(v_out, o, v.x, v.y);
    }
  }
  __syncthreads();

  float* qb = qbuf + warp * HD;
  float* pb = pbuf + (size_t)warp * S;
  const int q_end = min(q0 + kQTile, S);
  for (int r = q0 + warp; r < q_end; r += kWarps) {
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

template <int HD>
size_t smem_bytes(int S) {
  return (size_t)S * (HD + 2) * 2 + (size_t)S * HD * 2 + kWarps * HD * 4 +
         (size_t)kWarps * S * 4;
}

template <int HD>
int launch(const void* qkv, int qkv_f32, const float* freqs, void* out,
           int out_f32, bf16* qo, bf16* ko, bf16* vo, int n_frames, int S,
           int D, int rot, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>(S);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_frame_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kQTile - 1) / kQTile, D / HD, n_frames);
  attn_frame_kernel<HD><<<grid, kWarps * 32, smem, st>>>(
      qkv, qkv_f32, freqs, out, out_f32, qo, ko, vo, S, D, rot);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv: (n_frames * S, 3D) fp32 (qkv_f32 = 1) or bf16; freqs: (S, rot) fp32
// rotary table; out: (n_frames * S, D) fp32 (out_f32 = 1) or bf16, head h
// in columns [h * hd, (h + 1) * hd); q_out/k_out/v_out: all three null, or
// (n_frames * S, D) bf16 outputs of the roped q, k and the cast v.
GTAX_ENTRY gtax_attn_frame(const void* qkv, int qkv_f32, const void* freqs,
                           void* out, int out_f32, void* q_out, void* k_out,
                           void* v_out, int n_frames, int S, int D,
                           int num_heads, int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || (q_out == nullptr) != (k_out == nullptr) ||
      (q_out == nullptr) != (v_out == nullptr))
    return (int)cudaErrorInvalidValue;
  bf16* qo = static_cast<bf16*>(q_out);
  bf16* ko = static_cast<bf16*>(k_out);
  bf16* vo = static_cast<bf16*>(v_out);
  const int hd = D / num_heads;
  if (rot > hd) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(freqs);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(qkv, qkv_f32, f, out, out_f32, qo, ko, vo, n_frames, S,
                        D, rot, st);
    case 64:
      return launch<64>(qkv, qkv_f32, f, out, out_f32, qo, ko, vo, n_frames, S,
                        D, rot, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
