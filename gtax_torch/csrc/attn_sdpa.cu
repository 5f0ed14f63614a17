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
// Bound: bytes at the model's shapes (q, k, v and the output; S <= 576 and
// d = 64 keep the S^2 d products under the bf16 ridge).
// Two bodies behind one entry point; the caller picks by S alone
// (gtax_torch/kernels/attention.py sdpa_tensor_cores):
//  - tensor cores (attn_rows of attn_frame.cuh, kExact): each warp takes 16
//    query rows, eight a block; QK^T and PV run as mma.sync m16n8k16 with
//    ldmatrix operands; the head's K stays resident in shared memory and V
//    streams in 64-key tiles, over two passes (max and sum, then p = bf16(e
//    / l) and PV). The bias is read from global memory into each score
//    fragment after the scale: each element is used by one thread once a
//    pass, so staging it would copy it without reuse, and the (S, S) table
//    (1.3 MB at S = 576) stays in L2 for the grid's N x h blocks;
//  - warp rows, for short rows (S = 5 in the temporal attention, where a
//    16-row tile would waste 11/16 of its work): K and V whole in shared
//    memory (K rows padded by two elements so a warp's lanes, one key each,
//    hit distinct banks) and one warp per query row on the fp32 pipes.
// The fp32 form (gtax_attn_sdpa_f32, below) has a body of each kind too,
// both on the CUDA cores.
#include "attn_f32.cuh"
#include "attn_frame.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQTile = 64;

// ---- warp rows

// A row's pair of elements (c, c + 1) as fp32, and its copy into shared
// memory: bf16, or fp32 for the fp32 form (both 4- or 8-byte aligned).
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void copy2(bf16* d, const bf16* s) {
  *reinterpret_cast<__nv_bfloat162*>(d) =
      *reinterpret_cast<const __nv_bfloat162*>(s);
}
__device__ __forceinline__ void copy2(float* d, const float* s) {
  *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(s);
}
// the probabilities in the input type: bf16-rounded, or as they are
__device__ __forceinline__ float prob_round(float p, const bf16*) {
  return bf16_round(p);
}
__device__ __forceinline__ float prob_round(float p, const float*) {
  return p;
}

template <int HD, typename T>
size_t rows_smem(int S) {
  return (size_t)S * (HD + 2) * sizeof(T) + (size_t)S * HD * sizeof(T) +
         kWarps * HD * 4 + (size_t)kWarps * S * 4;
}

// The warp-row body over q, k, v, out of type T (bf16; fp32 for the fp32
// form, which rounds nothing: its probabilities stay fp32).
template <int HD, typename T>
__device__ __forceinline__ void sdpa_rows(const T* __restrict__ q,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const float* __restrict__ bias,
                                          T* __restrict__ out, int S,
                                          int q_ld, int k_ld, int v_ld,
                                          int o_ld, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = HD + 2;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)S * KS;
  float* qbuf = reinterpret_cast<float*>(Vs + (size_t)S * HD);
  float* pbuf = qbuf + kWarps * HD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQTile;
  const size_t hc = (size_t)blockIdx.y * HD;  // the head's first column
  const size_t n = blockIdx.z;
  const T* qn = q + n * S * q_ld + hc;
  const T* kn = k + n * S * k_ld + hc;
  const T* vn = v + n * S * v_ld + hc;
  T* on = out + n * S * o_ld + hc;

  for (int idx = threadIdx.x; idx < S * (HD / 2); idx += kWarps * 32) {
    const int j = idx / (HD / 2), c = (idx % (HD / 2)) * 2;
    copy2(Ks + (size_t)j * KS + c, kn + (size_t)j * k_ld + c);
    copy2(Vs + (size_t)j * HD + c, vn + (size_t)j * v_ld + c);
  }
  __syncthreads();

  float* qb = qbuf + warp * HD;
  float* pb = pbuf + (size_t)warp * S;
  const int q_end = min(q0 + kQTile, S);
  for (int r = q0 + warp; r < q_end; r += kWarps) {
    for (int c = lane * 2; c < HD; c += 64) {
      const float2 qv = load2(qn + (size_t)r * q_ld + c);
      qb[c] = qv.x;
      qb[c + 1] = qv.y;
    }
    __syncwarp();
    float qr[HD];
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = qb[c];

    const float* brow = bias == nullptr ? nullptr : bias + (size_t)r * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const T* kr = Ks + (size_t)j * KS;
      float acc = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < HD / 2; ++c2) {
        const float2 kv = load2(kr + 2 * c2);
        acc = fmaf(qr[2 * c2], kv.x, acc);
        acc = fmaf(qr[2 * c2 + 1], kv.y, acc);
      }
      const float sc = __fmul_rn(acc, scale);
      const float s = brow == nullptr ? sc : __fadd_rn(sc, brow[j]);
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
    for (int j = lane; j < S; j += 32)
      pb[j] = prob_round(__fdiv_rn(pb[j], sum), q);
    __syncwarp();

    for (int c = lane * 2; c < HD; c += 64) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < S; ++j) {
        const float p = pb[j];
        const float2 vv = load2(Vs + (size_t)j * HD + c);
        a0 = fmaf(p, vv.x, a0);
        a1 = fmaf(p, vv.y, a1);
      }
      store_pair(on, (size_t)r * o_ld + c, a0, a1);
    }
    __syncwarp();
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_sdpa_rows_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, int S, int q_ld, int k_ld,
                          int v_ld, int o_ld, float scale) {
  sdpa_rows<HD, bf16>(q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
}

// ---- tensor cores

// Rows p0 .. p0 + n - 1 of one head (columns hc ..) of q, k or v, token
// stride ld, into dst (row stride HD + 8), rows past S zero-filled: 16
// bytes a cp.async.
template <int HD>
__device__ __forceinline__ void stage_plain(bf16* dst, const bf16* src,
                                            int ld, int p0, int n, int S) {
  constexpr int CH = HD / 8, LD = HD + 8;
  for (int idx = threadIdx.x; idx < n * CH; idx += kAttnWarps * 32) {
    const int r = idx / CH, c = (idx % CH) * 8, p = p0 + r;
    cp_async16(dst + (size_t)r * LD + c,
               src + (size_t)(p < S ? p : S - 1) * ld + c, p < S ? 16 : 0);
  }
  cp_async_commit();
}

template <int HD>
__global__ void __launch_bounds__(kAttnWarps * 32, 2)
    attn_sdpa_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ bias,
                         bf16* __restrict__ out, int S, int q_ld, int k_ld,
                         int v_ld, int o_ld, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = HD + 8, KC = HD / 16, DT = HD / 8;
  const int keys = (S + kAttnKTile - 1) / kAttnKTile * kAttnKTile;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Qs = Ks + (size_t)keys * LD;  // the Q tile, then each V tile

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kAttnQTile;
  const size_t hc = (size_t)blockIdx.y * HD;  // the head's first column
  const size_t n = blockIdx.z;
  const bf16* qn = q + n * S * q_ld + hc;
  const bf16* kn = k + n * S * k_ld + hc;
  const bf16* vn = v + n * S * v_ld + hc;

  stage_plain<HD>(Qs, qn, q_ld, q0, kAttnQTile, S);
  stage_plain<HD>(Ks, kn, k_ld, 0, keys, S);
  cp_async_wait<0>();
  __syncthreads();

  const int rw = q0 + warp * 16;  // the warp's first row
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(qf[kc], Qs + (size_t)(warp * 16 + (lane & 15)) * LD + kc * 16 +
                        (lane >> 4) * 8);

  // this thread's rows of the score tiles (rows past S read bias row S - 1
  // and are not stored; keys past S read key S - 1 and score -inf): every
  // load in bounds, none behind a branch, so a tile's 32 issue together
  const int ra = rw + (lane >> 2), rb = ra + 8;
  const float* ba = bias + (size_t)min(ra, S - 1) * S;
  const float* bb = bias + (size_t)min(rb, S - 1) * S;
  auto finish = [&](float (&s)[8][4], int j0) {
    if (bias == nullptr) {  // a zero bias: the sum would add +0
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j0 + nt * 8 + (lane & 3) * 2 + (i & 1);
          s[nt][i] = key < S ? __fmul_rn(s[nt][i], scale) : -INFINITY;
        }
      return;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j0 + nt * 8 + (lane & 3) * 2 + (i & 1);
        const float b = __ldg((i < 2 ? ba : bb) + min(key, S - 1));
        s[nt][i] = key < S ? __fadd_rn(__fmul_rn(s[nt][i], scale), b)
                           : -INFINITY;
      }
  };
  auto stage_v = [&](bf16* Vt, int j0) {
    stage_plain<HD>(Vt, vn, v_ld, j0, kAttnKTile, S);
  };
  float o[DT][4];
  attn_rows<HD, true>(qf, Ks, Qs, S, rw < S, finish, stage_v, o, lane);

  bf16* on = out + n * S * o_ld + hc;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + (lane & 3) * 2;
    if (ra < S) store_pair(on, (size_t)ra * o_ld + c, o[dt][0], o[dt][1]);
    if (rb < S) store_pair(on, (size_t)rb * o_ld + c, o[dt][2], o[dt][3]);
  }
}

template <int HD>
int launch_mma(const bf16* q, const bf16* k, const bf16* v,
               const float* bias, bf16* out, int N, int S, int H, int q_ld,
               int k_ld, int v_ld, int o_ld, float scale, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const size_t smem = attn_frame_smem<HD>(S);  // K, then a Q/V region
  const cudaError_t e = opt_in_smem(attn_sdpa_mma_kernel<HD>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kAttnQTile - 1) / kAttnQTile, H, N);
  attn_sdpa_mma_kernel<HD><<<grid, kAttnWarps * 32, smem, st>>>(
      q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* bias,
           bf16* out, int N, int S, int H, int q_ld, int k_ld, int v_ld,
           int o_ld, int tensor_cores, float scale, cudaStream_t st) {
  if (tensor_cores)
    return launch_mma<HD>(q, k, v, bias, out, N, S, H, q_ld, k_ld, v_ld,
                          o_ld, scale, st);
  static size_t opted = 48 * 1024;
  const size_t smem = rows_smem<HD, bf16>(S);
  const cudaError_t e = opt_in_smem(attn_sdpa_rows_kernel<HD>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kQTile - 1) / kQTile, H, N);
  attn_sdpa_rows_kernel<HD><<<grid, kWarps * 32, smem, st>>>(
      q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
  return (int)cudaGetLastError();
}

// ---- fp32
//
// The fp32 form (gtax's _attn_kernel / _mha_kernel at q.dtype = float32:
// probs.astype(q.dtype) is a no-op, so nothing is rounded): the warp-row
// body over fp32 rows for short rows, and for longer ones the tiled fp32
// SIMT body of the fp32 frame attention (attn_f32.cuh attn_f32_unit), 64
// query rows a block and the keys in 64-key tiles (one head's fp32 K and V
// at S = 576 take 295 KB, more than a block's 227 KB), scores
// fp32(q . k * scale + bias), exact expf, PV summed in fp32, an fp32
// output. No tensor-core instruction: TF32 would keep three digits.

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    attn_sdpa_rows_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int S, int q_ld,
                              int k_ld, int v_ld, int o_ld, float scale) {
  sdpa_rows<HD, float>(q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld,
                       scale);
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    attn_sdpa_tiled_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int S, int q_ld,
                               int k_ld, int v_ld, int o_ld, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const size_t hc = (size_t)blockIdx.y * HD, n = blockIdx.z;
  const float* qn = q + n * S * q_ld + hc;
  const float* kn = k + n * S * k_ld + hc;
  const float* vn = v + n * S * v_ld + hc;
  float* on = out + n * S * o_ld + hc;
  auto score = [=](float s, int r, int key) {
    const float sc = __fmul_rn(s, scale);
    return bias == nullptr
               ? sc
               : __fadd_rn(sc, bias[(size_t)min(r, S - 1) * S + key]);
  };
  attn_f32_unit<HD>(
      fsm, S, blockIdx.x * kF32Rows,
      [=](int p, int d) {
        return *reinterpret_cast<const float2*>(qn + (size_t)p * q_ld + d);
      },
      [=](int p, int d) {
        return *reinterpret_cast<const float2*>(kn + (size_t)p * k_ld + d);
      },
      [=](int p, int d) {
        return *reinterpret_cast<const float4*>(vn + (size_t)p * v_ld + d);
      },
      score, [=](int r, int c, float o) { on[(size_t)r * o_ld + c] = o; });
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v,
               const float* bias, float* out, int N, int S, int H, int q_ld,
               int k_ld, int v_ld, int o_ld, int tiled, float scale,
               cudaStream_t st) {
  if (tiled) {
    static size_t opted = 48 * 1024;
    constexpr size_t smem = attn_f32_smem<HD>();
    const cudaError_t e =
        opt_in_smem(attn_sdpa_tiled_f32_kernel<HD>, smem, opted);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((S + kF32Rows - 1) / kF32Rows, H, N);
    attn_sdpa_tiled_f32_kernel<HD><<<grid, kF32Threads, smem, st>>>(
        q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
    return (int)cudaGetLastError();
  }
  static size_t opted = 48 * 1024;
  const size_t smem = rows_smem<HD, float>(S);
  const cudaError_t e =
      opt_in_smem(attn_sdpa_rows_f32_kernel<HD>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kQTile - 1) / kQTile, H, N);
  attn_sdpa_rows_f32_kernel<HD><<<grid, kWarps * 32, smem, st>>>(
      q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16, N rows of S tokens whose token stride is q_ld / k_ld /
// v_ld elements (row stride S * ld), head h in columns [h * hd, (h + 1) *
// hd); bias: (S, S) fp32 additive, or null where it would be all zeros (no
// mask, not causal: adding +0 changes no score's softmax, so the loads and
// adds are skipped); out: (N, S, o_ld) bf16, o_ld >= H * hd;
// tensor_cores: 1 for the mma.sync body, 0 for warp rows; scale: the
// score scale d^-1/2 as the caller rounds it to fp32. The tensor-core body
// reads q, k, v 16 bytes at a time: their lds are multiples of 8 and their
// pointers 16-byte aligned.
GTAX_ENTRY gtax_attn_sdpa(const void* q, const void* k, const void* v,
                          const void* bias, void* out, int N, int S,
                          int num_heads, int hd, int q_ld, int k_ld, int v_ld,
                          int o_ld, int tensor_cores, float scale,
                          void* stream) {
  const int align = tensor_cores ? 8 : 2;
  if (N <= 0 || S <= 0 || num_heads <= 0 ||
      q_ld < num_heads * hd || k_ld < num_heads * hd ||
      v_ld < num_heads * hd || o_ld < num_heads * hd || q_ld % align ||
      k_ld % align || v_ld % align || o_ld % 2 ||
      (tensor_cores && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)))
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
                        o_ld, tensor_cores, scale, st);
    case 64:
      return launch<64>(qp, kp, vp, b, o, N, S, num_heads, q_ld, k_ld, v_ld,
                        o_ld, tensor_cores, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 form: gtax_attn_sdpa's arguments over fp32 q, k, v and out;
// tiled: 1 for the tiled SIMT body (the caller's rule for the tensor-core
// body's lengths), 0 for warp rows. The tiled body reads q and k 8 bytes
// and v 16 bytes at a time (lds multiples of 4, pointers 16-byte
// aligned); warp rows read 8 bytes (lds even, pointers 8-byte aligned).
GTAX_ENTRY gtax_attn_sdpa_f32(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int N, int S,
                              int num_heads, int hd, int q_ld, int k_ld,
                              int v_ld, int o_ld, int tiled, float scale,
                              void* stream) {
  const int align = tiled ? 4 : 2;
  if (N <= 0 || S <= 0 || num_heads <= 0 || q_ld < num_heads * hd ||
      k_ld < num_heads * hd || v_ld < num_heads * hd ||
      o_ld < num_heads * hd || q_ld % align || k_ld % align || v_ld % align ||
      o_ld % 2 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) %
       (4 * align)))
    return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_f32<32>(qp, kp, vp, b, o, N, S, num_heads, q_ld, k_ld,
                            v_ld, o_ld, tiled, scale, st);
    case 64:
      return launch_f32<64>(qp, kp, vp, b, o, N, S, num_heads, q_ld, k_ld,
                            v_ld, o_ld, tiled, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
