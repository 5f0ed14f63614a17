// Non-causal attention over the S tokens of one frame, per (frame, head,
// query tile), with rotary embedding applied to q and k as they load.
//
// Replaces the attention core of the TPU spatial branch
// (gtax/kernels/block.py _spatial_attention_core: full-d axial pixel rope,
// fp32 qkv in) and of the VAE block (gtax/kernels/vae_block.py
// _vae_block_kernel: bf16 qkv in, rope on the first `rot` dims of a head).
// Rounding points follow the TPU kernels: rope in fp32 (its sin and cos
// from a reduction to [-pi, pi] and the SFU, within 1e-6), q/k/v cast to bf16,
// scores and softmax in fp32, probabilities cast to bf16 before PV, fp32
// PV, then a bf16 output, or the fp32 sums themselves for the int8 spatial
// branch, which quantizes them unrounded (gtax/kernels/quant.py
// _spatial_kernel_q). For training (emit_train, the residuals of
// gtax/kernels/block.py _spatial_attention_core's qkv_out) it also stores
// the roped q and k and the cast v as bf16, exactly the values it attends
// with.
// Bound: operations (S^2 * d per head) at S = 576, bytes at S = 144.
// Design (attn_frame.cuh): QK^T and PV on the tensor cores (mma.sync
// m16n8k16, ldmatrix), 16 query rows a warp, 128 a block (fewer where
// that leaves SMs idle: frame_qtile); two passes over
// the keys so the probabilities are normalised before their bf16 cast, as
// gtax's are. A block keeps its head's roped K resident (72 KB at S = 576,
// head dim 64) and streams V in 64-key tiles, so two blocks fit on an SM and
// a head's K and V are staged 5 times at S = 576, not once per 64 queries.
// The fp32 branches (#1 and #5 at x.dtype = float32) take attn_frame_f32
// below: fp32 q/k/v, probabilities and output, nothing rounded, on the CUDA
// cores (no tensor-core type keeps fp32: TF32 keeps ten mantissa bits).
#include "attn_frame.cuh"

namespace {

// one block per (query tile, head, frame); the body is attn_frame_unit
// (attn_frame.cuh). FULL: 128-row tiles, a constant, so that instantiation
// carries no per-warp tile check; else qtile rows.
template <int HD, bool FULL>
__global__ void __launch_bounds__(kAttnWarps * 32, 2)
    attn_frame_kernel(const void* __restrict__ qkv, int qkv_f32,
                      const float* __restrict__ freqs, void* __restrict__ out,
                      int out_f32, bf16* __restrict__ q_out,
                      bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                      int S, int D, int rot, int qtile) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_frame_unit<HD>(smem, qkv, qkv_f32, freqs, out, out_f32, q_out, k_out,
                      v_out, S, D, rot, blockIdx.x, blockIdx.y, blockIdx.z,
                      FULL ? kAttnQTile : qtile);
}

// Query rows a block: 128 where those tiles give every SM a block, else
// the smallest tile of three or more whole warps that covers the frame
// exactly (a denoise step's 144 tokens: 48 rows, 48 blocks a frame at 16
// heads instead of 32, and no tile of 16 live rows out of 128), else 128.
// Three warps is the least measured: every block stages its head's keys.
int frame_qtile(int S, int heads, int n_frames) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if ((long long)((S + kAttnQTile - 1) / kAttnQTile) * heads * n_frames >=
      sms)
    return kAttnQTile;
  for (int w = 3; w < kAttnWarps; ++w)
    if (S % (16 * w) == 0) return 16 * w;
  return kAttnQTile;
}

template <int HD, bool FULL>
int launch_tiles(const void* qkv, int qkv_f32, const float* freqs, void* out,
                 int out_f32, bf16* qo, bf16* ko, bf16* vo, int n_frames,
                 int S, int D, int rot, int qtile, cudaStream_t st) {
  const size_t smem = attn_frame_smem<HD>(S);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // the attributes once per instantiation, the opt-in again only when S
  // needs more shared memory than any launch before it
  static size_t opted = 0;
  if (opted == 0) {
    // all of the SM's unified memory as shared memory, so two blocks of up
    // to 101 KB (S = 576) fit on an SM
    const cudaError_t e = cudaFuncSetAttribute(
        attn_frame_kernel<HD, FULL>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted = 48 * 1024;
  }
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_frame_kernel<HD, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const dim3 grid((S + qtile - 1) / qtile, D / HD, n_frames);
  attn_frame_kernel<HD, FULL><<<grid, kAttnWarps * 32, smem, st>>>(
      qkv, qkv_f32, freqs, out, out_f32, qo, ko, vo, S, D, rot, qtile);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* qkv, int qkv_f32, const float* freqs, void* out,
           int out_f32, bf16* qo, bf16* ko, bf16* vo, int n_frames, int S,
           int D, int rot, cudaStream_t st) {
  const int qtile = frame_qtile(S, D / HD, n_frames);
  return qtile == kAttnQTile
             ? launch_tiles<HD, true>(qkv, qkv_f32, freqs, out, out_f32, qo,
                                      ko, vo, n_frames, S, D, rot, qtile, st)
             : launch_tiles<HD, false>(qkv, qkv_f32, freqs, out, out_f32, qo,
                                       ko, vo, n_frames, S, D, rot, qtile, st);
}

// ------------------------------------------------------------- fp32
//
// The fp32 branches' frame attention (gtax's kernels at x.dtype = float32:
// nothing is cast, probabilities included), on the CUDA cores. A block of
// 256 threads takes kF32Rows query rows of one (frame, head) and walks the
// keys in tiles of kF32Keys, with an online softmax: per tile, the scores
// S = Q K^T (fp32 FFMA), each row's running max and sum of exponentials
// (expf), the partial sums O = O * exp(m_old - m) + E V, and at the end
// O / l. The head's fp32 K and V would not fit a block's shared memory at
// S = 576 (295 KB at head dim 64), so they stream through in tiles.
// Thread (ty, tx) = (tid / 16, tid % 16) holds query rows 4 ty .. 4 ty + 3
// of the tile, their scores against keys 4 tx .. 4 tx + 3 of the key
// tile, and their outputs at dims HD / 16 tx ..: a row's scores, running
// max and sum live in the 16 threads of a half-warp (reduced by four
// shuffles), and its scale factors stay in the threads that hold its
// outputs. Q and K are staged transposed (dim-major), so both products
// read float4 along the thread's rows and columns. Rope in fp32 on load,
// its sin and cos by sincosf (not the special-function unit: fp32 keeps
// what bf16 would round away).
constexpr int kF32Rows = 64, kF32Keys = 64, kF32Threads = 256;
constexpr int kF32LdQ = kF32Rows + 4, kF32LdK = kF32Keys + 4;

template <int HD>
constexpr size_t attn_f32_smem() {
  return (size_t)(HD * kF32LdQ + HD * kF32LdK + kF32Keys * HD +
                  kF32Keys * kF32LdQ) * sizeof(float);
}

// rope_pair with sincosf, one reduction for a pair of equal angles
__device__ __forceinline__ float2 rope_pair_eq(float2 x, const float* f) {
  float s0, c0, s1, c1;
  sincosf(f[0], &s0, &c0);
  if (f[1] == f[0]) {
    s1 = s0;
    c1 = c0;
  } else {
    sincosf(f[1], &s1, &c1);
  }
  return rope_pair_cs(x, c0, s0, c1, s1);
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    attn_frame_f32_kernel(const float* __restrict__ qkv,
                          const float* __restrict__ freqs,
                          float* __restrict__ out, int S, int D, int rot) {
  constexpr int CW = HD / 16, PAIRS = HD / 2;
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;                   // [HD][kF32LdQ]: Q^T, roped
  float* kt = qt + HD * kF32LdQ;     // [HD][kF32LdK]: K^T of the tile, roped
  float* vs = kt + HD * kF32LdK;     // [kF32Keys][HD]: V of the tile
  float* pt = vs + kF32Keys * HD;    // [kF32Keys][kF32LdQ]: E^T of the tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kF32Rows;
  const size_t row0 = (size_t)blockIdx.z * S, D3 = 3 * (size_t)D;
  const size_t hc = (size_t)blockIdx.y * HD;
  const float scale = 1.0f / sqrtf((float)HD);

  // 64 rows from p0 of the head's q or k columns (col), roped on their
  // first rot dims, into dst transposed (row stride ld); rows past S zero
  auto stage_t = [&](float* dst, int ld, size_t col, int p0) {
    for (int i = tid; i < 64 * PAIRS; i += kF32Threads) {
      const int r = i / PAIRS, d = i % PAIRS * 2, p = p0 + r;
      float2 x = make_float2(0.f, 0.f);
      if (p < S) {
        x = *reinterpret_cast<const float2*>(qkv + (row0 + p) * D3 + col + d);
        if (d < rot) x = rope_pair_eq(x, freqs + (size_t)p * rot + d);
      }
      dst[d * ld + r] = x.x;
      dst[(d + 1) * ld + r] = x.y;
    }
  };

  stage_t(qt, kF32LdQ, hc, q0);
  float o[4][CW], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[r][c] = 0.f;
  }
  for (int j0 = 0; j0 < S; j0 += kF32Keys) {
    __syncthreads();  // Q is staged; every thread is done with the last tile
    stage_t(kt, kF32LdK, D + hc, j0);
    for (int i = tid; i < kF32Keys * HD / 4; i += kF32Threads) {
      const int r = i / (HD / 4), d = i % (HD / 4) * 4, p = j0 + r;
      *reinterpret_cast<float4*>(vs + r * HD + d) =
          p < S ? *reinterpret_cast<const float4*>(qkv + (row0 + p) * D3 +
                                                   2 * (size_t)D + hc + d)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kF32LdQ +
                                                        ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kF32LdK +
                                                        tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float t = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = j0 + tx * 4 + c < S ? s[r][c] * scale : -INFINITY;
        t = fmaxf(t, s[r][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, w));
      const float mn = fmaxf(m[r], t);  // finite: key j0 is below S
      const float alpha = expf(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - mn);
        sum += s[r][c];
        pt[(tx * 4 + c) * kF32LdQ + ty * 4 + r] = s[r][c];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < CW; ++c) o[r][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kF32Keys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pt + j * kF32LdQ +
                                                        ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float v[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) v[c] = vs[j * HD + tx * CW + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) o[r][c] = fmaf(pv[r], v[c], o[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + ty * 4 + r;
    if (q >= S) continue;
    float* dst = out + (row0 + q) * D + hc + tx * CW;
#pragma unroll
    for (int c = 0; c < CW; ++c) dst[c] = o[r][c] / l[r];
  }
}

template <int HD>
int launch_f32(const float* qkv, const float* freqs, float* out,
               int n_frames, int S, int D, int rot, cudaStream_t st) {
  constexpr size_t smem = attn_f32_smem<HD>();
  static size_t opted = 48 * 1024;
  const cudaError_t e = opt_in_smem(attn_frame_f32_kernel<HD>, smem, opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kF32Rows - 1) / kF32Rows, D / HD, n_frames);
  attn_frame_f32_kernel<HD><<<grid, kF32Threads, smem, st>>>(qkv, freqs, out,
                                                             S, D, rot);
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

// The fp32 form: qkv (n_frames * S, 3D) fp32; freqs (S, rot) fp32 rotary
// table, rope on the first rot dims of each head's q and k; out
// (n_frames * S, D) fp32, head h in columns [h * hd, (h + 1) * hd).
GTAX_ENTRY gtax_attn_frame_f32(const void* qkv, const void* freqs, void* out,
                               int n_frames, int S, int D, int num_heads,
                               int rot, void* stream) {
  if (n_frames <= 0 || S <= 0 || num_heads <= 0 || D % num_heads ||
      rot < 0 || rot % 2 || rot > D / num_heads ||
      reinterpret_cast<uintptr_t>(qkv) % 16 || D % 4)
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const float* f = static_cast<const float*>(freqs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D / num_heads) {
    case 32:
      return launch_f32<32>(q, f, o, n_frames, S, D, rot, st);
    case 64:
      return launch_f32<64>(q, f, o, n_frames, S, D, rot, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
