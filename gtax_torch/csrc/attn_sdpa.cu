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
// The fp32 form (gtax_attn_sdpa_f32, below) has a warp-row body and a
// tiled one, both on the CUDA cores.
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
// body over fp32 rows for short rows, and for longer ones a tiled fp32
// SIMT body in two forms by S (below): scores fp32(q . k * scale + bias),
// exact expf, an online softmax over key tiles whose PV sums are divided
// by the row's sum once, PV summed in fp32, an fp32 output. No
// tensor-core instruction: TF32 would keep three digits.
//
// Bound: operations, 67 TFLOP/s of fp32 FFMA (4 S^2 d a head: 8.15 GFLOP
// at the VAE shape). The tiled body replaced csrc/attn_f32.cuh's unit
// here, which ran at a third of that: 4x4 register tiles, shared-memory
// bound, 64-row tiles that padded S = 144 to 192 and made 2.18 waves at
// 576. Both forms:
//  - land Q, K and V rows in shared memory as they lie in global memory,
//    16-byte cp.async copies (rows past S zero-filled); K and V stream
//    through a ring of key tiles, the next tiles' copies in flight during
//    this tile's FFMAs; a thread holds 8 query rows (ty + RG i:
//    neighbouring threads of a warp on neighbouring rows) and reads Q and
//    K rows as float4 along d; row strides of HD + 4 floats put the rows a
//    phase reads in distinct banks; a row's max and sum are reduced by
//    shuffles within the threads that hold it, its scale factors stay in
//    the threads that hold its outputs.
//  - Below 576 tokens (sdpa_f32_body 1, attn_sdpa_f32_tile_kernel): 48
//    query rows (RG 6, 96 threads) over 48-key tiles, three stages: at
//    S = 144 a head's K and V lie whole in shared memory, loaded at once,
//    no padded work, 240 blocks two an SM (99 KB each); a thread 8 rows by
//    3 keys (tx + 16 c) and by HD / 16 output dims, the probabilities
//    through shared memory (P^T).
//  - From 576 tokens (body 2, attn_sdpa_f32_wide_kernel): 128 query rows
//    (RG 32, 256 threads) over 64-key tiles, two stages, two blocks an SM
//    (102 KB each); a thread 4 rows by 8 keys and by HD / 8 output dims
//    (below). At S = 576 a head's last query tile is half full: 480
//    blocks, 432 of work.

// The tile's shape: RG row groups of 8 rows, KC keys a thread, STAGES key
// tiles in the ring.
template <int HD>
struct SdpaF32 {
  static constexpr int RG = 6, KC = 3, STAGES = 3;
  static constexpr int TR = 8;             // query rows a thread
  static constexpr int THREADS = RG * 16;  // 16 threads a row group
  static constexpr int QT = RG * TR;       // query rows a block
  static constexpr int KT = 16 * KC;       // keys a tile
  static constexpr int CW = HD / 16;       // output dims a thread
  static constexpr int LD = HD + 4;        // Q and K rows
  static constexpr int LDP = QT + 4;       // P^T rows
  static constexpr size_t kFloats = (size_t)QT * LD +
                                    (size_t)STAGES * KT * (LD + HD) +
                                    (size_t)KT * LDP;
  static constexpr size_t smem() { return kFloats * sizeof(float); }
};

// ---- the tiled bodies' shared parts, over a shape T (SdpaF32 or
// SdpaF32Wide): T::THREADS threads; the block's T::QT Q rows (T::LD floats
// apart) in shared memory, then a ring of T::STAGES key tiles of T::KT
// keys, each its K rows (T::LD apart) and its V rows (HD apart).

// one (row of N, head) of K and V as a tiled body reads them
struct F32Keys {
  const float* k;
  const float* v;
  int k_ld, v_ld, S;
};

// rows p0 .. p0 + rows - 1 of src (token stride ld) to dst (row stride
// ldd), 16 bytes a cp.async, rows past S zero-filled
template <int HD, class T>
__device__ __forceinline__ void f32_stage(float* dst, int ldd,
                                          const float* src, int ld, int p0,
                                          int rows, int S) {
  constexpr int CH = HD / 4;
  for (int c = threadIdx.x; c < rows * CH; c += T::THREADS) {
    const int r = c / CH, d = c % CH * 4, p = p0 + r;
    cp_async16(dst + r * ldd + d, src + (size_t)min(p, S - 1) * ld + d,
               p < S ? 16 : 0);
  }
}

// key tile t's stage of the ring: its K rows, then (KT * LD on) its V rows
template <int HD, class T>
__device__ __forceinline__ float* f32_ring_stage(float* ring, int t) {
  return ring + (t % T::STAGES) * T::KT * (T::LD + HD);
}

template <int HD, class T>
__device__ __forceinline__ void f32_load_tile(float* ring, int t,
                                              const F32Keys& kv) {
  float* ks = f32_ring_stage<HD, T>(ring, t);
  f32_stage<HD, T>(ks, T::LD, kv.k, kv.k_ld, t * T::KT, T::KT, kv.S);
  f32_stage<HD, T>(ks + T::KT * T::LD, HD, kv.v, kv.v_ld, t * T::KT, T::KT,
                   kv.S);
}

// Q's rows q0 .. q0 + QT - 1 and the first STAGES - 1 key tiles in flight
template <int HD, class T>
__device__ __forceinline__ void f32_prologue(float* qs, float* ring,
                                             const float* qn, int q_ld,
                                             int q0, int tiles,
                                             const F32Keys& kv) {
  f32_stage<HD, T>(qs, T::LD, qn, q_ld, q0, T::QT, kv.S);
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < tiles) f32_load_tile<HD, T>(ring, s, kv);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
}

// waits for key tile t, sets tile t + STAGES - 1 in flight into the stage
// tile t - 1 left; tile t's stage
template <int HD, class T>
__device__ __forceinline__ const float* f32_next_tile(float* ring, int t,
                                                      int tiles,
                                                      const F32Keys& kv) {
  cp_async_wait<T::STAGES - 2>();
  __syncthreads();  // tile t landed; every thread left tile t - 1
  if (t + T::STAGES - 1 < tiles)
    f32_load_tile<HD, T>(ring, t + T::STAGES - 1, kv);
  cp_async_commit();
  return f32_ring_stage<HD, T>(ring, t);
}

template <int TR, int CW>
__device__ __forceinline__ void f32_init_rows(float (&o)[TR][CW],
                                              float (&m)[TR],
                                              float (&l)[TR]) {
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  }
}

// a row's outputs divided by its sum once: CW / CV vectors of CV floats,
// vector g at dst + GS g
template <int CW, int CV, int GS>
__device__ __forceinline__ void f32_store_row(float* dst,
                                              const float (&o)[CW],
                                              float l) {
#pragma unroll
  for (int g = 0; g < CW / CV; ++g) {
    if constexpr (CV == 4)
      *reinterpret_cast<float4*>(dst + GS * g) =
          make_float4(o[4 * g] / l, o[4 * g + 1] / l, o[4 * g + 2] / l,
                      o[4 * g + 3] / l);
    else
      *reinterpret_cast<float2*>(dst + GS * g) =
          make_float2(o[2 * g] / l, o[2 * g + 1] / l);
  }
}

// CW contiguous floats (4 or 2) of shared memory
template <int CW>
__device__ __forceinline__ void lds_cw(const float* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  }
}

template <int HD>
__global__ void __launch_bounds__(SdpaF32<HD>::THREADS)
    attn_sdpa_f32_tile_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int S, int q_ld,
                              int k_ld, int v_ld, int o_ld, float scale) {
  using T = SdpaF32<HD>;
  constexpr int RG = T::RG, KC = T::KC, TR = T::TR, QT = T::QT, KT = T::KT,
                CW = T::CW, LD = T::LD, LDP = T::LDP;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                        // [QT][LD]: Q rows
  float* ring = qs + QT * LD;             // the key tiles
  float* pt = ring + T::STAGES * KT * (LD + HD);  // [KT][LDP]: P^T
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * QT;
  const size_t hc = (size_t)blockIdx.y * HD, n = blockIdx.z;
  const F32Keys kv{k + n * S * k_ld + hc, v + n * S * v_ld + hc, k_ld, v_ld,
                   S};
  float* on = out + n * S * o_ld + hc;
  const int tiles = (S + KT - 1) / KT;
  f32_prologue<HD, T>(qs, ring, q + n * S * q_ld + hc, q_ld, q0, tiles, kv);

  float o[TR][CW], m[TR], l[TR];
  f32_init_rows(o, m, l);
  // a row past S reads bias row S - 1; its output is not stored
  const float* brow[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
    brow[i] = bias == nullptr
                  ? nullptr
                  : bias + (size_t)min(q0 + ty + RG * i, S - 1) * S;

  for (int t = 0; t < tiles; ++t) {
    const float* ks = f32_next_tile<HD, T>(ring, t, tiles, kv);
    const float* vs = ks + KT * LD;

    float s[TR][KC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[TR], b[KC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + RG * i) * LD + d);
#pragma unroll
      for (int c = 0; c < KC; ++c)
        b[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          s[i][c] = fmaf(a[i].x, b[c].x, s[i][c]);
          s[i][c] = fmaf(a[i].y, b[c].y, s[i][c]);
          s[i][c] = fmaf(a[i].z, b[c].z, s[i][c]);
          s[i][c] = fmaf(a[i].w, b[c].w, s[i][c]);
        }
    }
    // the online softmax, a row at a time: scores fp32(q . k * scale +
    // bias), -inf past S; the row's max and sum over its 16 lanes; its
    // outputs rescaled. Written out in each body: as one shared
    // __device__ step this body ran 8-12% slower (256 more instructions
    // at the same FFMAs; PERF.md section 6).
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int key = t * KT + tx + 16 * c;
        const float sc = __fmul_rn(s[i][c], scale);
        s[i][c] = key >= S            ? -INFINITY
                  : brow[i] == nullptr ? sc
                                       : __fadd_rn(sc, brow[i][key]);
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);  // finite: key t KT is below S
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[i][c] = expf(s[i][c] - mn);
        sum += s[i][c];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i][c] *= alpha;
    }

    // P^T through shared memory: key j's row of the block's probabilities
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float* dst = pt + (tx + 16 * c) * LDP + ty * TR;
      *reinterpret_cast<float4*>(dst) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    __syncthreads();  // P^T of the tile is whole

#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(pt + j * LDP +
                                                         ty * TR);
      const float4 p1 = *reinterpret_cast<const float4*>(pt + j * LDP +
                                                         ty * TR + 4);
      const float p[TR] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vv[CW];
      lds_cw<CW>(vs + j * HD + tx * CW, vv);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + RG * i;
    if (r < S)
      f32_store_row<CW, CW, 0>(on + (size_t)r * o_ld + tx * CW, o[i], l[i]);
  }
}

// The tiled body's 128-row form (attn_sdpa_f32_wide_kernel, from
// SDPA_F32_WIDE_MIN_S tokens): RG row groups of TX = 8 threads, a thread TR
// query rows (ty + RG i) by KC = 8 keys (tx + 8 c) of a 64-key tile and the
// same rows by HD / 8 dims (tx * 4 + 32 g ..) of the output; a row's
// probabilities reach the threads of its outputs by shuffles within its 8
// lanes, not through shared memory, so Q and two stages of K and V leave
// room for two blocks an SM. QK^T holds a d-slice's row float4s in
// registers and streams the keys'. The shape (SdpaF32Wide): 128 rows of
// 256 threads, 4 rows a thread, two blocks an SM (16 warps). Shapes were
// timed at S = 576 from an exploration harness not kept (PERF.md section
// 6; gtax_torch/tools/attn_sweep.py --f32 times the one kept): 8
// rows a thread (four FFMAs a loaded value, but 255 registers: 8 warps an
// SM) ran 0.3233 ms, 4 rows 0.3085, 144- and 96-row tiles and 32-key
// tiles 0.32-0.54; the 64-row 4x4 body it replaced 0.3393.
template <int HD>
struct SdpaF32Wide {
  static constexpr int RG = 32, TR = 4, TX = 8, KC = 8;
  static constexpr int STAGES = 2, BLOCKS = 2;
  static constexpr int THREADS = RG * TX;
  static constexpr int QT = RG * TR;
  static constexpr int KT = TX * KC;
  static constexpr int CW = HD / TX;  // output dims a thread
  static constexpr int LD = HD + 4;
  static constexpr size_t smem() {
    return ((size_t)QT * LD + (size_t)STAGES * KT * (LD + HD)) *
           sizeof(float);
  }
};

template <int HD>
__global__ void __launch_bounds__(SdpaF32Wide<HD>::THREADS,
                                  SdpaF32Wide<HD>::BLOCKS)
    attn_sdpa_f32_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int S, int q_ld,
                              int k_ld, int v_ld, int o_ld, float scale) {
  using T = SdpaF32Wide<HD>;
  constexpr int RG = T::RG, TR = T::TR, TX = T::TX, KC = T::KC, QT = T::QT,
                KT = T::KT, CW = T::CW, LD = T::LD;
  static_assert(CW % 4 == 0 && T::THREADS % 32 == 0,
                "float4 output dims, whole warps");
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;             // [QT][LD]: Q rows
  float* ring = qs + QT * LD;  // the key tiles
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * QT;
  const size_t hc = (size_t)blockIdx.y * HD, n = blockIdx.z;
  const F32Keys kv{k + n * S * k_ld + hc, v + n * S * v_ld + hc, k_ld, v_ld,
                   S};
  float* on = out + n * S * o_ld + hc;
  const int tiles = (S + KT - 1) / KT;
  f32_prologue<HD, T>(qs, ring, q + n * S * q_ld + hc, q_ld, q0, tiles, kv);

  float o[TR][CW], m[TR], l[TR];
  f32_init_rows(o, m, l);

  for (int t = 0; t < tiles; ++t) {
    const float* ks = f32_next_tile<HD, T>(ring, t, tiles, kv);
    const float* vs = ks + KT * LD;

    float s[TR][KC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[i][c] = 0.f;
    // a 4-deep slice of d: the thread's rows' float4s held, its keys'
    // streamed
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + RG * i) * LD + d);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const float4 b =
            *reinterpret_cast<const float4*>(ks + (tx + TX * c) * LD + d);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          s[i][c] = fmaf(a[i].x, b.x, s[i][c]);
          s[i][c] = fmaf(a[i].y, b.y, s[i][c]);
          s[i][c] = fmaf(a[i].z, b.z, s[i][c]);
          s[i][c] = fmaf(a[i].w, b.w, s[i][c]);
        }
      }
    }
    // the online softmax, a row at a time, as the 48-row body's over the
    // row's TX lanes
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      // a row past S reads bias row S - 1; its output is not stored
      const float* brow =
          bias == nullptr ? nullptr
                          : bias + (size_t)min(q0 + ty + RG * i, S - 1) * S;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int key = t * KT + tx + TX * c;
        const float sc = __fmul_rn(s[i][c], scale);
        s[i][c] = key >= S         ? -INFINITY
                  : brow == nullptr ? sc
                                    : __fadd_rn(sc, brow[key]);
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int w = TX / 2; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);  // finite: key t KT is below S
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[i][c] = expf(s[i][c] - mn);
        sum += s[i][c];
      }
#pragma unroll
      for (int w = TX / 2; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i][c] *= alpha;
    }

    // PV: key src + TX c's probabilities from lane src of the row group
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll 2
      for (int src = 0; src < TX; ++src) {
        const float* vr = vs + (src + TX * c) * HD + tx * 4;
        float vv[CW];
#pragma unroll
        for (int g = 0; g < CW / 4; ++g) {
          const float4 f = *reinterpret_cast<const float4*>(vr + 4 * TX * g);
          vv[4 * g] = f.x, vv[4 * g + 1] = f.y, vv[4 * g + 2] = f.z,
                 vv[4 * g + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float p = __shfl_sync(0xffffffffu, s[i][c], src, TX);
#pragma unroll
          for (int e = 0; e < CW; ++e) o[i][e] = fmaf(p, vv[e], o[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty + RG * i;
    if (r < S)
      f32_store_row<CW, 4, 4 * TX>(on + (size_t)r * o_ld + tx * 4, o[i],
                                   l[i]);
  }
}

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

// the tiled body at one shape (the grid: query tiles x heads x rows)
template <int HD>
int launch_f32_tile(const float* q, const float* k, const float* v,
                    const float* bias, float* out, int N, int S, int H,
                    int q_ld, int k_ld, int v_ld, int o_ld, float scale,
                    cudaStream_t st) {
  using T = SdpaF32<HD>;
  static size_t opted = 48 * 1024;
  const cudaError_t e =
      opt_in_smem(attn_sdpa_f32_tile_kernel<HD>, T::smem(), opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + T::QT - 1) / T::QT, H, N);
  attn_sdpa_f32_tile_kernel<HD><<<grid, T::THREADS, T::smem(), st>>>(
      q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
  return (int)cudaGetLastError();
}

// the tiled body's 128-row form
template <int HD>
int launch_f32_wide(const float* q, const float* k, const float* v,
                    const float* bias, float* out, int N, int S, int H,
                    int q_ld, int k_ld, int v_ld, int o_ld, float scale,
                    cudaStream_t st) {
  using W = SdpaF32Wide<HD>;
  static size_t opted = 48 * 1024;
  const cudaError_t e =
      opt_in_smem(attn_sdpa_f32_wide_kernel<HD>, W::smem(), opted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + W::QT - 1) / W::QT, H, N);
  attn_sdpa_f32_wide_kernel<HD><<<grid, W::THREADS, W::smem(), st>>>(
      q, k, v, bias, out, S, q_ld, k_ld, v_ld, o_ld, scale);
  return (int)cudaGetLastError();
}

// body: 0 warp rows, 1 the tiled body's 48-row tiles, 2 its 128-row tiles
template <int HD>
int launch_f32(const float* q, const float* k, const float* v,
               const float* bias, float* out, int N, int S, int H, int q_ld,
               int k_ld, int v_ld, int o_ld, int body, float scale,
               cudaStream_t st) {
  if (body == 1)
    return launch_f32_tile<HD>(q, k, v, bias, out, N, S, H, q_ld, k_ld,
                               v_ld, o_ld, scale, st);
  if (body == 2)
    return launch_f32_wide<HD>(q, k, v, bias, out, N, S, H, q_ld, k_ld,
                               v_ld, o_ld, scale, st);
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
// body (the caller's rule by S, gtax_torch/kernels/attention.py
// sdpa_f32_body): 0 warp rows, 1 the tiled body's 48-row tiles, 2 its
// 128-row tiles. The tiled body reads q, k, v and writes out 16 bytes at
// a time (lds multiples of 4, pointers 16-byte aligned); warp rows read 8
// bytes (lds even, pointers 8-byte aligned).
GTAX_ENTRY gtax_attn_sdpa_f32(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int N, int S,
                              int num_heads, int hd, int q_ld, int k_ld,
                              int v_ld, int o_ld, int body, float scale,
                              void* stream) {
  const int align = body ? 4 : 2;
  if (N <= 0 || S <= 0 || num_heads <= 0 || body < 0 || body > 2 ||
      q_ld < num_heads * hd ||
      k_ld < num_heads * hd || v_ld < num_heads * hd ||
      o_ld < num_heads * hd || q_ld % align || k_ld % align || v_ld % align ||
      o_ld % align ||
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
                            v_ld, o_ld, body, scale, st);
    case 64:
      return launch_f32<64>(qp, kp, vp, b, o, N, S, num_heads, q_ld, k_ld,
                            v_ld, o_ld, body, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
