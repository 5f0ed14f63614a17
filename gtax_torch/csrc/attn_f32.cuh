// The fp32 SIMT attention body as device functions, shared by the fp32
// frame attention (attn_frame.cu attn_frame_f32, one block per unit), the
// fp32 paired int8 kernels (pair_q_f32.cu, units strided over a
// cooperative grid) and the fp32 form of the `pallas` backend's attention
// (attn_sdpa.cu attn_sdpa_tiled_f32). A unit's arithmetic does not depend
// on which block takes it, so every caller gives the same bits.
//
// Nothing is rounded to a narrower type (gtax's kernels at x.dtype =
// float32: every astype is a no-op, probabilities included), and no
// tensor-core instruction runs: no tensor-core type keeps fp32 (TF32 keeps
// ten mantissa bits). A block of 256 threads takes kF32Rows query rows of
// one (row of heads, head) and walks the keys in tiles of kF32Keys, with
// an online softmax: per tile, the scores S = Q K^T (fp32 FFMA), each
// row's running max and sum of exponentials (expf), the partial sums O =
// O * exp(m_old - m) + E V, and at the end O / l. A head's fp32 K and V
// would not fit a block's shared memory at S = 576 (295 KB at head dim
// 64), so they stream through in tiles. Thread (ty, tx) = (tid / 16, tid %
// 16) holds query rows 4 ty .. 4 ty + 3 of the tile, their scores against
// keys 4 tx .. 4 tx + 3 of the key tile, and their outputs at dims HD / 16
// tx ..: a row's scores, running max and sum live in the 16 threads of a
// half-warp (reduced by four shuffles), and its scale factors stay in the
// threads that hold its outputs. Q and K are staged transposed (dim-major),
// so both products read float4 along the thread's rows and columns.
#pragma once

#include "common.cuh"

constexpr int kF32Rows = 64, kF32Keys = 64, kF32Threads = 256;
constexpr int kF32LdQ = kF32Rows + 4, kF32LdK = kF32Keys + 4;

// Shared memory of one unit: Q^T, the key tile's K^T, its V, and E^T.
template <int HD>
__host__ __device__ constexpr size_t attn_f32_smem() {
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

// 64 rows from p0 of q or k (load(p, d): float2, dims d, d + 1 of row
// p < S) into dst transposed (row stride ld); rows past S zero.
template <int HD, class Load>
__device__ __forceinline__ void attn_f32_stage_t(float* dst, int ld, int p0,
                                                 int S, Load load) {
  constexpr int PAIRS = HD / 2;
  for (int i = threadIdx.x; i < 64 * PAIRS; i += kF32Threads) {
    const int r = i / PAIRS, d = i % PAIRS * 2, p = p0 + r;
    const float2 x = p < S ? load(p, d) : make_float2(0.f, 0.f);
    dst[d * ld + r] = x.x;
    dst[(d + 1) * ld + r] = x.y;
  }
}

// One unit of kF32Rows query rows from q0, over S keys, by the block's 256
// threads (fsm: attn_f32_smem<HD>() bytes of shared memory). The sources:
//   load_q(p, d), load_k(p, d): float2, dims d, d + 1 of query / key row p
//     (p < S), rope applied;
//   load_v(p, d): float4, dims d .. d + 3 of value row p (p < S);
//   score(s, q, key): the score of row q (possibly past S; its output is
//     not stored) against key (< S) from the dot product s; keys past S
//     score -inf;
//   store(q, c, o): output dim c of row q < S.
// The block's first use of fsm follows its caller's barrier (or the
// kernel's start); the caller synchronises before fsm is used again.
template <int HD, class LoadQ, class LoadK, class LoadV, class Score,
          class Store>
__device__ __forceinline__ void attn_f32_unit(float* fsm, int S, int q0,
                                              LoadQ load_q, LoadK load_k,
                                              LoadV load_v, Score score,
                                              Store store) {
  constexpr int CW = HD / 16;
  float* qt = fsm;                   // [HD][kF32LdQ]: Q^T
  float* kt = qt + HD * kF32LdQ;     // [HD][kF32LdK]: K^T of the tile
  float* vs = kt + HD * kF32LdK;     // [kF32Keys][HD]: V of the tile
  float* pt = vs + kF32Keys * HD;    // [kF32Keys][kF32LdQ]: E^T of the tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  attn_f32_stage_t<HD>(qt, kF32LdQ, q0, S, load_q);
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
    attn_f32_stage_t<HD>(kt, kF32LdK, j0, S, load_k);
    for (int i = tid; i < kF32Keys * HD / 4; i += kF32Threads) {
      const int r = i / (HD / 4), d = i % (HD / 4) * 4, p = j0 + r;
      *reinterpret_cast<float4*>(vs + r * HD + d) =
          p < S ? load_v(p, d) : make_float4(0.f, 0.f, 0.f, 0.f);
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
        const int key = j0 + tx * 4 + c;
        s[r][c] = key < S ? score(s[r][c], q0 + ty * 4 + r, key) : -INFINITY;
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
#pragma unroll
    for (int c = 0; c < CW; ++c) store(q, tx * CW + c, o[r][c] / l[r]);
  }
}

// The fp32 frame attention's unit: query tile qt (kF32Rows rows) of head
// h of frame n, over fp32 qkv rows (n_frames * S, 3D); rope in fp32 on the
// first rot dims of each head's q and k as they load (sincosf: fp32 keeps
// what bf16 would round away); out (n_frames * S, D) fp32. STORE (the
// emit_train residuals of the fp32 spatial branch): also the roped q, k
// and the v it attends with, to q_out, k_out, v_out ((n_frames * S, D)
// fp32), each row by the unit whose query tile holds it, as it loads; the
// stores change nothing the unit computes.
template <int HD, bool STORE = false>
__device__ __forceinline__ void attn_frame_f32_unit(
    float* fsm, const float* __restrict__ qkv, const float* __restrict__ freqs,
    float* __restrict__ out, int S, int D, int rot, int qt, int h, int n,
    float* __restrict__ q_out = nullptr, float* __restrict__ k_out = nullptr,
    float* __restrict__ v_out = nullptr) {
  const size_t row0 = (size_t)n * S, D3 = 3 * (size_t)D;
  const size_t hc = (size_t)h * HD;
  const float scale = 1.0f / sqrtf((float)HD);
  const float* qrows = qkv + row0 * D3 + hc;  // q at column 0, k at D
  // a key row's residuals come from the unit whose query tile holds it
  auto mine = [=](int p) { return p / kF32Rows == qt; };
  auto res = [=](float* t, int p, int d) { return t + (row0 + p) * D + hc + d; };
  attn_f32_unit<HD>(
      fsm, S, qt * kF32Rows,
      [=](int p, int d) {
        float2 x = *reinterpret_cast<const float2*>(qrows + p * D3 + d);
        if (d < rot) x = rope_pair_eq(x, freqs + (size_t)p * rot + d);
        if constexpr (STORE) *reinterpret_cast<float2*>(res(q_out, p, d)) = x;
        return x;
      },
      [=](int p, int d) {
        float2 x = *reinterpret_cast<const float2*>(qrows + p * D3 + D + d);
        if (d < rot) x = rope_pair_eq(x, freqs + (size_t)p * rot + d);
        if constexpr (STORE)
          if (mine(p)) *reinterpret_cast<float2*>(res(k_out, p, d)) = x;
        return x;
      },
      [=](int p, int d) {
        const float4 x =
            *reinterpret_cast<const float4*>(qrows + p * D3 + 2 * D + d);
        if constexpr (STORE)
          if (mine(p)) *reinterpret_cast<float4*>(res(v_out, p, d)) = x;
        return x;
      },
      [=](float s, int, int) { return s * scale; },
      [=](int q, int c, float o) { out[(row0 + q) * D + hc + c] = o; });
}
