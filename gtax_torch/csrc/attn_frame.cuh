// The body of the attn_frame kernel as a device function over one
// (query tile, head, frame) unit, shared by attn_frame.cu (one block per
// unit) and the paired int8 kernels of pair_q.cu (units strided over a
// cooperative grid). Both run it with kAttnWarps warps; a query row's
// arithmetic does not depend on which block takes it, so the results are
// bit-equal. See attn_frame.cu for the rounding points.
//
// Tensor cores: each warp owns 16 query rows and runs QK^T and PV as
// mma.sync m16n8k16 (bf16 in, fp32 sums), operands from shared memory by
// ldmatrix. gtax rounds the probabilities AFTER normalising them, so the
// keys are walked twice: pass 1 keeps each row's running max and sum of
// exponentials (rescaled when the max moves); pass 2 recomputes the scores,
// forms p = bf16(exp(s - m) / l) and accumulates P V. The exponentials
// are 2^x on the special-function unit, with log2(e) folded into the score
// scale, and 1 / l is taken once a row: the two exponentials an element
// bound the kernel, not the tensor cores. The head's roped K
// stays resident for both passes; V streams through in 64-key tiles.
#pragma once

#include "common.cuh"

constexpr int kAttnWarps = 8;
constexpr int kAttnQTile = 16 * kAttnWarps;  // query rows of a unit
constexpr int kAttnKTile = 64;               // keys of a V tile

// Dynamic shared memory of one unit: the head's K (all keys, rounded up
// to a whole key tile), then one region the Q tile and later each V tile
// use. Rows are padded by 8 bf16 (16 bytes) so ldmatrix's eight row reads
// hit distinct banks.
template <int HD>
__host__ __device__ inline size_t attn_frame_smem(int S) {
  const size_t keys = (size_t)(S + kAttnKTile - 1) / kAttnKTile * kAttnKTile;
  return (keys + kAttnQTile) * (HD + 8) * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Eight neighbouring elements (c .. c + 7, c a multiple of 8) of a row that
// is fp32 or bf16 in memory, as fp32: one or two 16-byte loads.
__device__ __forceinline__ void load8(const void* base, int is_f32,
                                      size_t idx, float (&v)[8]) {
  if (is_f32) {
    const float4* p =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + idx);
    const float4 a = p[0], b = p[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
    const uint4 u =
        *reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + idx);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// sin and cos of a rotary angle (|x| up to a few thousand radians): a
// two-term Cody-Waite reduction to [-pi, pi], then the special-function
// unit's __sincosf there (abs error < 1e-6, far under the bf16 cast that
// follows), a tenth of sincosf's cost. The K of a head is roped once per
// query tile, so this was most of the staging time at S = 576.
__device__ __forceinline__ void sincos_rope(float x, float* s, float* c) {
  const float k = rintf(x * 0.15915494309189535f);
  const float r = fmaf(-k, -1.7484555e-07f, fmaf(-k, 6.2831854820251465f, x));
  __sincosf(r, s, c);
}

// rope_pair (common.cuh) with sincos_rope; a pair's two angles are equal in
// the repo's tables, so one reduction serves both.
__device__ __forceinline__ float2 rope_pair_fast(float2 x,
                                                 const float* freqs) {
  float s0, c0, s1, c1;
  sincos_rope(freqs[0], &s0, &c0);
  if (freqs[1] == freqs[0]) {
    s1 = s0;
    c1 = c0;
  } else {
    sincos_rope(freqs[1], &s1, &c1);
  }
  return make_float2(x.x * c0 + (-x.y) * s0, x.y * c1 + x.x * s1);
}

// Rows p0 .. p0 + n - 1 of one head's q, k or v (qkv columns col ..) into
// dst (bf16, row stride HD + 8), rows past S as zeros: eight elements a
// thread and four chunks in flight, roped in fp32 on the first `rot` dims
// (freqs row p), cast to bf16, and also stored to out (columns hc ..) when
// out is not null.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const void* qkv,
                                           int qkv_f32, size_t row0,
                                           size_t D3, size_t col, int p0,
                                           int n, int S, const float* freqs,
                                           int rot, bf16* out, size_t D,
                                           size_t hc) {
  constexpr int CH = HD / 8, LD = HD + 8, NT = kAttnWarps * 32, U = 4;
  const int total = n * CH;
  for (int i0 = threadIdx.x; i0 < total; i0 += NT * U) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * NT, p = p0 + idx / CH, c = (idx % CH) * 8;
      if (idx < total && p < S) {
        load8(qkv, qkv_f32, (row0 + p) * D3 + col + c, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * NT, r = idx / CH, c = (idx % CH) * 8;
      if (idx >= total) break;
      const int p = p0 + r;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        if (p < S && c + e < rot) {
          const float2 x = rope_pair_fast(make_float2(v[u][e], v[u][e + 1]),
                                          freqs + (size_t)p * rot + c + e);
          v[u][e] = x.x;
          v[u][e + 1] = x.y;
        }
      }
      uint4 packed;
      uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = pack_bf16(v[u][2 * e], v[u][2 * e + 1]);
      *reinterpret_cast<uint4*>(dst + (size_t)r * LD + c) = packed;
      if (out != nullptr && p < S)
        *reinterpret_cast<uint4*>(out + (row0 + p) * D + hc + c) = packed;
    }
  }
}

// 2^x on the special-function unit (two ulp; underflow flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Raw scores (q . k, fp32 sums) of a warp's 16 query rows against keys
// j0 .. j0 + 63: s[nt] is the m16n8 tile of keys j0 + 8 nt ..; this thread
// holds rows g = lane / 4 (s[nt][0..1]) and g + 8 (s[nt][2..3]), keys
// j0 + 8 nt + 2 (lane % 4) + (0, 1).
template <int HD>
__device__ __forceinline__ void attn_qk(float (&s)[8][4],
                                        const uint32_t (&qf)[HD / 16][4],
                                        const bf16* Ks, int j0, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // two n8 tiles of keys a load
      uint32_t b[4];
      const int key = j0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(b, Ks + (size_t)key * LD + kc * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[2 * np], qf[kc], b[0], b[1]);
      mma16816(s[2 * np + 1], qf[kc], b[2], b[3]);
    }
  }
}

// The softmax's exponential and normalisation. kExact: gtax's rounding
// points, e = exp(s - m) and p = e / l by IEEE division (attn_sdpa). Else
// the frame attention's: scores prescaled by log2(e), e = 2^(s - m) on the
// special-function unit, and p = e * (1 / l).
template <bool kExact>
__device__ __forceinline__ float attn_exp(float x) {
  return kExact ? expf(x) : ex2(x);
}

// e / l rounded once, as IEEE division rounds it, for e in [0, 1] and a
// softmax row sum l >= 1, from r = 1 / l (rounded): q = e r, then one
// fused correction by the remainder e - q l, which an FMA forms exactly
// (Markstein): three operations where the division takes a dozen and a
// branch. Below 2^-96 the remainder would underflow, so the division itself
// runs there (such a p moves no sum it enters); e = 0 (a masked key) needs
// no correction.
__device__ __forceinline__ float div_rn_by(float e, float l, float r) {
  if (e < 1.2621774e-29f && e > 0.f) return __fdiv_rn(e, l);
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// One warp's 16 query rows (A fragments qf) against the S keys of a head:
// O = bf16(softmax(scores)) V into o (the m16n8 tiles of dims 8 dt ..; rows
// as attn_qk's). Ks holds the keys, resident, rows past S zero, rounded up
// to a whole 64-key tile. finish(s, j0) turns attn_qk's raw tile into the
// scores (scaled, biased, -inf for keys >= S). gtax rounds the
// probabilities after normalising them, so the keys are walked twice: pass
// 1 keeps each row's running max and sum of exponentials (rescaled when the
// max moves); pass 2 recomputes the scores, forms p = bf16(e / l) and
// accumulates P V. stage_v(Vt, j0) stages keys j0 .. j0 + 63 of V into Vt,
// by plain stores or by cp.async (waited for here); the tiles alternate
// between the two halves of Vs (2 x 64 rows): tile t + 1 is staged after
// the barrier that opens tile t, which also tells that every warp is done
// with tile t - 1, whose half it takes, so an asynchronous stager's copies
// overlap tile t's products. live = false (every row of the warp is past
// S) skips the warp's products but keeps it in the barriers.
// A probe build (GTAX_PROBE_STOP, common.cuh) stops before pass 1 (0) or
// after it (1), the row sums in o.
template <int HD, bool kExact, class Finish, class StageV>
__device__ __forceinline__ void attn_rows(const uint32_t (&qf)[HD / 16][4],
                                          const bf16* Ks, bf16* Vs, int S,
                                          bool live, Finish finish,
                                          StageV stage_v,
                                          float (&o)[HD / 8][4], int lane) {
  constexpr int LD = HD + 8, DT = HD / 8;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float s[8][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  for (int j0 = 0; GTAX_PROBE_STOP > 0 && live && j0 < S;
       j0 += kAttnKTile) {
    attn_qk<HD>(s, qf, Ks, j0, lane);
    finish(s, j0);
    float t_a = -INFINITY, t_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      t_a = fmaxf(t_a, fmaxf(s[nt][0], s[nt][1]));
      t_b = fmaxf(t_b, fmaxf(s[nt][2], s[nt][3]));
    }
    const float n_a = fmaxf(m_a, quad_max(t_a));
    const float n_b = fmaxf(m_b, quad_max(t_b));
    l_a *= attn_exp<kExact>(m_a - n_a);
    l_b *= attn_exp<kExact>(m_b - n_b);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      l_a += attn_exp<kExact>(s[nt][0] - n_a) +
             attn_exp<kExact>(s[nt][1] - n_a);
      l_b += attn_exp<kExact>(s[nt][2] - n_b) +
             attn_exp<kExact>(s[nt][3] - n_b);
    }
    m_a = n_a;
    m_b = n_b;
  }
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (GTAX_PROBE_STOP < 2) {
    o[0][0] = l_a;
    o[0][2] = l_b;
    return;
  }
  // one reciprocal a row
  const float r_a = __frcp_rn(l_a), r_b = __frcp_rn(l_b);
  auto prob = [&](float x, float m, float l, float r) {
    return kExact ? div_rn_by(expf(x - m), l, r) : ex2(x - m) * r;
  };

  __syncthreads();  // every warp has its Q fragments: Vs overlays them
  stage_v(Vs, 0);
  for (int j0 = 0; j0 < S; j0 += kAttnKTile) {
    const int t = j0 / kAttnKTile;
    bf16* Vt = Vs + (size_t)(t & 1) * kAttnKTile * LD;
    cp_async_wait<0>();  // this thread's copies of tile t (if it made any)
    __syncthreads();     // tile t is in; every warp is done with tile t - 1
    if (j0 + kAttnKTile < S)  // the next tile, into tile t - 1's half
      stage_v(Vs + (size_t)((t + 1) & 1) * kAttnKTile * LD, j0 + kAttnKTile);
    if (!live) continue;
    attn_qk<HD>(s, qf, Ks, j0, lane);
    finish(s, j0);
#pragma unroll
    for (int kc = 0; kc < kAttnKTile / 16; ++kc) {
      // the A fragment of P for keys 16 kc ..: score tiles 2 kc, 2 kc + 1
      const uint32_t pf[4] = {
          pack_bf16(prob(s[2 * kc][0], m_a, l_a, r_a),
                    prob(s[2 * kc][1], m_a, l_a, r_a)),
          pack_bf16(prob(s[2 * kc][2], m_b, l_b, r_b),
                    prob(s[2 * kc][3], m_b, l_b, r_b)),
          pack_bf16(prob(s[2 * kc + 1][0], m_a, l_a, r_a),
                    prob(s[2 * kc + 1][1], m_a, l_a, r_a)),
          pack_bf16(prob(s[2 * kc + 1][2], m_b, l_b, r_b),
                    prob(s[2 * kc + 1][3], m_b, l_b, r_b))};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {  // two n8 tiles of V a load
        uint32_t b[4];
        const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(b, Vt + (size_t)key * LD + dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], pf, b[0], b[1]);
        mma16816(o[2 * dp + 1], pf, b[2], b[3]);
      }
    }
  }
}

// Query tile qt (rows qt * qtile .., qtile a multiple of 16 up to
// kAttnQTile), head h, frame n. A tile of fewer rows than the block has
// warps leaves the spare warps only the staging and the barriers; a
// query row's arithmetic is the same in every tiling.
template <int HD>
__device__ __forceinline__ void attn_frame_unit(
    unsigned char* smem, const void* __restrict__ qkv, int qkv_f32,
    const float* __restrict__ freqs, void* __restrict__ out, int out_f32,
    bf16* __restrict__ q_out, bf16* __restrict__ k_out,
    bf16* __restrict__ v_out, int S, int D, int rot, int qt, int h, int n,
    int qtile = kAttnQTile) {
  constexpr int LD = HD + 8, KC = HD / 16, DT = HD / 8;
  const int keys = (S + kAttnKTile - 1) / kAttnKTile * kAttnKTile;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Qs = Ks + (size_t)keys * LD;  // the Q tile, then each V tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * qtile;
  // every warp holds query rows in a full tile (qtile a constant there, so
  // the check folds away)
  const bool live = qtile >= kAttnQTile || warp * 16 < qtile;
  const size_t row0 = (size_t)n * S;
  const size_t D3 = 3 * (size_t)D;
  const size_t hc = (size_t)h * HD;
  // scores in base-2 units: softmax(s) = 2^(s log2(e) - max), one
  // special-function op an exponential
  const float scale = 1.4426950408889634f / sqrtf((float)HD);

  // the unit's query rows and the head's keys, roped in fp32 and cast;
  // rows past S are zeros; one query tile stores K and V for training
  stage_rows<HD>(Qs, qkv, qkv_f32, row0, D3, hc, q0, qtile, S, freqs, rot,
                 q_out, D, hc);
  stage_rows<HD>(Ks, qkv, qkv_f32, row0, D3, D + hc, 0, keys, S, freqs, rot,
                 qt == 0 ? k_out : nullptr, D, hc);
  __syncthreads();

  uint32_t qf[KC][4];  // A fragments of the warp's 16 query rows
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    if (live)
      ldsm_x4(qf[kc], Qs + (size_t)(warp * 16 + (lane & 15)) * LD + kc * 16 +
                          (lane >> 4) * 8);

  auto finish = [&](float (&s)[8][4], int j0) {
    const bool ragged = j0 + 64 > S;  // only the last tile has masked keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = j0 + nt * 8 + (lane & 3) * 2 + (i & 1);
        s[nt][i] = ragged && key >= S ? -INFINITY : s[nt][i] * scale;
      }
  };
  auto stage_v = [&](bf16* Vt, int j0) {
    stage_rows<HD>(Vt, qkv, qkv_f32, row0, D3, 2 * (size_t)D + hc, j0,
                   kAttnKTile, S, nullptr, 0, qt == 0 ? v_out : nullptr, D,
                   hc);
  };
  float o[DT][4];
  attn_rows<HD, false>(qf, Ks, Qs, S, live, finish, stage_v, o, lane);
  if (!live) return;

  const int ra = q0 + warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const size_t c = hc + dt * 8 + (lane & 3) * 2;
    if (out_f32) {
      float* of = static_cast<float*>(out);
      if (ra < S)
        *reinterpret_cast<float2*>(of + (row0 + ra) * D + c) =
            make_float2(o[dt][0], o[dt][1]);
      if (rb < S)
        *reinterpret_cast<float2*>(of + (row0 + rb) * D + c) =
            make_float2(o[dt][2], o[dt][3]);
    } else {
      bf16* ob = static_cast<bf16*>(out);
      if (ra < S) store_pair(ob, (row0 + ra) * D + c, o[dt][0], o[dt][1]);
      if (rb < S) store_pair(ob, (row0 + rb) * D + c, o[dt][2], o[dt][3]);
    }
  }
}
