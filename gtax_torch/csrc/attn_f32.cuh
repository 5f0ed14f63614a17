// The fp32 attention's device code on the CUDA cores (gtax's kernels at
// x.dtype = float32: every astype is a no-op, probabilities included, so
// nothing is rounded to a narrower type; no tensor-core instruction runs,
// since TF32 keeps ten mantissa bits):
//  - the tiled staging of fp32 rows through cp.async and a ring of key
//    tiles, shared by the `pallas` backend's fp32 bodies (attn_sdpa.cu) and
//    the frame attention below;
//  - the frame attention's rope and its two bodies, shared by
//    attn_frame_f32 (attn_frame.cu: a rope pass, then one block a unit) and
//    the fp32 paired int8 kernels (pair_q.cuh: the rope factors in its
//    first phase, applied by its qkv product's epilogue, then units
//    strided over the cooperative grid). A row's arithmetic depends only on
//    S (the key tiling), never on the query tile or on the block that takes
//    it, so every caller and every query tile gives the same bits.
#pragma once

#include <type_traits>

#include "common.cuh"

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
  T::sync();  // tile t landed; every thread left tile t - 1
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

// N contiguous floats (N even: 8-byte aligned, a multiple of 4: 16-byte)
// of shared memory
template <int N>
__device__ __forceinline__ void lds_n(const float* p, float (&v)[N]) {
  static_assert(N % 2 == 0, "float2 or float4 loads");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int g = 0; g < N / 4; ++g) {
      const float4 f = reinterpret_cast<const float4*>(p)[g];
      v[4 * g] = f.x, v[4 * g + 1] = f.y, v[4 * g + 2] = f.z,
             v[4 * g + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < N / 2; ++g) {
      const float2 f = reinterpret_cast<const float2*>(p)[g];
      v[2 * g] = f.x, v[2 * g + 1] = f.y;
    }
  }
}

// the same as a store
template <int N>
__device__ __forceinline__ void sts_n(float* p, const float (&v)[N]) {
  static_assert(N % 2 == 0, "float2 or float4 stores");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int g = 0; g < N / 4; ++g)
      reinterpret_cast<float4*>(p)[g] =
          make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
  } else {
#pragma unroll
    for (int g = 0; g < N / 2; ++g)
      reinterpret_cast<float2*>(p)[g] = make_float2(v[2 * g], v[2 * g + 1]);
  }
}

// ---- the frame attention's rope: each angle reduced once per (position,
// dim) of a call (once per frame group where the rope pass splits the
// frames), not once per (head, query tile).

// The rotary factors of the pair of dims (d, d + 1) of one position, from
// its two angles f[0], f[1]: (cos f0, sin f0, cos f1, sin f1) by sincosf
// (fp32 keeps what a bf16 rope would round away); a pair of equal angles,
// as the repo's tables have them, is reduced once.
__device__ __forceinline__ float4 rope_factors(const float* f) {
  float s0, c0, s1, c1;
  sincosf(f[0], &s0, &c0);
  if (f[1] == f[0]) {
    s1 = s0;
    c1 = c0;
  } else {
    sincosf(f[1], &s1, &c1);
  }
  return make_float4(c0, s0, c1, s1);
}

// One item of the rope: position p's pair of dims (2 j, 2 j + 1) of every
// head (of hd dims), for frames n = n0, n0 + dn, .. < n_frames. The pair's
// two angles are reduced once for all those heads and frames (j < rot / 2;
// a pair past rot is copied as it is), and q and k of qkv row n S + p (q at
// column 0, k at D, row stride 3D) roped by rope_pair_fma (gemm_s8.cuh
// EPI_F32_ROPE ropes the fp32 pair's rows so, to the same bits) into
// row n S + p of q_dst and k_dst (strides q_ld, k_ld); v_dst non-null: the
// v pair copied there too (stride v_ld). 8 bytes a load.
__device__ __forceinline__ void rope_item(
    const float* __restrict__ freqs, int rot, int p, int j, int S, int D,
    int hd, const float* qkv, float* q_dst, size_t q_ld, float* k_dst,
    size_t k_ld, float* v_dst, size_t v_ld, int n0, int dn, int n_frames) {
  const bool roped = 2 * j < rot;
  float4 f = make_float4(1.f, 0.f, 1.f, 0.f);
  if (roped) f = rope_factors(freqs + (size_t)p * rot + 2 * j);
  const size_t D3 = 3 * (size_t)D;
  for (int n = n0; n < n_frames; n += dn) {
    const size_t r = (size_t)n * S + p;
    const float* src = qkv + r * D3 + 2 * j;
#pragma unroll 8
    for (int c = 0; c < D; c += hd) {
      float2 q = *reinterpret_cast<const float2*>(src + c);
      float2 k = *reinterpret_cast<const float2*>(src + D + c);
      if (roped) {
        q = rope_pair_fma(q, f);
        k = rope_pair_fma(k, f);
      }
      *reinterpret_cast<float2*>(q_dst + r * q_ld + 2 * j + c) = q;
      *reinterpret_cast<float2*>(k_dst + r * k_ld + 2 * j + c) = k;
      if (v_dst != nullptr)
        *reinterpret_cast<float2*>(v_dst + r * v_ld + 2 * j + c) =
            *reinterpret_cast<const float2*>(src + 2 * D + c);
    }
  }
}

// ---- the frame attention's two bodies, over roped q and k and v rows of
// one (frame, head): q, k, v point at the frame's first row and the head's
// first column, rows q_ld / k_ld / v_ld floats apart (multiples of 4,
// 16-byte aligned); out likewise (o_ld). Scores fp32(q . k * d^-1/2) (the
// dot product summed in d order), exact expf, PV summed in key order, each
// row's sums divided by its sum once; a block's threads (T::THREADS, a
// multiple of 32, the first of the block) synchronise among themselves by
// barrier 1 (T::sync), so a caller may run a body on part of its block.
// ready(): called before the first read of q, k or v: attn_frame_f32's
// wait for its rope pass, launched as its programmatic dependent; a no-op
// in the pair, whose qkv product ropes q and k. Which shapes a call may
// take, and the rule that picks one, are in gtax_torch/kernels/block.py
// (F32_FRAME_SHAPES, f32_frame_shape).

// named barrier 1 over the first N threads of the block
template <int N>
__device__ __forceinline__ void bar_sync_n() {
  static_assert(N % 32 == 0, "whole warps");
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// S <= kF32WholeKeys: a head's K and V whole in shared memory and one
// softmax pass (no key loop). Thread (ty, tx) = (tid / 16, tid % 16) of RG
// row groups of 16 lanes holds TR query rows (ty + RG i) of the tile by
// the KC keys tx + 16 c (c < KC) and by HD / 16 output dims (tx HD / 16
// ..); a row's max and sum are reduced over its 16 lanes by shuffles; the
// probabilities reach PV through shared memory (P^T, a chunk of kPChunk
// keys at a time).
constexpr int kF32WholeKC = 9;
constexpr int kF32WholeKeys = 16 * kF32WholeKC;  // 144
constexpr int kF32PChunk = 48;                   // keys a P^T chunk

template <int HD, int TR_, int RG_>
struct F32Whole {
  static constexpr int TR = TR_, RG = RG_, KC = kF32WholeKC;
  static constexpr int THREADS = 16 * RG, QT = TR * RG;
  static constexpr int KEYS = kF32WholeKeys, PK = kF32PChunk;
  static constexpr int CW = HD / 16;  // output dims a thread
  static constexpr int LD = HD + 4;   // Q and K rows
  static constexpr int LDP = QT + 4;  // P^T rows
  static constexpr size_t smem() {
    return ((size_t)QT * LD + (size_t)KEYS * (LD + HD) + (size_t)PK * LDP) *
           sizeof(float);
  }
  static __device__ __forceinline__ void sync() { bar_sync_n<THREADS>(); }
};

template <int HD, class T, class Ready>
__device__ __forceinline__ void frame_f32_whole(
    float* fsm, const float* q, int q_ld, const float* k, int k_ld,
    const float* v, int v_ld, float* out, int o_ld, int S, int q0,
    float scale, Ready ready) {
  constexpr int TR = T::TR, RG = T::RG, KC = T::KC, CW = T::CW, LD = T::LD,
                LDP = T::LDP, PK = T::PK, KEYS = T::KEYS;
  static_assert(KEYS % PK == 0 && PK % 16 == 0, "whole P^T chunks");
  float* qs = fsm;                  // [QT][LD]: Q rows
  float* ks = qs + T::QT * LD;      // [KEYS][LD]: K rows
  float* vs = ks + KEYS * LD;       // [KEYS][HD]: V rows
  float* pt = vs + KEYS * HD;       // [PK][LDP]: P^T of a chunk
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // Q and K, then V in a group of its own, which lands during QK^T
  ready();
  f32_stage<HD, T>(qs, LD, q, q_ld, q0, T::QT, S);
  f32_stage<HD, T>(ks, LD, k, k_ld, 0, KEYS, S);
  cp_async_commit();
  f32_stage<HD, T>(vs, HD, v, v_ld, 0, KEYS, S);
  cp_async_commit();
  cp_async_wait<1>();
  T::sync();

  float s[TR][KC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < KC; ++c) s[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + RG * i) * LD + d);
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float4 b =
          *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        s[i][c] = fmaf(a[i].x, b.x, s[i][c]);
        s[i][c] = fmaf(a[i].y, b.y, s[i][c]);
        s[i][c] = fmaf(a[i].z, b.z, s[i][c]);
        s[i][c] = fmaf(a[i].w, b.w, s[i][c]);
      }
    }
  }
  // one softmax pass a row: max and sum over the row's 16 lanes
  float l[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      s[i][c] = tx + 16 * c < S ? __fmul_rn(s[i][c], scale) : -INFINITY;
      mx = fmaxf(mx, s[i][c]);
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      s[i][c] = expf(s[i][c] - mx);  // key 0 is below S: mx is finite
      sum += s[i][c];
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l[i] = sum;
  }

  float o[TR][CW];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.f;
  cp_async_wait<0>();  // V: the barrier after the first P^T chunk shows it
#pragma unroll
  for (int c0 = 0; c0 < KEYS / PK; ++c0) {
    if (c0 * PK >= S) break;  // keys past S add nothing
    if (c0 > 0) T::sync();    // every thread left the last chunk
    // key tx + 16 c's probabilities of the thread's rows, at column ty TR
#pragma unroll
    for (int c = 0; c < PK / 16; ++c) {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = s[i][c0 * (PK / 16) + c];
      sts_n<TR>(pt + (tx + 16 * c) * LDP + ty * TR, pv);
    }
    T::sync();
    const float* vc = vs + c0 * PK * HD + tx * CW;
#pragma unroll 4
    for (int j = 0; j < PK; ++j) {
      float p[TR], vv[CW];
      lds_n<TR>(pt + j * LDP + ty * TR, p);
      lds_n<CW>(vc + j * HD, vv);
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
      f32_store_row<CW, (CW % 4 ? 2 : 4), 4>(out + (size_t)r * o_ld +
                                                 tx * CW,
                                             o[i], l[i]);
  }
}

// S > kF32WholeKeys: keys in 64-key tiles through a 2-stage cp.async ring
// (the next tile lands during this one's FFMAs), an online softmax. The
// `pallas` fp32 body's 128-row layout (attn_sdpa.cu SdpaF32Wide) with RG
// row groups of 8 lanes: a thread 4 query rows (ty + RG i) by 8 keys (tx +
// 8 c) of a tile and by HD / 8 output dims (tx * 4 + 32 g ..); a row's
// probabilities reach the threads of its outputs by shuffles within its 8
// lanes.
template <int HD, int RG_>
struct F32Ring {
  static constexpr int RG = RG_, TR = 4, TX = 8, KC = 8, STAGES = 2;
  static constexpr int THREADS = RG * TX, QT = RG * TR, KT = TX * KC;
  static constexpr int CW = HD / TX;  // output dims a thread
  static constexpr int LD = HD + 4;
  static constexpr size_t smem() {
    return ((size_t)QT * LD + (size_t)STAGES * KT * (LD + HD)) *
           sizeof(float);
  }
  static __device__ __forceinline__ void sync() { bar_sync_n<THREADS>(); }
};

template <int HD, class T, class Ready>
__device__ __forceinline__ void frame_f32_ring(
    float* fsm, const float* q, int q_ld, const float* k, int k_ld,
    const float* v, int v_ld, float* out, int o_ld, int S, int q0,
    float scale, Ready ready) {
  constexpr int RG = T::RG, TR = T::TR, TX = T::TX, KC = T::KC, KT = T::KT,
                CW = T::CW, LD = T::LD;
  static_assert(CW % 4 == 0 && T::THREADS % 32 == 0,
                "float4 output dims, whole warps");
  float* qs = fsm;                // [QT][LD]: Q rows
  float* ring = qs + T::QT * LD;  // the key tiles
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const F32Keys kv{k, v, k_ld, v_ld, S};
  const int tiles = (S + KT - 1) / KT;
  ready();
  f32_prologue<HD, T>(qs, ring, q, q_ld, q0, tiles, kv);

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
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int key = t * KT + tx + TX * c;
        s[i][c] = key < S ? __fmul_rn(s[i][c], scale) : -INFINITY;
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
      f32_store_row<CW, 4, 4 * TX>(out + (size_t)r * o_ld + tx * 4, o[i],
                                   l[i]);
  }
}

// ---- the shapes a call may take (index: query rows, body). The rule that
// picks one for a call's S, heads, frames and blocks, and the list of them,
// are gtax_torch/kernels/block.py's F32_FRAME_SHAPES and f32_frame_shape
// (a CPU test holds the two lists equal). Whole bodies (S <= 144) share 16
// lanes a row and ring bodies (S > 144) 8, so within a kind a row's bits do
// not depend on the shape. Each is of at most 256 threads and 110 KB at
// head dim 64, so the fp32 pair takes every one.
#define GTAX_F32_FRAME_SHAPES(X) \
  X(0, F32Whole<HD, 2, 12>)      \
  X(1, F32Whole<HD, 4, 12>)      \
  X(2, F32Whole<HD, 6, 12>)      \
  X(3, F32Ring<HD, 16>)
constexpr int kF32FrameShapes = 4;

template <class T>
struct is_f32_whole : std::false_type {};
template <int HD, int TR, int RG>
struct is_f32_whole<F32Whole<HD, TR, RG>> : std::true_type {};

// whether shape i is of S's kind (whole up to kF32WholeKeys tokens, ring
// past them)
template <int HD>
bool f32_frame_shape_ok(int i, int S) {
  switch (i) {
#define GTAX_CASE(I, ...) \
  case I:                 \
    return is_f32_whole<__VA_ARGS__>::value == (S <= kF32WholeKeys);
    GTAX_F32_FRAME_SHAPES(GTAX_CASE)
#undef GTAX_CASE
    default:
      return false;
  }
}

// the most shared memory a shape takes
template <int HD>
constexpr size_t f32_frame_smem() {
  size_t most = 0;
#define GTAX_CASE(I, ...) \
  most = most > __VA_ARGS__::smem() ? most : __VA_ARGS__::smem();
  GTAX_F32_FRAME_SHAPES(GTAX_CASE)
#undef GTAX_CASE
  return most;
}

// One unit of shape T: query rows q0 .. q0 + T::QT - 1 of a (frame, head),
// by the body of T's kind.
template <int HD, class T, class Ready>
__device__ __forceinline__ void frame_f32_unit(
    float* fsm, const float* q, int q_ld, const float* k, int k_ld,
    const float* v, int v_ld, float* out, int o_ld, int S, int q0,
    float scale, Ready ready) {
  if constexpr (is_f32_whole<T>::value)
    frame_f32_whole<HD, T>(fsm, q, q_ld, k, k_ld, v, v_ld, out, o_ld, S, q0,
                           scale, ready);
  else
    frame_f32_ring<HD, T>(fsm, q, q_ld, k, k_ld, v, v_ld, out, o_ld, S, q0,
                          scale, ready);
}
