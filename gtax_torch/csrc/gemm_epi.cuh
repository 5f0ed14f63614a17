// The epilogues of the bf16 GEMM (gemm_sm90.cuh, for gemm_bf16.cu and
// gemm_wgrad.cu): one output tile, already summed into an fp32 tile in
// shared memory, goes through the branch's rounding points to device
// memory. The fp32 GEMM (gemm_f32.cu) takes the same enum and functions
// and stores each value before its rounding.
#pragma once

#include "common.cuh"

enum Epi {
  EPI_F32 = 0,              // fp32 C = acc
  EPI_BIAS_BF16 = 1,        // bf16(acc + bias)
  EPI_BIAS_GELU_TANH = 2,   // bf16(gelu_tanh(acc + bias))
  EPI_BIAS_BF16_GELU = 3,   // bf16(gelu_erf(bf16(acc + bias)))
  EPI_BIAS_GATED = 4,       // bf16(x + gate[row / S] * (acc + bias))
  EPI_BIAS_BF16_RESID = 5,  // bf16(x + bf16(acc + bias))
  EPI_BF16 = 6,             // bf16(acc)
  EPI_BIAS_GATED_Y = 7,     // EPI_BIAS_GATED; C2 = bf16(acc + bias)
  EPI_BIAS_GELU_TANH_H = 8, // EPI_BIAS_GELU_TANH; C2 = bf16(acc + bias)
  EPI_DGELU = 9,            // u = gelu'(h) * acc, h = aux (bf16 h1):
                            // C = bf16(u), C2 = bf16(gelu(h)), colsum +=
                            // sum over the tile's rows of u
  EPI_ROPE_QKV = 10,        // the qkv product's column thirds: C = q,
                            // C2 = k, C3 = v, each (M, N / 3) bf16, rope
                            // (rope_pair, fp32) on q and k before the one
                            // rounding
  EPI_BIAS_GELU_ERF = 11,   // bf16(gelu_exact(acc + bias))
  EPI_BIAS_GELU_ERF_H = 12, // EPI_BIAS_GELU_ERF; C2 = bf16(acc + bias)
};

// What an epilogue reads and writes besides the accumulators.
struct EpiArgs {
  void* C;
  bf16* C2;
  const bf16* aux;
  float* colsum;  // EPI_DGELU: (row tiles, N), one partial per tile row
  const void* bias;
  int bias_f32;
  const bf16* resid;
  const bf16* gate;
  int gate_stride;
  int S;
  // EPI_ROPE_QKV: the v output, the (slots, hd) fp32 rotary table, and
  // the window (row r sits at slot q_off + (r / S) % n_q)
  bf16* C3;
  const float* freqs;
  int n_q, q_off, hd;
};

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(sqrt(2/pi) *
// (x + 0.044715 * x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  return x * (0.5f * (1.0f + tanhf(0.7978845608028654f *
                                   (x + 0.044715f * (x * x * x)))));
}

// exact (erf) GELU; the TPU kernel approximated erf (A-S 7.1.26, abs err
// <= 1.5e-7), erff is exact to a few ulp
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// jax.nn.gelu(approximate=False) as jax writes it: 0.5 x erfc(-x sqrt(1/2))
// (the DiT MLPs' exact mode, approx_gelu=False)
__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * erfcf(-x * 0.70710678118654752f);
}

// (gelu(h), gelu'(h)) from one tanh, as gtax/kernels/backward.py
// _gelu_tanh_val_grad32
__device__ __forceinline__ float2 gelu_tanh_val_grad(float h) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (h + a * h * h * h));
  const float du = c * (1.0f + 3.0f * a * h * h);
  return make_float2(0.5f * h * (1.0f + t),
                     0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * du);
}

// The NT threads of named barrier 1 (the tile's epilogue threads).
template <int NT>
__device__ __forceinline__ void epi_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// Tile (m0, n0) of BM x BN outputs from c (row stride CS floats), written by
// NT threads, tid in [0, NT). A thread takes eight neighbouring columns of a
// row (16-byte loads and stores; neighbouring threads take neighbouring
// columns), U rows' worth at a time with every global read of the U issued
// before any output is stored, so the reads (aux, the residual, the gate)
// are in flight together instead of one round trip per pair. Rows >= M and
// columns >= N are masked (N is a multiple of 8). `out_off` moves C
// (EPI_F32: the split-K partial of this block); `tile_row` picks the colsum
// row of EPI_DGELU, whose partial adds the tile's rows in order. A tile
// of EPI_ROPE_QKV may span q, k and v: each 8-column group lies in one.
template <int EPI, int BM, int BN, int CS, int NT>
__device__ __forceinline__ void gemm_epilogue(float* c, const EpiArgs& e,
                                              int m0, int n0, int M, int N,
                                              size_t out_off, int tile_row,
                                              int tid) {
  constexpr int G = BN / 8, U = 4;
  static_assert((BM * G) % (NT * U) == 0, "whole batches of units");
  constexpr bool kResid = EPI == EPI_BIAS_GATED ||
                          EPI == EPI_BIAS_GATED_Y ||
                          EPI == EPI_BIAS_BF16_RESID;
  constexpr bool kGate = EPI == EPI_BIAS_GATED || EPI == EPI_BIAS_GATED_Y;
  // EPI_ROPE_QKV: the cos and sin of the angles last used, and their table
  // offset (a thread keeps its columns, so it forms them again only where
  // its row enters another window slot)
  int rope_at = -1;
  float rc[8], rs[8];
  for (int base = tid; base < BM * G; base += NT * U) {
    uint4 xr[U], xg[U];  // aux (gelu') or the residual; the gate
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every read of the batch first
      const int idx = base + u * NT;
      const int gm = m0 + idx / G, gn = n0 + (idx % G) * 8;
      ok[u] = gm < M && gn < N;
      if (!ok[u]) continue;
      const size_t o = (size_t)gm * N + gn;
      if constexpr (EPI == EPI_DGELU) xr[u] = ldg16(e.aux + o);
      if constexpr (kResid) xr[u] = ldg16(e.resid + o);
      if constexpr (kGate)
        xg[u] = ldg16(e.gate + (size_t)(gm / e.S) * e.gate_stride + gn);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NT;
      const int r = idx / G, col = (idx % G) * 8;
      const int gm = m0 + r, gn = n0 + col;
      float4* cr = reinterpret_cast<float4*>(c + (size_t)r * CS + col);
      if (!ok[u]) {
        if constexpr (EPI == EPI_DGELU)
          cr[0] = cr[1] = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const float4 c0 = cr[0], c1 = cr[1];
      const float v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const size_t o = (size_t)gm * N + gn;
      bf16* out = static_cast<bf16*>(e.C);
      if constexpr (EPI == EPI_F32) {
        float4* f = reinterpret_cast<float4*>(static_cast<float*>(e.C) +
                                              out_off + o);
        f[0] = c0;
        f[1] = c1;
      } else if constexpr (EPI == EPI_BF16) {
        *reinterpret_cast<uint4*>(out + o) = pack8(v);
      } else if constexpr (EPI == EPI_ROPE_QKV) {
        const int D = N / 3, third = gn / D, c_d = gn - third * D;
        float z[8];
        if (third < 2) {  // q or k: rope at the row's window slot
          const int at =
              (e.q_off + (gm / e.S) % e.n_q) * e.hd + c_d % e.hd;
          if (at != rope_at) {
            rope_at = at;
            sincos8(e.freqs + at, rc, rs);
          }
#pragma unroll
          for (int i = 0; i < 8; i += 2) {
            const float2 r = rope_pair_cs(make_float2(v[i], v[i + 1]), rc[i],
                                          rs[i], rc[i + 1], rs[i + 1]);
            z[i] = r.x;
            z[i + 1] = r.y;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) z[i] = v[i];
        }
        bf16* dst = third == 0 ? out : third == 1 ? e.C2 : e.C3;
        *reinterpret_cast<uint4*>(dst + (size_t)gm * D + c_d) = pack8(z);
      } else if constexpr (EPI == EPI_DGELU) {
        float h[8], d[8], g[8];
        unpack8(xr[u], h);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 vg = gelu_tanh_val_grad(h[i]);
          d[i] = vg.y * v[i];
          g[i] = vg.x;
        }
        *reinterpret_cast<uint4*>(out + o) = pack8(d);
        *reinterpret_cast<uint4*>(e.C2 + o) = pack8(g);
        cr[0] = make_float4(d[0], d[1], d[2], d[3]);
        cr[1] = make_float4(d[4], d[5], d[6], d[7]);
      } else {  // the bias epilogues
        float y[8], z[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[i] = v[i] + load_bias(e.bias, e.bias_f32, gn + i);
        if constexpr (EPI == EPI_BIAS_BF16) {
          *reinterpret_cast<uint4*>(out + o) = pack8(y);
        } else if constexpr (EPI == EPI_BIAS_GELU_TANH ||
                             EPI == EPI_BIAS_GELU_TANH_H) {
#pragma unroll
          for (int i = 0; i < 8; ++i) z[i] = gelu_tanh(y[i]);
          *reinterpret_cast<uint4*>(out + o) = pack8(z);
          if constexpr (EPI == EPI_BIAS_GELU_TANH_H)
            *reinterpret_cast<uint4*>(e.C2 + o) = pack8(y);
        } else if constexpr (EPI == EPI_BIAS_GELU_ERF ||
                             EPI == EPI_BIAS_GELU_ERF_H) {
#pragma unroll
          for (int i = 0; i < 8; ++i) z[i] = gelu_exact(y[i]);
          *reinterpret_cast<uint4*>(out + o) = pack8(z);
          if constexpr (EPI == EPI_BIAS_GELU_ERF_H)
            *reinterpret_cast<uint4*>(e.C2 + o) = pack8(y);
        } else if constexpr (EPI == EPI_BIAS_BF16_GELU) {
#pragma unroll
          for (int i = 0; i < 8; ++i) z[i] = gelu_erf(bf16_round(y[i]));
          *reinterpret_cast<uint4*>(out + o) = pack8(z);
        } else {  // the residual epilogues
          float x[8];
          unpack8(xr[u], x);
          if constexpr (kGate) {
            float g[8];
            unpack8(xg[u], g);
#pragma unroll
            for (int i = 0; i < 8; ++i) z[i] = x[i] + g[i] * y[i];
            *reinterpret_cast<uint4*>(out + o) = pack8(z);
            if constexpr (EPI == EPI_BIAS_GATED_Y)
              *reinterpret_cast<uint4*>(e.C2 + o) = pack8(y);
          } else {  // EPI_BIAS_BF16_RESID
#pragma unroll
            for (int i = 0; i < 8; ++i) z[i] = x[i] + bf16_round(y[i]);
            *reinterpret_cast<uint4*>(out + o) = pack8(z);
          }
        }
      }
    }
  }
  if constexpr (EPI == EPI_DGELU) {  // the tile's column sums, in row order
    epi_sync<NT>();
    for (int col = tid; col < BN; col += NT) {
      if (n0 + col >= N) continue;
      float acc_c = 0.f;
      for (int r = 0; r < BM; ++r) acc_c += c[(size_t)r * CS + col];
      e.colsum[(size_t)tile_row * N + n0 + col] = acc_c;
    }
  }
}
