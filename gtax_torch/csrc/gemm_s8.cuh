// The int8 weight-streaming tile of the W8A8 GEMMs, as device functions
// shared by gemm_s8.cu (one block per work unit) and the paired int8
// kernels of pair_q.cu (units strided over a cooperative grid). Both run
// it with 256 threads. The int32 sums are exact in any order and every
// output folds its K groups in order in one thread, so both callers give
// bit-equal results. See gemm_s8.cu for the arithmetic.
//
// Design (the serving rows: M = 144-288, K, N = 1024-4096; bound by the
// int8 weight bytes):
//   - a work unit is (row tile, 64-column tile, K chunk). A row tile holds
//     every row up to 320 (five m64 slabs; warpgroup w takes slabs w,
//     w + 2, w + 4), so each weight byte leaves HBM once; K is split into
//     chunks so that every block has a unit (split K);
//   - int8 operands arrive by TMA (cp.async.bulk.tensor) into a ring of
//     up to kMaxStages stages (as many as kRingBytes holds at the unit's
//     slab count: five at 144 rows, three at 288), 128-byte swizzled, one
//     128-byte k-step a stage; thread 0 keeps the ring full, and a stage's
//     full mbarrier reports its bytes;
//   - the int8 tensor cores: wgmma m64n64k32 .s32.s8.s8, which reads both
//     operands K-major. The activations are (M, K) row-major; the weights
//     are read as W^T, (N, K) row-major: the (in, out) kernel stored
//     column-major, a copy made once when the params are prepared for the
//     card (gtax_torch/kernels/quant.py quantize_weight);
//   - one chunk: the epilogue runs from the accumulators. Several (the
//     grid is cooperative): each unit stores its int32 partial, a grid
//     barrier follows, and then every block takes 16-row slices of the
//     output, adds each K group's partials, folds the groups' sums into
//     fp32 in group order (chunks never cross a group) and runs the
//     epilogue. No float atomics: a run is bit-equal to the next.
#pragma once

#include <cooperative_groups.h>

#include "gemm_sm90.cuh"

namespace gemm_s8 {

constexpr int BN = 64;          // output columns of a unit
constexpr int BK = 128;         // int8 k-step: one 128-byte swizzle span
constexpr int kSlabs = 5;       // m64 row slabs of a unit
constexpr int kRows = 64 * kSlabs;
constexpr int kSlabBytes = 64 * BK;  // 8 KB
static_assert(BN * BK == kSlabBytes, "a stage: A slabs, then one B slab");
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;   // K chunks of a GEMM (and K groups)
// 160 KB: five stages at 144 rows, three at 288, and an L1 of 92 KB for
// the pair's other phases (the shared memory carve-out takes the rest)
constexpr int kRingBytes = 160 * 1024;
constexpr int kThreads = 256;
// the ring and its barriers, from a 1024-aligned base
constexpr size_t kSmemBytes = kRingBytes + kMaxStages * 8;
constexpr int kSliceRows = 16;  // rows of a slice of the split sum

enum Epi {
  EPI_F32 = 0,                // fp32 C = y
  EPI_BIAS_GELU_F32 = 1,      // fp32 C = gelu_tanh(y + bias)
  EPI_BIAS_GATED = 2,         // bf16 C = x + gate[row / S] * (y + bias)
  EPI_BIAS_GELU_ERF_F32 = 3,  // fp32 C = gelu_exact(y + bias)
  EPI_BIAS_GATED_F32 = 4,     // fp32 C = x + gate[row / S] * (y + bias)
  // the fp32 int8 branches' emit_train forms (int8-forward training at
  // x.dtype = float32): 1, 3 and 4 with fp32 C2 = y + bias, each an
  // instantiation of its own
  EPI_BIAS_GELU_F32_H = 5,
  EPI_BIAS_GELU_ERF_F32_H = 6,
  EPI_BIAS_GATED_F32_Y = 7,
  // the fp32 spatial pair's qkv product: EPI_F32 with q and k (the first
  // two thirds of the columns) roped, each pair of columns by its rope
  // factors (Args::rope), as attn_frame_f32's rope pass ropes them
  EPI_F32_ROPE = 8,
};  // 1, 2 and 3 also store bf16(y + bias) to C2 when it is set

// the epilogues whose second output is fp32
template <int EPI>
__host__ __device__ constexpr bool c2_f32() {
  return EPI == EPI_BIAS_GELU_F32_H || EPI == EPI_BIAS_GELU_ERF_F32_H ||
         EPI == EPI_BIAS_GATED_F32_Y;
}

// C = epilogue(dequant(A @ B)): A (M, K) int8 with fp32 scales sa (M,
// n_groups), K groups of `group`; B (K, N) int8 read as W^T through its
// tensor map, fp32 column scales ws; bias (N,) fp32 or bf16; resid (M, N)
// and gate per-frame rows of gate_stride, frame = row / S, both bf16 (both
// fp32 for EPI_BIAS_GATED_F32, whose C is fp32 too: nothing rounded).
// Split K: at most kMaxSplits chunks of k_chunk (a multiple of BK; a
// divisor of `group` when there is more than one group), part (splits, M,
// N) int32 partials.
struct Args {
  void* C;
  const float* sa;
  int n_groups, group;
  const float* ws;
  const void* bias;
  int bias_f32;
  const void* resid;
  const void* gate;
  int gate_stride;
  int M, N, K, S;
  int k_chunk;
  int* part;
#ifdef GTAX_PAIR_PROBE
  // the probe copy of pair_q (csrc/pair_q.cuh): kUnitStamps clock stamps of
  // the block's last unit of the GEMM, at this block's row
  unsigned long long* stamps;
#endif
  // epilogues 1 and 2 with a second output (int8-forward training's
  // residuals): (M, N) bf16 of y + bias, the value before the GELU or the
  // gate, rounded once; null otherwise (the pairs never set it); (M, N)
  // fp32 for epilogues 5-7
  bf16* C2;
  // EPI_F32_ROPE: (S, rope_hd / 2) rope factors (cos, sin of a pair's two
  // angles), row gm % S; a head's rope_hd columns roped whole
  const float4* rope;
  int rope_hd;
};

#ifdef GTAX_PAIR_PROBE
// a unit's start, the end of its main loop, the end of its partial's store
// (or its epilogue), the end of the block's slices of the split sum
constexpr int kUnitStamps = 4;
__device__ __forceinline__ void unit_stamp(const Args& p, int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
}
#else
__device__ __forceinline__ void unit_stamp(const Args&, int) {}
#endif

__host__ __device__ inline int m_tiles(int M) { return (M + kRows - 1) / kRows; }
__host__ __device__ inline int n_tiles(int N) { return N / BN; }
__host__ __device__ inline int splits(int K, int k_chunk) {
  return (K + k_chunk - 1) / k_chunk;
}
__host__ __device__ inline int units(int M, int N, int K, int k_chunk) {
  return m_tiles(M) * n_tiles(N) * splits(K, k_chunk);
}

// The Args a call can take: N and K in whole tiles and steps, chunks in
// whole steps that stay inside one K group.
inline bool valid(const Args& p) {
  return p.M > 0 && p.N > 0 && p.K > 0 && p.N % BN == 0 && p.K % BK == 0 &&
         p.group > 0 && p.K % p.group == 0 && p.n_groups == p.K / p.group &&
         p.k_chunk > 0 && p.k_chunk % BK == 0 &&
         (p.n_groups == 1 || p.group % p.k_chunk == 0) &&
         splits(p.K, p.k_chunk) <= kMaxSplits &&
         (splits(p.K, p.k_chunk) == 1 || p.part != nullptr);
}

// The block's ring: stages from a 1024-aligned base, then kMaxStages full
// mbarriers. phase: bit s = the parity stage s waits for next (the same in
// every thread).
struct Ring {
  unsigned char* data;
  uint64_t* full;
  uint32_t phase;
};

// Initialise the ring at smem (1024-aligned, kSmemBytes) by the whole
// block; ends with a __syncthreads().
__device__ __forceinline__ Ring ring_init(unsigned char* smem) {
  Ring r{smem, reinterpret_cast<uint64_t*>(smem + kRingBytes), 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) sm90::mbar_init(&r.full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// d (64 rows x 64 cols of this warpgroup, int32) += A (64 x 32) B (32 x 64),
// both K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
#define GTAX_R8(i)                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : GTAX_R8(0), GTAX_R8(8), GTAX_R8(16), GTAX_R8(24)
      : "l"(da), "l"(db), "r"(1));
#undef GTAX_R8
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// jax.nn.gelu(approximate=True), each op rounded once as the plain version
// computes it
__device__ __forceinline__ float gelu_tanh_rn(float h) {
  const float h3 = __fmul_rn(__fmul_rn(h, h), h);
  const float inner = __fmul_rn(0.7978845608028654f,
                                __fadd_rn(h, __fmul_rn(0.044715f, h3)));
  return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// jax.nn.gelu(approximate=False), 0.5 h erfc(-h sqrt(1/2)), each op
// rounded once as the plain version computes it
__device__ __forceinline__ float gelu_exact_rn(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h),
                   erfcf(__fmul_rn(-h, 0.70710678118654752f)));
}

// EPI_F32_ROPE: the rope factors of output pair (gm, gn) (zero past the q
// and k columns, which it leaves as they are)
template <int EPI>
__device__ __forceinline__ float4 rope_factor(const Args& p, int gm, int gn) {
  if (EPI != EPI_F32_ROPE || gn >= p.N / 3 * 2)
    return make_float4(0.f, 0.f, 0.f, 0.f);
  return p.rope[(size_t)(gm % p.S) * (p.rope_hd / 2) + gn % p.rope_hd / 2];
}

// What the epilogue of output pair (gm, gn), (gm, gn + 1) reads besides
// its sums: the column scales, and (past EPI_F32) the bias and the gated
// residual's x and gate.
struct EpiIn {
  float2 ws, b, x, g;
};

// a float of the kernel's read-only inputs; NC: through the non-coherent
// path, which lets the compiler move the load across the epilogue's
// stores (only for inputs no block of the launch writes)
template <bool NC>
__device__ __forceinline__ float ld_in(const float* a) {
  if constexpr (NC)
    return __ldg(a);
  else
    return *a;
}
template <bool NC>
__device__ __forceinline__ float ld_in(const bf16* a) {
  if constexpr (NC)
    return bf2f(__ldg(a));
  else
    return bf2f(*a);
}
// two neighbouring elements of a row (8- or 4-byte aligned)
template <bool NC>
__device__ __forceinline__ float2 ld2_in(const float* a) {
  const float2* v = reinterpret_cast<const float2*>(a);
  if constexpr (NC)
    return __ldg(v);
  else
    return *v;
}
template <bool NC>
__device__ __forceinline__ float2 ld2_in(const bf16* a) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(a);
  if constexpr (NC)
    return __bfloat1622float2(__ldg(v));
  else
    return __bfloat1622float2(*v);
}

template <int EPI, bool NC = false>
__device__ __forceinline__ EpiIn epi_load(const Args& p, int gm, int gn) {
  EpiIn in{};
  in.ws = make_float2(ld_in<NC>(p.ws + gn), ld_in<NC>(p.ws + gn + 1));
  if (EPI == EPI_F32 || EPI == EPI_F32_ROPE) return in;
  in.b = p.bias_f32
             ? make_float2(ld_in<NC>(static_cast<const float*>(p.bias) + gn),
                           ld_in<NC>(static_cast<const float*>(p.bias) + gn +
                                     1))
             : make_float2(ld_in<NC>(static_cast<const bf16*>(p.bias) + gn),
                           ld_in<NC>(static_cast<const bf16*>(p.bias) + gn +
                                     1));
  const size_t o = (size_t)gm * p.N + gn;
  const size_t gi = (size_t)(gm / p.S) * p.gate_stride + gn;
  if (EPI == EPI_BIAS_GATED_F32 || EPI == EPI_BIAS_GATED_F32_Y) {
    const float* gate = static_cast<const float*>(p.gate) + gi;
    in.x = ld2_in<NC>(static_cast<const float*>(p.resid) + o);
    in.g = make_float2(ld_in<NC>(gate), ld_in<NC>(gate + 1));
  } else if (EPI == EPI_BIAS_GATED) {
    const bf16* gate = static_cast<const bf16*>(p.gate) + gi;
    in.x = ld2_in<NC>(static_cast<const bf16*>(p.resid) + o);
    in.g = make_float2(ld_in<NC>(gate), ld_in<NC>(gate + 1));
  }
  return in;
}

// Output pair (gm, gn), (gm, gn + 1) from its folded fp32 sums and its
// inputs (epi_load): y = acc * ws[col], then the epilogue, each op rounded
// once (rf: EPI_F32_ROPE's rope_factor of the pair, loaded by the caller).
template <int EPI>
__device__ __forceinline__ void epi_store(const Args& p, int gm, int gn,
                                          float f0, float f1,
                                          const EpiIn& in, float4 rf = {}) {
  const float y0 = __fmul_rn(f0, in.ws.x);
  const float y1 = __fmul_rn(f1, in.ws.y);
  const size_t o = (size_t)gm * p.N + gn;
  if (EPI == EPI_F32 || EPI == EPI_F32_ROPE) {
    float2 y = make_float2(y0, y1);
    if (EPI == EPI_F32_ROPE && gn < p.N / 3 * 2)
      y = rope_pair_fma(y, rf);
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) = y;
    return;
  }
  const float u0 = __fadd_rn(y0, in.b.x);
  const float u1 = __fadd_rn(y1, in.b.y);
  if constexpr (c2_f32<EPI>())
    store_pair(reinterpret_cast<float*>(p.C2), o, u0, u1);
  else if (p.C2 != nullptr)
    store_pair(p.C2, o, u0, u1);
  if (EPI == EPI_BIAS_GELU_F32 || EPI == EPI_BIAS_GELU_F32_H) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) =
        make_float2(gelu_tanh_rn(u0), gelu_tanh_rn(u1));
  } else if (EPI == EPI_BIAS_GELU_ERF_F32 || EPI == EPI_BIAS_GELU_ERF_F32_H) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) =
        make_float2(gelu_exact_rn(u0), gelu_exact_rn(u1));
  } else if (EPI == EPI_BIAS_GATED_F32 || EPI == EPI_BIAS_GATED_F32_Y) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) =
        make_float2(__fadd_rn(in.x.x, __fmul_rn(in.g.x, u0)),
                    __fadd_rn(in.x.y, __fmul_rn(in.g.y, u1)));
  } else {
    store_pair(static_cast<bf16*>(p.C), o,
               __fadd_rn(in.x.x, __fmul_rn(in.g.x, u0)),
               __fadd_rn(in.x.y, __fmul_rn(in.g.y, u1)));
  }
}

// Output pair (gm, gn), (gm, gn + 1) from its folded fp32 sums: its
// inputs, then the epilogue.
template <int EPI>
__device__ __forceinline__ void store_out(const Args& p, int gm, int gn,
                                          float f0, float f1,
                                          float4 rf = {}) {
  epi_store<EPI>(p, gm, gn, f0, f1, epi_load<EPI>(p, gm, gn), rf);
}

// Work unit u of the GEMM: tile u / splits (row tile major), K chunk
// u % splits. ma: A (M, K) int8 and mb: W^T (N, K) int8, boxes of 64 rows
// x 128 bytes. Every thread of the 256 calls it.
template <int EPI>
__device__ __forceinline__ void unit(Ring& r, const CUtensorMap* ma,
                                     const CUtensorMap* mb, const Args& p,
                                     int u) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int nsplit = splits(p.K, p.k_chunk), nt_count = n_tiles(p.N);
  const int z = u % nsplit, t = u / nsplit;
  const int m0 = t / nt_count * kRows, n0 = t % nt_count * BN;
  const int slabs = (min(kRows, p.M - m0) + 63) / 64;
  const int k_begin = z * p.k_chunk;
  const int KT = (min(p.K, k_begin + p.k_chunk) - k_begin) / BK;
  const int stage_bytes = (slabs + 1) * kSlabBytes;  // A slabs, then B
  const int stages = min(kMaxStages, kRingBytes / stage_bytes);

  // the block's last use of the ring's memory (another phase's buffers,
  // the previous unit), and the rows other blocks wrote before a grid
  // barrier, come before the copies
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  auto issue = [&](int kt) {  // stage kt % stages: its A slabs, B tile
    const int s = kt % stages;
    unsigned char* a = r.data + s * stage_bytes;
    const int k = k_begin + kt * BK;
    sm90::mbar_expect_tx(&r.full[s], stage_bytes);
    for (int j = 0; j < slabs; ++j)
      sm90::tma_load(a + j * kSlabBytes, ma, &r.full[s], k, m0 + 64 * j);
    sm90::tma_load(a + slabs * kSlabBytes, mb, &r.full[s], k, n0);
  };
  if (tid == 0)
    for (int kt = 0; kt < min(stages, KT); ++kt) issue(kt);
  unit_stamp(p, 0);

  constexpr int J = (kSlabs + 1) / 2;  // slabs a warpgroup
  int d[J][32];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[j][i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % stages;
    sm90::mbar_wait(&r.full[s], (r.phase >> s) & 1);
    r.phase ^= 1u << s;
    const uint32_t a = sm90::smem_u32(r.data + s * stage_bytes);
    const uint32_t b = a + slabs * kSlabBytes;
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(d[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const uint64_t db = sm90::desc_sw128(b + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int slab = wg + 2 * j;
        if (slab < slabs)  // uniform across the warpgroup
          wgmma_s8(d[j],
                   sm90::desc_sw128(a + slab * kSlabBytes + kk * 32, 16, 1024),
                   db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(d[j]);
    __syncthreads();  // every warpgroup is done with stage s: refill it
    if (tid == 0 && kt + stages < KT) issue(kt + stages);
  }

  unit_stamp(p, 1);
  // the accumulators' rows and column pairs: fragment (j, q, h) is row
  // slab * 64 + 16 * warp + lane / 4 + 8 h, columns 8 q + 2 (lane % 4) + 0/1
  const int warp = (tid & 127) >> 5;
  if (nsplit == 1) {  // one group: fold, dequantize and store from here
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int slab = wg + 2 * j;
      if (slab >= slabs) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + slab * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if (gm >= p.M) continue;
        const float sa = p.sa[gm];
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int gn = n0 + q * 8 + (lane & 3) * 2;
          store_out<EPI>(
              p, gm, gn,
              __fadd_rn(0.f, __fmul_rn(__int2float_rn(d[j][4 * q + 2 * h]), sa)),
              __fadd_rn(0.f,
                        __fmul_rn(__int2float_rn(d[j][4 * q + 2 * h + 1]), sa)),
              rope_factor<EPI>(p, gm, gn));
        }
      }
    }
    unit_stamp(p, 2);
    return;
  }
  // this chunk's int32 partial out, for the slices' sum after the barrier
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int slab = wg + 2 * j;
    if (slab >= slabs) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + slab * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if (gm >= p.M) continue;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int gn = n0 + q * 8 + (lane & 3) * 2;
        *reinterpret_cast<int2*>(p.part + ((size_t)z * p.M + gm) * p.N + gn) =
            make_int2(d[j][4 * q + 2 * h], d[j][4 * q + 2 * h + 1]);
      }
    }
  }
  unit_stamp(p, 2);
}

// Slice v of the split sum: rows [16 (v / tiles), ...) of column tile
// v % tiles. A thread takes four columns of a row: it loads every chunk's
// partial and every group's scale first (the reads from L2 overlap), adds
// each K group's chunks (exact), folds the groups' sums into fp32 in group
// order, and runs the epilogue.
template <int EPI>
__device__ __forceinline__ void slice(const Args& p, int v) {
  constexpr int Q = BN / 4;  // items a row of a tile
  static_assert(kSliceRows * Q == kThreads, "one item a thread");
  const int nsplit = splits(p.K, p.k_chunk), tiles = n_tiles(p.N);
  const int gm = v / tiles * kSliceRows + threadIdx.x / Q;
  const int gn = v % tiles * BN + (threadIdx.x % Q) * 4;
  if (gm >= p.M) return;
  // the rope factors first, so their reads overlap the partials'
  const float4 rf0 = rope_factor<EPI>(p, gm, gn);
  const float4 rf1 = rope_factor<EPI>(p, gm, gn + 2);
  const int4* src =
      reinterpret_cast<const int4*>(p.part + (size_t)gm * p.N + gn);
  const size_t zstride = (size_t)p.M * p.N / 4;  // int4s a partial
  int4 pv[kMaxSplits];
  float sa[kMaxSplits];
#pragma unroll
  for (int zz = 0; zz < kMaxSplits; ++zz) {
    if (zz < nsplit) pv[zz] = __ldcg(src + zz * zstride);
    if (zz < p.n_groups) sa[zz] = p.sa[(size_t)gm * p.n_groups + zz];
  }
  const int per_group = p.n_groups == 1 ? nsplit : p.group / p.k_chunk;
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  int acc[4] = {0, 0, 0, 0};
  int g = 0;
#pragma unroll
  for (int zz = 0; zz < kMaxSplits; ++zz) {
    if (zz >= nsplit) break;
    acc[0] += pv[zz].x;
    acc[1] += pv[zz].y;
    acc[2] += pv[zz].z;
    acc[3] += pv[zz].w;
    if ((zz + 1) % per_group == 0) {
      float s = sa[0];  // group g's scale, kept in registers
#pragma unroll
      for (int gg = 1; gg < kMaxSplits; ++gg)
        if (gg == g) s = sa[gg];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        f[c] = __fadd_rn(f[c], __fmul_rn(__int2float_rn(acc[c]), s));
        acc[c] = 0;
      }
      ++g;
    }
  }
  store_out<EPI>(p, gm, gn, f[0], f[1], rf0);
  store_out<EPI>(p, gm, gn + 2, f[2], f[3], rf1);
}

// The whole GEMM on a cooperative grid: its units strided over the blocks,
// then, with more than one chunk, a grid barrier and the split sum's
// slices strided over the blocks. Every thread of the grid calls it.
template <int EPI>
__device__ __forceinline__ void gemm(Ring& r, const CUtensorMap* ma,
                                     const CUtensorMap* mb, const Args& p) {
  const int n = units(p.M, p.N, p.K, p.k_chunk);
  for (int u = blockIdx.x; u < n; u += gridDim.x) unit<EPI>(r, ma, mb, p, u);
  const int nsplit = splits(p.K, p.k_chunk);
  if (nsplit == 1) {
    unit_stamp(p, 3);
    return;
  }
  cooperative_groups::this_grid().sync();
  const int slices = (p.M + kSliceRows - 1) / kSliceRows * n_tiles(p.N);
  for (int v = blockIdx.x; v < slices; v += gridDim.x) slice<EPI>(p, v);
  unit_stamp(p, 3);
}

}  // namespace gemm_s8
