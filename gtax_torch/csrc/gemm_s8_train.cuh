// The int8 tensor-core GEMM of the W8A8 branches at training rows: the
// products of int8-forward training (B=16: 11,520 rows) and of any call
// from quant.S8_TRAIN_ROWS rows. It computes what gtax_gemm_s8 computes
// for the same arguments, C = epilogue(dequant(A @ B)), through the same
// store_out<EPI> epilogues 0-7 (gemm_s8.cuh), bit for bit: the int32 sums
// are exact in any order, and each output folds its K groups into fp32 in
// group order, f = f + float(acc_g) * sa[row, g] from 0, as the streaming
// tile and its split sum do.
//
// Replaces, at training rows, the int8 dots of the TPU int8 branch
// kernels (gtax/kernels/quant.py _qdot in _spatial_kernel_q and
// _temporal_kernel_q; the fc1 and per-H-chunk fc2 dots of _mlp_kernel_q,
// and its _quant_rows of the GELU output, which the fc1 form fuses).
// Bound: int8 tensor-core operations (fc1 at 11,520 rows: 96.6 GOP, 0.049
// ms at 1,979 TOP/s); the weight-streaming tile (gemm_s8.cuh, 320 rows x
// 64 columns) re-reads every A row tile for each 64-column tile there and
// stores an int32 partial a K chunk.
//
// Design (for M of a few thousand rows and more):
//   - persistent and warp-specialized: a block an SM walks output tiles
//     (row tile major, so the blocks at work share A's row tiles in L2);
//     warpgroup 2 is the TMA producer (setmaxnreg.dec), warpgroups 0-1
//     the consumers (setmaxnreg.inc), 64 rows each; a stage's full and
//     empty mbarriers, one wgmma group in flight, so the producer fills
//     the next tile's stages while the consumers run this one's epilogue;
//   - a 128-byte k-step (128 int8 of K), both operands K-major and
//     128-byte swizzled: A (M, K) row-major, W^T (N, K) row-major, the
//     (in, out) kernel in card_layout (gtax_torch/kernels/quant.py);
//   - one K group (qkv, out, fc1): 128 x 256 tiles (wgmma m64n256k32
//     .s32.s8.s8, 128 int32 sums a consumer thread), four 48 KB stages.
//     Several (fc2's eight of 512): 128 x 128 tiles (64 int32 sums and 64
//     fp32 folds a thread), six 32 KB stages; at each group's last k-step
//     the consumers wait for its wgmmas, fold the sums into fp32 with the
//     row's scale, and the group's next wgmma starts from zero (scale-d
//     0). No split K and no int32 partial: at training rows there are
//     hundreds of tiles;
//   - the epilogue loads a few pairs' inputs (column scales, bias, the
//     gated residual's x and gate) through the non-coherent path before
//     their stores, so that their latencies overlap (gemm_s8.cuh epi_load
//     / epi_store, the arithmetic of store_out);
//   - fc1 with the requantization of its GELU rows (quant_rows_unit's
//     arithmetic: a 512-column group's exact abs-max, int8_scale,
//     __fdiv_rn(1, s), int8_round of each value alone): a cluster of two
//     128 x 256 blocks takes a 128 x 512 pair of tiles; each block reduces
//     its rows' abs-max over its 256 columns, writes them into the other
//     block's shared memory and arrives on its mbarrier (release, cluster
//     scope), so each block holds the group's maxima; it stores h1 = y + b
//     (emit_train), hq (int8) and hs (a scale a row and group), never the
//     fp32 GELU rows.
#pragma once

#include <algorithm>

#include "gemm_s8.cuh"

namespace s8t {

using gemm_s8::Args;

constexpr int BM = 128;         // output rows of a tile: an m64 slab a
                                // consumer warpgroup
constexpr int BK = 128;         // int8 k-step: one 128-byte swizzle span
constexpr int kConsumers = 2;
// the consumer warpgroups and a producer warpgroup, which hands them its
// registers (setmaxnreg: 232 a consumer thread)
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kQGroup = 512;    // fc1's requantization group (H / 8)
constexpr int kRingBytes = 192 * 1024;

template <int TBN>
struct Tile {
  static constexpr int kABytes = BM * BK;
  static constexpr int kStageBytes = kABytes + TBN * BK;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 4 or 6
  static constexpr int kAcc = TBN / 2;  // int32 sums a consumer thread
  // the ring, then full[kStages], empty[kStages], xbar[2] and xmax[2][2][BM]
  static constexpr size_t kBars = (size_t)kStages * kStageBytes;
  static constexpr size_t kSmemBytes =
      1024 + kBars + (2 * kStages + 2) * sizeof(uint64_t) + 2 * 2 * BM * 4;
  static_assert(TBN == 128 || TBN == 256, "m64n128 or m64n256");
};

// fc1's requantized outputs: hq (M, N) int8, hs (M, N / kQGroup) fp32
struct Quant {
  signed char* q;
  float* scale;
};

#define GTAX_R8(i)                                                         \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 rows x 256 cols of this warpgroup, int32) = A (64 x 32) B (32 x
// 256) + (scale_d ? d : 0), both K-major
__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : GTAX_R8(0), GTAX_R8(8), GTAX_R8(16), GTAX_R8(24),
        GTAX_R8(32), GTAX_R8(40), GTAX_R8(48), GTAX_R8(56),
        GTAX_R8(64), GTAX_R8(72), GTAX_R8(80), GTAX_R8(88),
        GTAX_R8(96), GTAX_R8(104), GTAX_R8(112), GTAX_R8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 rows x 128 cols of this warpgroup, int32) = A (64 x 32) B (32 x
// 128) + (scale_d ? d : 0), both K-major
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n}\n"
      : GTAX_R8(0), GTAX_R8(8), GTAX_R8(16), GTAX_R8(24),
        GTAX_R8(32), GTAX_R8(40), GTAX_R8(48), GTAX_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef GTAX_R8

template <int TBN>
__device__ __forceinline__ void wgmma(int (&d)[TBN / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  if constexpr (TBN == 256)
    wgmma_n256(d, da, db, scale_d);
  else
    wgmma_n128(d, da, db, scale_d);
}

// ---------------------------------------------- the cluster's exchange

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

// Every thread of the cluster's blocks; orders the shared-memory writes
// before it (release) before the reads after it (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of this block's `p`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// Arrive on a barrier in another block's shared memory, releasing this
// thread's writes before it at cluster scope.
__device__ __forceinline__ void arrive_peer(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// Wait for the phase of parity `parity` of a barrier in this block's
// shared memory (acquire; at cluster scope for what the other block of a
// cluster released). A wait that spins past kSpins polls (seconds) traps,
// a launch error, rather than holding the card.
constexpr long long kSpins = 1ll << 28;
template <bool kCluster = false>
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = sm90::smem_u32(bar);
  uint32_t done = 0;
  for (long long i = 0; !done; ++i) {
    if (i == kSpins) __trap();
    if constexpr (kCluster)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
  }
}

// ------------------------------------------------------------ epilogues

// fc1's epilogue up to the GELU, as epi_store<EPI> computes it from the
// pair's inputs (epi_load): y = f * ws[col], u = y + bias, C2 = u (bf16,
// or fp32 for epilogues 5 and 6) when set and `store`; returns gelu(u) of
// the pair (gm, gn), (gm, gn + 1).
template <int EPI>
__device__ __forceinline__ float2 gelu_pair(const Args& p, int gm, int gn,
                                            float f0, float f1,
                                            const gemm_s8::EpiIn& in,
                                            bool store) {
  const float y0 = __fmul_rn(f0, in.ws.x);
  const float y1 = __fmul_rn(f1, in.ws.y);
  const float u0 = __fadd_rn(y0, in.b.x);
  const float u1 = __fadd_rn(y1, in.b.y);
  if (store) {
    const size_t o = (size_t)gm * p.N + gn;
    if constexpr (gemm_s8::c2_f32<EPI>())
      store_pair(reinterpret_cast<float*>(p.C2), o, u0, u1);
    else if (p.C2 != nullptr)
      store_pair(p.C2, o, u0, u1);
  }
  if constexpr (EPI == gemm_s8::EPI_BIAS_GELU_F32 ||
                EPI == gemm_s8::EPI_BIAS_GELU_F32_H)
    return make_float2(gemm_s8::gelu_tanh_rn(u0), gemm_s8::gelu_tanh_rn(u1));
  else
    return make_float2(gemm_s8::gelu_exact_rn(u0),
                       gemm_s8::gelu_exact_rn(u1));
}

// The consumer warpgroups alone (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
}

// Where a thread's sums lie: fragment (q, h, e) at row m0 + r0 + 8 h,
// column n0 + 8 q + 2 (lane % 4) + e; element 4 q + 2 h + e. With the
// requantization: the tile's walk index (its exchange slot) and its rows'
// maxima, then their reciprocal scales.
struct Frag {
  int m0, n0, ut, r0, lane;
  float mx[2], inv[2];
  __device__ int gm(int h) const { return m0 + r0 + 8 * h; }
  __device__ int gn(int q) const { return n0 + q * 8 + (lane & 3) * 2; }
};

// Pairs q in [q0, q0 + NQ) of a thread's two rows through epi_store<EPI>:
// their inputs first (non-coherent loads, which may pass the stores, so
// their latencies overlap), then the stores; v(i, h): the folded sum of
// element i.
template <int EPI, int NQ, class V>
__device__ __forceinline__ void store_pairs(const Args& p, const Frag& t,
                                            int q0, V v) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = t.gm(h);
    if (gm >= p.M) continue;
    gemm_s8::EpiIn in[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      in[j] = gemm_s8::epi_load<EPI, true>(p, gm, t.gn(q0 + j));
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int i = 4 * (q0 + j) + 2 * h;
      gemm_s8::epi_store<EPI>(p, gm, t.gn(q0 + j), v(i, h), v(i + 1, h),
                              in[j]);
    }
  }
}

// The requantization's first half for pairs q in [q0, q0 + NQ): gelu(u)
// (storing u to C2) handed to put(i, value), and the rows' abs-max in
// t.mx (from 0 when q0 is 0).
template <int EPI, int NQ, class V, class Put>
__device__ __forceinline__ void gelu_pairs(const Args& p, Frag& t, int q0,
                                           V v, Put put) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = t.gm(h);
    float m = q0 == 0 ? 0.f : t.mx[h];
    gemm_s8::EpiIn in[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      in[j] = gemm_s8::epi_load<EPI, true>(p, gm, t.gn(q0 + j));
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int i = 4 * (q0 + j) + 2 * h;
      const float2 g = gelu_pair<EPI>(p, gm, t.gn(q0 + j), v(i, h),
                                      v(i + 1, h), in[j], gm < p.M);
      put(i, g.x);
      put(i + 1, g.y);
      m = fmaxf(m, fmaxf(fabsf(g.x), fabsf(g.y)));
    }
    t.mx[h] = m;
  }
}

// The rows' maxima over this block's columns (the quad's lanes hold a
// row's), written into the other P - 1 blocks' shared memory, slot ut % 2,
// at this block's rank, then an arrival on their barrier of the slot.
template <int P>
__device__ __forceinline__ void send_max(Frag& t, int rank, float* xmax,
                                         uint64_t* xbar) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    t.mx[h] = fmaxf(t.mx[h], __shfl_xor_sync(0xffffffffu, t.mx[h], 1));
    t.mx[h] = fmaxf(t.mx[h], __shfl_xor_sync(0xffffffffu, t.mx[h], 2));
  }
  if ((t.lane & 3) != 0) return;
  float* mine = xmax + ((t.ut & 1) * P + rank) * BM + t.r0;
#pragma unroll
  for (int peer = 0; peer < P; ++peer) {
    if (peer == rank) continue;
    st_peer(peer_addr(mine, peer), t.mx[0]);
    st_peer(peer_addr(mine + 8, peer), t.mx[1]);
    arrive_peer(peer_addr(&xbar[t.ut & 1], peer));
  }
}

// The others' maxima: the group's, its scales (hs, by rank 0) and their
// reciprocals in t.inv. Every consumer reads the slot before any of this
// block's writers sends the next tile's maxima (after which the others
// may write the slot again, for the tile after that).
template <int P>
__device__ __forceinline__ void take_max(const Args& p, const Quant& qo,
                                         Frag& t, int rank, float* xmax,
                                         uint64_t* xbar) {
  bar_wait<true>(&xbar[t.ut & 1], (t.ut >> 1) & 1);
  const float* slot = xmax + (t.ut & 1) * P * BM + t.r0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = t.mx[h];
#pragma unroll
    for (int peer = 0; peer < P; ++peer)
      if (peer != rank) m = fmaxf(m, slot[peer * BM + 8 * h]);
    const float sc = int8_scale(m);
    t.inv[h] = __fdiv_rn(1.0f, sc);
    if (rank == 0 && (t.lane & 3) == 0 && t.gm(h) < p.M)
      qo.scale[(size_t)t.gm(h) * (p.N / kQGroup) + t.n0 / kQGroup] = sc;
  }
  consumers_sync();
}

// The requantization's second half for pairs q in [q0, q0 + NQ): each
// gelu value g(i) rounded alone to int8 by its row's reciprocal scale.
template <int NQ, class G>
__device__ __forceinline__ void quant_pairs(const Args& p, const Quant& qo,
                                            const Frag& t, int q0, G g) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = t.gm(h);
    if (gm >= p.M) continue;
    signed char* row = qo.q + (size_t)gm * p.N;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int i = 4 * (q0 + j) + 2 * h;
      *reinterpret_cast<char2*>(row + t.gn(q0 + j)) = make_char2(
          int8_round(g(i), t.inv[h]), int8_round(g(i + 1), t.inv[h]));
    }
  }
}

// The kernel. TBN 256 (one K group; P 2: the requantization, a cluster of
// two blocks across 512 columns): each tile's one group folded, dequantized
// and stored after its main loop. TBN 128 (any K groups): each group
// folded into fp32 at its last k-step, then the epilogue.
template <int EPI, int TBN, int P>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_s8_train_kernel(const __grid_constant__ CUtensorMap ma,
                         const __grid_constant__ CUtensorMap mb,
                         const Args p, const Quant qo) {
  using T = Tile<TBN>;
  constexpr int R = T::kAcc;
  constexpr bool kWide = TBN == 256;
  static_assert(P == 1 || (kWide && P * TBN == kQGroup),
                "the requantization: one K group, a cluster across 512");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBars);
  uint64_t* empty = full + T::kStages;
  uint64_t* xbar = empty + T::kStages;  // the other's maxima have arrived
  float* xmax = reinterpret_cast<float*>(xbar + 2);  // [2][P][BM]
  const int tid = threadIdx.x;
  const int n_tiles = p.N / TBN, m_tiles = (p.M + BM - 1) / BM;
  const int KT = p.K / BK, gsteps = p.group / BK;
  // cluster c walks the 128 x (P TBN) groups of tiles c, c + clusters, ...;
  // its block of rank r takes column tile P j + r of group (i, j)
  const int rank = P > 1 ? cluster_rank() : 0;
  const int first = blockIdx.x / P, stride = gridDim.x / P;
  const int per_row = n_tiles / P, units = m_tiles * per_row;

  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * kConsumers);
    }
    // the other's 64 writer threads (a row pair each) arrive once a tile
    for (int s = 0; s < 2; ++s)
      sm90::mbar_init(&xbar[s], P > 1 ? 64 * (P - 1) : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (P > 1) cluster_sync();  // the other's barriers exist before use

  if (tid >= 128 * kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      int it = 0;
      for (int u = first; u < units; u += stride) {
        const int m0 = u / per_row * BM;
        const int n0 = (P * (u % per_row) + rank) * TBN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % T::kStages;
          if (it >= T::kStages)
            bar_wait(&empty[s], ((it / T::kStages) - 1) & 1);
          sm90::mbar_expect_tx(&full[s], T::kStageBytes);
          unsigned char* a = smem + s * T::kStageBytes;
          sm90::tma_load(a, &ma, &full[s], kt * BK, m0);
          sm90::tma_load(a + T::kABytes, &mb, &full[s], kt * BK, n0);
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31, wg = tid / 128, warp = (tid & 127) >> 5;
    Frag t{0, 0, 0, wg * 64 + warp * 16 + (lane >> 2), lane, {}, {}};
    int d[R];
    float f[kWide ? 1 : R];  // TBN 128: this tile's groups, folded
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = 0;
    int it = 0;
    for (int u = first; u < units; u += stride, ++t.ut) {
      t.m0 = u / per_row * BM;
      t.n0 = (P * (u % per_row) + rank) * TBN;
      if constexpr (!kWide) {
#pragma unroll
        for (int i = 0; i < R; ++i) f[i] = 0.f;
      }
      int pend = -1;  // the stage the wgmma group in flight reads
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % T::kStages;
        bar_wait(&full[s], (it / T::kStages) & 1);
        const uint32_t a =
            sm90::smem_u32(smem + s * T::kStageBytes) + wg * 64 * BK;
        const uint32_t b = sm90::smem_u32(smem + s * T::kStageBytes) +
                           T::kABytes;
        const int fresh = kt % gsteps == 0;  // a K group's first step
        gemm_s8::fence_regs(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma<TBN>(d, sm90::desc_sw128(a + kk * 32, 16, 1024),
                     sm90::desc_sw128(b + kk * 32, 16, 1024),
                     !(fresh && kk == 0));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (kt % gsteps != gsteps - 1) {
          // keep this step's group in flight; the previous one is done,
          // so its stage goes back to the producer
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          gemm_s8::fence_regs(d);
          if (pend >= 0) sm90::mbar_arrive(&empty[pend]);
          pend = s;
          continue;
        }
        // the group's last step: its sums are whole
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        gemm_s8::fence_regs(d);
        if (pend >= 0) sm90::mbar_arrive(&empty[pend]);
        sm90::mbar_arrive(&empty[s]);
        pend = -1;
        if constexpr (!kWide) {  // f += float(acc_g) * sa[row, g]
          const int g = kt / gsteps;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sa =
                t.gm(h) < p.M ? p.sa[(size_t)t.gm(h) * p.n_groups + g] : 0.f;
#pragma unroll
            for (int q = 0; q < R / 4; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * q + 2 * h + e;
                f[i] = __fadd_rn(f[i], __fmul_rn(__int2float_rn(d[i]), sa));
              }
          }
        }
      }
      if constexpr (!kWide) {
#pragma unroll
        for (int q0 = 0; q0 < R / 4; q0 += 4)
          store_pairs<EPI, 4>(p, t, q0, [&](int i, int) { return f[i]; });
        continue;
      }
      // TBN 256: fold the one group, dequantize and store
      float sa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) sa[h] = t.gm(h) < p.M ? p.sa[t.gm(h)] : 0.f;
      const auto v = [&](int i, int h) {
        return __fadd_rn(0.f, __fmul_rn(__int2float_rn(d[i]), sa[h]));
      };
      if constexpr (P == 1) {
#pragma unroll
        for (int q0 = 0; q0 < R / 4; q0 += 4) store_pairs<EPI, 4>(p, t, q0, v);
      } else {  // gelu(u) in place of the sums, the exchange, then int8
#pragma unroll
        for (int q0 = 0; q0 < R / 4; ++q0)
          gelu_pairs<EPI, 1>(p, t, q0, v, [&](int i, float x) {
            d[i] = __float_as_int(x);
          });
        send_max<P>(t, rank, xmax, xbar);
        take_max<P>(p, qo, t, rank, xmax, xbar);
#pragma unroll
        for (int q0 = 0; q0 < R / 4; q0 += 4)
          quant_pairs<4>(p, qo, t, q0,
                         [&](int i) { return __int_as_float(d[i]); });
      }
    }
  }
  // no block leaves while the other may still write to its shared memory
  if (P > 1) cluster_sync();
}

// A persistent grid: one block (or cluster of P) a tile up to what the
// card holds at once.
template <int EPI, int TBN, int P>
int launch(const void* A, const void* B, const Args& p, const Quant& qo,
           cudaStream_t st) {
  using T = Tile<TBN>;
  CUtensorMap ma, mb;
  int rc = sm90::make_map(&ma, A, p.M, p.K, BM, 1);
  if (rc) return rc;
  rc = sm90::make_map(&mb, B, p.N, p.K, TBN, 1);
  if (rc) return rc;
  auto kernel = gemm_s8_train_kernel<EPI, TBN, P>;
  static size_t opted = 0;
  static int capacity = 0;  // co-resident blocks (device 0 of the process)
  cudaError_t e = opt_in_smem(kernel, T::kSmemBytes, opted);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  if (P > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  if (capacity == 0) {
    if (P > 1) {
      int clusters = 0;
      cfg.gridDim = dim3(P * sm90::sm_count(), 1, 1);
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      capacity = clusters * P;
    } else {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads,
                                                        T::kSmemBytes);
      if (e != cudaSuccess) return (int)e;
      capacity = per_sm * sm90::sm_count();
    }
    if (capacity <= 0) return (int)cudaErrorLaunchOutOfResources;
  }
  const int tiles = (p.M + BM - 1) / BM * (p.N / TBN);
  cfg.gridDim = dim3(std::min(tiles, capacity), 1, 1);
  e = cudaLaunchKernelEx(&cfg, kernel, ma, mb, p, qo);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tile follows K's groups: 128 x 256 with one (EPI_F32 and the gated
// epilogues: qkv, out), 128 x 128 with several (the gated epilogues: fc2)
template <int EPI>
int launch_tile(const void* A, const void* B, const Args& p, const Quant& qo,
                cudaStream_t st) {
  if constexpr (EPI == gemm_s8::EPI_F32)
    return launch<EPI, 256, 1>(A, B, p, qo, st);
  else
    return p.n_groups == 1 ? launch<EPI, 256, 1>(A, B, p, qo, st)
                           : launch<EPI, 128, 1>(A, B, p, qo, st);
}

// the GELU epilogues (fc1: one K group), only with the requantization:
// compiled apart in gemm_s8_train_gelu.cu so that the two halves of the
// form's kernels build in parallel
int launch_gelu(const void* A, const void* B, const Args& p, const Quant& qo,
                int epi, cudaStream_t st);

}  // namespace s8t
