// The Hopper bf16 GEMM mainloop shared by gemm_bf16.cu (the forward and
// input-gradient products) and gemm_wgrad.cu (the weight gradients):
// C = epilogue(A @ B) with fp32 sums, one 128x128 or 128x256 output tile
// a block.
//
// Design (the card's fast path for a bf16 product):
//   - operand tiles arrive by TMA (cp.async.bulk.tensor) into a ring of
//     kStages stages in dynamic shared memory, 128-byte swizzled, each 64
//     deep along K (one swizzle atom: 128 bytes of bf16);
//   - a full and an empty mbarrier a stage: the producer thread arms
//     `full` with the stage's bytes, the TMA unit completes it, and the 256
//     consumer threads arrive on `empty` once their wgmma has read it;
//   - warpgroup 2 is the producer (one thread issues the copies; setmaxnreg
//     hands its registers to the consumers), warpgroups 0 and 1 each run
//     wgmma.mma_async m64n128k16 (or m64n256k16: the wide tile reads each
//     B element from shared memory once for twice the products, for the
//     shapes with enough tiles to fill the card) on 64 of the tile's rows,
//     fp32
//     accumulators in registers, one wgmma group kept in flight so a stage
//     is released as soon as the next one is issued;
//   - the epilogue stages the fp32 tile through the (drained) ring and runs
//     gemm_epilogue (gemm_epi.cuh) with 256 threads: coalesced stores, rows
//     >= M and columns >= N masked, the TPU kernels' rounding points.
// Operand layouts (which axis is contiguous) are template flags: TA = A is
// M-major (the weight gradient's A^T), TB = B is N-major ((K, N) row-major,
// gtax's (in, out) kernels and the weight gradient's dY); otherwise the
// operand is K-major (activations, and W (N, K) of the input gradients).
// A K-major operand is one TMA box of 64 (K) x 128 rows; an MN-major one is
// two boxes of 64 (MN) x 64 (K), side by side 8 KB apart. TMA zero-fills
// what lies outside the matrix, so ragged M, N and split-K ranges need no
// padding. Split K (gridDim.z > 1): block z sums K in [z * k_chunk, ...)
// and writes its own fp32 partial at C + z * M * N (EPI_F32 only).
//
// The small-M path (small_kernel, for the serving step's 144-320 rows):
// a 128x128 tile at 144 rows fetches every weight tile once per 128-row
// tile and leaves most SMs idle (fc2 at one frame: 16 blocks, each
// streaming 1 MB of weight). Here one block covers every row (up to five
// m64 slabs, split between the two consumer warpgroups) of a 64-column
// tile, so each weight byte leaves HBM once, and K is split into chunks
// (grid (N / 64, splits), one wave) so that the weight stream is spread
// over the card. With more than one chunk the launch is cooperative:
// each chunk's fp32 partial goes to a workspace, a grid barrier follows,
// and then every block takes 16-row slices of the output, adds the slice's
// partials in chunk order and runs the epilogue once on the whole sum, so
// the fused epilogues see the full product, the summing is spread over
// the card, and a run is bit-equal to the next (no float atomics).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encode call is looked up

#include <mutex>

#include "gemm_epi.cuh"

namespace sm90 {

constexpr int BM = 128, BN = 128, BK = 64, kStages = 4;
constexpr int kWideBN = 256;   // the wide tile: m64n256 a warpgroup
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = BM * BK * 2;  // one A stage: 16 KB

// The ring and the epilogue tile of a TBN-column tile.
template <int TBN>
struct Tile {
  static constexpr int kBBytes = TBN * BK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int CS = TBN + 8;  // fp32 staging row stride
  static constexpr size_t kSmemBytes =
      1024 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);
  static_assert(BM * CS * 4 <= kStages * kStageBytes,
                "the epilogue tile reuses the ring");
  static_assert(BM == 64 * kConsumers && TBN % 64 == 0, "m64 a warpgroup");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one box at (c0 = inner coordinate, c1 = outer).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in
// bytes. K-major: SBO = 1024 (8 rows of 128 bytes), LBO unused. MN-major:
// LBO = the stride between 64-wide MN blocks, SBO = between 8-deep K groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GTAX_F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 rows x 128 cols of this warpgroup, fp32) += A (64 x 16) B (16 x 128)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n}\n"
      : GTAX_F8(0), GTAX_F8(8), GTAX_F8(16), GTAX_F8(24), GTAX_F8(32),
        GTAX_F8(40), GTAX_F8(48), GTAX_F8(56)
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// d (64 rows x 256 cols of this warpgroup, fp32) += A (64 x 16) B (16 x 256)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, %130, %131;\n}\n"
      : GTAX_F8(0), GTAX_F8(8), GTAX_F8(16), GTAX_F8(24), GTAX_F8(32),
        GTAX_F8(40), GTAX_F8(48), GTAX_F8(56), GTAX_F8(64), GTAX_F8(72),
        GTAX_F8(80), GTAX_F8(88), GTAX_F8(96), GTAX_F8(104), GTAX_F8(112),
        GTAX_F8(120)
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// d (64 rows x 64 cols of this warpgroup, fp32) += A (64 x 16) B (16 x 64)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n}\n"
      : GTAX_F8(0), GTAX_F8(8), GTAX_F8(16), GTAX_F8(24)
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

#undef GTAX_F8

template <int EPI, bool TA, bool TB, int TBN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const EpiArgs e,
                int M, int N, int K, int k_chunk) {
  using T = Tile<TBN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int KT = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], T::kStageBytes);
        unsigned char* a = smem + s * T::kStageBytes;
        unsigned char* b = a + kABytes;
        const int k = k_begin + kt * BK;
        if (TA) {
          tma_load(a, &tma_a, &full[s], m0, k);
          tma_load(a + kABytes / 2, &tma_a, &full[s], m0 + 64, k);
        } else {
          tma_load(a, &tma_a, &full[s], k, m0);
        }
        if (TB) {
#pragma unroll
          for (int j = 0; j < TBN / 64; ++j)
            tma_load(b + j * 8192, &tma_b, &full[s], n0 + 64 * j, k);
        } else {
          tma_load(b, &tma_b, &full[s], k, n0);
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float d[TBN / 2];
#pragma unroll
    for (int i = 0; i < TBN / 2; ++i) d[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint32_t a = smem_u32(smem + s * T::kStageBytes);
      const uint32_t b = a + kABytes;
      fence_regs(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // this warpgroup's 64 rows: the second half of the K-major box, or
        // the second MN-major box; one k16 step is 32 bytes along a K-major
        // row, or 16 rows (2 KB) down an MN-major box
        const uint64_t da =
            TA ? desc_sw128(a + wg * 8192 + kk * 2048, 8192, 1024)
               : desc_sw128(a + wg * 8192 + kk * 32, 16, 1024);
        const uint64_t db = TB ? desc_sw128(b + kk * 2048, 8192, 1024)
                               : desc_sw128(b + kk * 32, 16, 1024);
        if constexpr (TBN == 128)
          wgmma_m64n128k16<TA, TB>(d, da, db);
        else
          wgmma_m64n256k16<TA, TB>(d, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // keep this k-tile's group in flight; the previous one is done, so
      // its stage goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs(d);
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(d);

    // both warpgroups are done reading the ring: stage the tile in it
    epi_sync<128 * kConsumers>();
    float* c = reinterpret_cast<float*>(smem);
    const int lane = tid & 31, warp = (tid & 127) >> 5;
    const int row = wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < TBN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(c + (size_t)row * T::CS + col) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(c + (size_t)(row + 8) * T::CS + col) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    epi_sync<128 * kConsumers>();
    gemm_epilogue<EPI, BM, TBN, T::CS, 128 * kConsumers>(
        c, e, m0, n0, M, N, (size_t)blockIdx.z * M * N, blockIdx.y, tid);
  }
}

// ------------------------------------------------------- the small-M path

constexpr int kSmallBN = 64;       // output columns of a block
constexpr int kSmallSlabs = 5;     // m64 row slabs: rows up to 320
constexpr int kSmallMaxStages = 8;
constexpr int kSmallMaxSplits = 8;  // K chunks
constexpr int kSlabBytes = 64 * BK * 2;  // one m64 slab of a k-step: 8 KB

// The ring holds as many stages as fit at the call's rows (five at 144,
// three at 288).
struct SmallTile {
  static constexpr int kRingBytes = 160 * 1024;
  static constexpr int CS = kSmallBN + 8;  // fp32 staging row stride
  static constexpr int kRows = 64 * kSmallSlabs;
  static constexpr int kStagedRows = (kRows + BM - 1) / BM * BM;
  static constexpr size_t kSmemBytes =
      1024 + (size_t)kRingBytes + 2 * kSmallMaxStages * sizeof(uint64_t);
  static_assert(kStagedRows * CS * 4 <= kRingBytes,
                "the epilogue tile reuses the ring");
  static_assert(kSmallBN * BK * 2 == kSlabBytes,
                "a stage: A slabs, then one B slab");
};

// C = epilogue(A @ B) for M <= 64 * kSmallSlabs rows: block (x, z) owns
// columns [64 x, 64 x + 64) and K chunk z. With more than one chunk (a
// cooperative launch), part holds a (splits, M, N) fp32 partial a chunk.
template <int EPI, bool TB>
__global__ void __launch_bounds__(kThreads, 1)
    small_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b, const EpiArgs e,
                 int M, int N, int K, int k_chunk, float* part) {
  using T = SmallTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kRingBytes);
  uint64_t* empty = full + kSmallMaxStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kSmallBN, z = blockIdx.y, splits = gridDim.y;
  const int k_begin = z * k_chunk;
  const int KT = (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK;
  const int slabs = (M + 63) / 64;
  const int stage_bytes = (slabs + 1) * kSlabBytes;  // A slabs, then B
  const int stages = min(kSmallMaxStages, T::kRingBytes / stage_bytes);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % stages;
        if (kt >= stages) mbar_wait(&empty[s], ((kt / stages) - 1) & 1);
        mbar_expect_tx(&full[s], stage_bytes);
        unsigned char* a = smem + s * stage_bytes;
        unsigned char* b = a + slabs * kSlabBytes;
        const int k = k_begin + kt * BK;
        for (int j = 0; j < slabs; ++j)
          tma_load(a + j * kSlabBytes, &tma_a, &full[s], k, 64 * j);
        if (TB)
          tma_load(b, &tma_b, &full[s], n0, k);
        else
          tma_load(b, &tma_b, &full[s], k, n0);
      }
    }
    if (splits > 1) cooperative_groups::this_grid().sync();
    return;  // the producers take no part in the epilogue
  }
  // consumer warpgroup wg takes slabs wg, wg + 2, wg + 4
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  constexpr int J = (kSmallSlabs + kConsumers - 1) / kConsumers;
  float d[J][32];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[j][i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % stages;
    mbar_wait(&full[s], (kt / stages) & 1);
    const uint32_t a = smem_u32(smem + s * stage_bytes);
    const uint32_t b = a + slabs * kSlabBytes;
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(d[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = TB ? desc_sw128(b + kk * 2048, 8192, 1024)
                             : desc_sw128(b + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int slab = wg + kConsumers * j;
        if (slab < slabs)  // uniform across the warpgroup
          wgmma_m64n64k16<0, TB>(
              d[j], desc_sw128(a + slab * kSlabBytes + kk * 32, 16, 1024),
              db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < J; ++j) fence_regs(d[j]);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % stages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < J; ++j) fence_regs(d[j]);

  // both warpgroups are done reading the ring: stage the tile in it
  epi_sync<128 * kConsumers>();
  float* c = reinterpret_cast<float*>(smem);
  const int lane = tid & 31, warp = (tid & 127) >> 5;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int slab = wg + kConsumers * j;
    if (slab >= slabs) continue;
    const int row = slab * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < kSmallBN / 8; ++q) {
      const int col = q * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(c + (size_t)row * T::CS + col) =
          make_float2(d[j][4 * q], d[j][4 * q + 1]);
      *reinterpret_cast<float2*>(c + (size_t)(row + 8) * T::CS + col) =
          make_float2(d[j][4 * q + 2], d[j][4 * q + 3]);
    }
  }
  epi_sync<128 * kConsumers>();
  if (splits == 1) {
    // the epilogue in 128-row pieces (the gelu' column partials are one
    // row a 128-row piece, as on the tiled path)
    for (int m0 = 0; m0 < M; m0 += BM)
      gemm_epilogue<EPI, BM, kSmallBN, T::CS, 128 * kConsumers>(
          c + (size_t)m0 * T::CS, e, m0, n0, M, N, 0, m0 / BM, tid);
    return;
  }
  // this chunk's partial out; after the grid barrier every block sums
  // slices of the output, their partials in chunk order
  constexpr int Q = kSmallBN / 4;  // float4s a row
  for (int i = tid; i < M * Q; i += 128 * kConsumers) {
    const int r = i / Q, c4 = (i % Q) * 4;
    *reinterpret_cast<float4*>(part + ((size_t)z * M + r) * N + n0 + c4) =
        *reinterpret_cast<const float4*>(c + (size_t)r * T::CS + c4);
  }
  cooperative_groups::this_grid().sync();
  // rows of a slice: 16, or a whole 128-row tile for the gelu' epilogue,
  // whose column partials sum each tile's rows
  constexpr int R = EPI == EPI_DGELU ? BM : 16;
  const int tiles = N / kSmallBN, slices = (M + R - 1) / R * tiles;
  const int blocks = gridDim.x * gridDim.y;
  const size_t zstride = (size_t)M * N / 4;  // float4s a partial
  for (int v = blockIdx.y * gridDim.x + blockIdx.x; v < slices;
       v += blocks) {
    const int r0 = v / tiles * R, s0 = v % tiles * kSmallBN;
    const int rows = min(R, M - r0);
    // every partial of an item is loaded before any is added, so the reads
    // from L2 overlap
    for (int i = tid; i < rows * Q; i += 128 * kConsumers) {
      const float4* src = reinterpret_cast<const float4*>(
          part + (size_t)(r0 + i / Q) * N + s0 + (i % Q) * 4);
      float4 pv[kSmallMaxSplits];
#pragma unroll
      for (int zz = 0; zz < kSmallMaxSplits; ++zz)
        if (zz < splits) pv[zz] = __ldcg(src + zz * zstride);
      float4 acc = pv[0];
#pragma unroll
      for (int zz = 1; zz < kSmallMaxSplits; ++zz) {
        if (zz >= splits) break;
        acc.x += pv[zz].x;
        acc.y += pv[zz].y;
        acc.z += pv[zz].z;
        acc.w += pv[zz].w;
      }
      *reinterpret_cast<float4*>(c + (size_t)(i / Q) * T::CS + (i % Q) * 4) =
          acc;
    }
    epi_sync<128 * kConsumers>();
    // rows past the slice are masked as if past M
    gemm_epilogue<EPI, BM, kSmallBN, T::CS, 128 * kConsumers>(
        c, e, r0, s0, r0 + rows, N, 0, r0 / BM, tid);
    epi_sync<128 * kConsumers>();
  }
}

// --------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at first use
// (no libcuda at link time).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A (rows, cols) row-major matrix of bf16 (elem_bytes 2) or int8 (1),
// boxes of box_rows x 128 bytes (one swizzle span: 64 bf16 or 128 int8
// columns), 128-byte swizzle, zero fill outside.
inline int encode_map(CUtensorMap* map, const void* base, int rows, int cols,
                      int box_rows, int elem_bytes) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if ((cols * elem_bytes) % 16 || reinterpret_cast<uintptr_t>(base) % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      enc(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          2, const_cast<void*>(base),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// encode_map through a small direct-mapped cache: a map is a function of
// its key alone, so a hit is exact, and the serving step's launches (the
// same weights, activations the caching allocator hands out again) skip
// the host-side encode.
inline int make_map(CUtensorMap* map, const void* base, int rows, int cols,
                    int box_rows, int elem_bytes = 2) {
  struct Entry {
    const void* base;
    int rows, cols, box_rows, elem_bytes;
    CUtensorMap map;
  };
  constexpr int kEntries = 256;
  static Entry cache[kEntries] = {};
  static std::mutex lock;
  const uintptr_t h = (reinterpret_cast<uintptr_t>(base) >> 8) ^
                      (uintptr_t)rows * 31 ^ (uintptr_t)cols * 131 ^
                      (uintptr_t)box_rows ^ (uintptr_t)elem_bytes << 12;
  Entry& e = cache[(h ^ (h >> 8) ^ (h >> 16)) % kEntries];
  std::lock_guard<std::mutex> guard(lock);
  if (e.base != base || e.rows != rows || e.cols != cols ||
      e.box_rows != box_rows || e.elem_bytes != elem_bytes) {
    const int rc = encode_map(&e.map, base, rows, cols, box_rows, elem_bytes);
    if (rc) {
      e.base = nullptr;
      return rc;
    }
    e.base = base;
    e.rows = rows;
    e.cols = cols;
    e.box_rows = box_rows;
    e.elem_bytes = elem_bytes;
  }
  *map = e.map;
  return 0;
}

// The card's SM count (device 0 of the process; queried once).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <int EPI, bool TA, bool TB, int TBN>
int launch_tile(const void* A, const void* B, const EpiArgs& e, int M, int N,
                int K, int k_chunk, int splits, cudaStream_t st) {
  using T = Tile<TBN>;
  CUtensorMap ma, mb;
  int rc = TA ? make_map(&ma, A, K, M, 64) : make_map(&ma, A, M, K, BM);
  if (rc) return rc;
  rc = TB ? make_map(&mb, B, K, N, 64) : make_map(&mb, B, N, K, TBN);
  if (rc) return rc;
  static bool attr = false;  // one opt-in per instantiation
  if (!attr) {
    const cudaError_t r = cudaFuncSetAttribute(
        gemm_kernel<EPI, TA, TB, TBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmemBytes);
    if (r != cudaSuccess) return (int)r;
    attr = true;
  }
  const dim3 grid((N + TBN - 1) / TBN, (M + BM - 1) / BM, splits);
  gemm_kernel<EPI, TA, TB, TBN><<<grid, kThreads, T::kSmemBytes, st>>>(
      ma, mb, e, M, N, K, k_chunk);
  return (int)cudaGetLastError();
}

// The small-M path: C = epilogue(A @ op(B)) for M <= 64 * kSmallSlabs,
// K in chunks of k_chunk (a multiple of BK, at most kSmallMaxSplits
// chunks); part: a (chunks, M, N) fp32 workspace, unused with one chunk.
// With several chunks the launch is cooperative, so the grid (column
// tiles x chunks) must fit on the card at once.
template <int EPI, bool TB>
int launch_small(const void* A, const void* B, const EpiArgs& e, int M,
                 int N, int K, int k_chunk, float* part, cudaStream_t st) {
  using T = SmallTile;
  if (M > T::kRows || N % kSmallBN || k_chunk <= 0 || k_chunk % BK)
    return (int)cudaErrorInvalidValue;
  const int splits = (K + k_chunk - 1) / k_chunk;
  if (splits > kSmallMaxSplits || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int rc = make_map(&ma, A, M, K, 64);
  if (rc) return rc;
  rc = TB ? make_map(&mb, B, K, N, 64) : make_map(&mb, B, N, K, kSmallBN);
  if (rc) return rc;
  static bool attr = false;  // one opt-in per instantiation
  if (!attr) {
    const cudaError_t r = cudaFuncSetAttribute(
        small_kernel<EPI, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::kSmemBytes);
    if (r != cudaSuccess) return (int)r;
    attr = true;
  }
  const dim3 grid(N / kSmallBN, splits);
  if (splits == 1) {
    small_kernel<EPI, TB><<<grid, kThreads, T::kSmemBytes, st>>>(
        ma, mb, e, M, N, K, k_chunk, part);
    return (int)cudaGetLastError();
  }
  void* args[] = {&ma, &mb, const_cast<EpiArgs*>(&e), &M, &N, &K, &k_chunk,
                  &part};
  const cudaError_t r = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(small_kernel<EPI, TB>), grid,
      dim3(kThreads), args, T::kSmemBytes, st);
  if (r != cudaSuccess) return (int)r;
  return (int)cudaGetLastError();
}

// C = epilogue(op(A) @ op(B)) over K, split into `splits` chunks of
// k_chunk (a multiple of BK) along blockIdx.z. A: (M, K) K-major, or with
// TA (K, M) M-major; B: (N, K) K-major, or with TB (K, N) N-major. `wide`
// takes 128 x 256 tiles (N a multiple of 256), else 128 x 128.
template <int EPI, bool TA, bool TB>
int launch(const void* A, const void* B, const EpiArgs& e, int M, int N,
           int K, int k_chunk, int splits, bool wide, cudaStream_t st) {
  if (N % 64 || k_chunk % BK || splits < 1 || (wide && N % kWideBN))
    return (int)cudaErrorInvalidValue;
  return wide ? launch_tile<EPI, TA, TB, kWideBN>(A, B, e, M, N, K, k_chunk,
                                                  splits, st)
              : launch_tile<EPI, TA, TB, BN>(A, B, e, M, N, K, k_chunk,
                                             splits, st);
}

}  // namespace sm90
