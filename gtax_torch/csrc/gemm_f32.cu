// fp32 GEMM on the CUDA cores with the epilogues of the fp32 branches:
// C = epilogue(A @ B), A (M, K) row-major fp32, B (K, N) row-major fp32
// (gtax's (in, out) kernel layout). Every product and every sum is a full
// fp32 FFMA: no tensor-core instruction, so no TF32 (which keeps about
// three decimal digits), as gtax's fp32 dots and the plain versions'
// torch.matmul under strict_matmul compute.
//
// Replaces the in-kernel jnp.dot calls of the TPU branch kernels in fp32
// (gtax/kernels/block.py _kernel/_mlp_kernel/_temporal_kernel/
// _temporal_step_kernel, gtax/kernels/vae_block.py _vae_block_kernel, all
// of which take x.dtype = float32; gtax/serving.py serves dtype="float32").
// The epilogues are gemm_epi.cuh's, each value stored before the rounding
// the bf16 epilogue would apply: EPI_F32 (the spatial branch's and the
// step's qkv rows), EPI_BIAS_BF16 (+ bias), EPI_BIAS_GELU_TANH and
// EPI_BIAS_GELU_ERF (fc1 + bias, tanh or exact GELU), EPI_BIAS_BF16_GELU
// (the VAE's fc1: the erf GELU of acc + bias), EPI_BIAS_GATED (x + gate *
// (acc + bias)), EPI_BIAS_BF16_RESID (x + (acc + bias)) and EPI_ROPE_QKV
// (fp32 q, k, v, rope on q and k: gtax_gemm_f32_rope_qkv); for training
// (gtax's emit_train and backward kernels at x.dtype = float32)
// EPI_BIAS_GATED_Y, EPI_BIAS_GELU_TANH_H and EPI_BIAS_GELU_ERF_H (the same
// with acc + bias also stored to C2: the residuals y and h1) and EPI_DGELU
// (u = gelu'(h1) * acc to C, gelu(h1) to C2, with h1 = aux fp32, and each
// 64-row slab's column sums of u to colsum, the partials of db1).
// Operand forms: OP_NN, C = A @ B (the forwards);
// OP_NT (trans_b), C = A @ W^T with W (N, K) row-major, the backward's
// dY @ W^T read from W's rows; OP_TN, C = A^T @ B over the token rows
// (gtax_gemm_f32_wgrad, the weight gradients): A (K, M) and B (K, N)
// row-major, K cut into row chunks whose fp32 partials gtax_reduce_rows
// adds in chunk order, as gemm_wgrad.cu does in bf16. OP_NT and OP_TN run
// gemm_f32_bwd_kernel.
// Bound: operations, 67 TFLOP/s of fp32 FFMA on the H100 SXM, at every
// main-path shape but the 144-row step's products, where the fp32
// weights (8-32 MB a product) come close.
// OP_NN in three forms; the caller picks one a call (the argument
// fwd_form; gtax_torch/kernels/block.py f32_form, the rule by rows and
// weights that gtax_torch/tools/gemm_sweep.py --f32 --forms measured on
// the card).
// The serving form (the out-projection's 432-719 rows, below the k-major
// form; gemm_f32_serve_kernel, kServe*): 48-row tiles by 64 columns, 192
// threads of 4 x 4 outputs, four blocks an SM;
// A's rows and B's k rows land as they lie by 16-byte cp.async copies
// into a 3-stage ring of 32-deep steps. K is cut into the chunks of a
// thread-block cluster (at most 8, gtax_torch/kernels/block.py
// f32_serve_chunk): each block sums its chunk into registers, stores it to
// its own shared memory, and after the cluster's barrier adds its share
// of the tile's rows from every block's partial through distributed
// shared memory in chunk order, then runs the epilogue: no partial
// through device memory, no second launch, one fixed order of sums.
// Shapes were timed at 144, 288 and 576 rows from an exploration harness
// not kept (PERF.md section 6): 144-row tiles that read each weight
// once a column tile, 8 x 4 and 8 x 8 outputs a thread, 16- and 32-deep
// steps; the small tile's four blocks an SM (24 warps) ran fastest on
// each of the twelve products. It replaced a 64x64 tile whose partials
// went through device memory to a second kernel (gtax_torch/tools/
// gemm_sweep.py --f32 from the older tree, in turns: 1.003-1.39x at the
// plan's chunks).
// The persistent form (a denoise step's 144 and 288 rows: every product
// below 432 rows; gemm_f32_persist_kernel, kPersist*): 48 x 128 tiles,
// 128 threads of 6 x 8 outputs (a 4-deep slice of K is six float4 loads
// of A's rows and eight of B for 192 FFMAs, 13.7 FFMAs a shared-memory
// load where the serving form's 4 x 4 does 8), four blocks an SM, all
// launched at once (a cooperative grid of one round); the (tile, K chunk)
// units are dealt to the blocks in turn, and each block walks its units'
// k-steps as one sequence through a 2-stage ring of 32-deep steps, so
// the ring fills once a launch, not once a unit. A split tile's chunks
// store their partials to a workspace and count themselves in; each
// block then sums a share of the rows of the tiles whose chunks it made,
// in chunk order, once their counts are complete, all of a sum's loads
// in flight at once (block.f32_persist_chunk picks the chunks; the grid
// does not change the bits). Launched as a programmatic dependent of the
// grid before it (ln_mod, #4's step attention), its blocks load their
// first weights before they wait for that grid's end. The shape was the
// fastest of twelve timed
// (gemm_sweep.py --persist-shapes, PERF.md section 6): at 144 rows qkv
// 0.037 ms against the serving form's 0.044.
// The k-major form (a prefill's rows, five DiT frames of 144 up to
// training's 11,520, the VAE's 1,152-3,456; gemm_f32_fwd_kernel): A
// k-major, as the backward stages it: 128x128
// tiles, two blocks an SM, 32-row steps through a two-stage cp.async ring
// whose copies come from pointers set up once; A's rows copied transposed
// first (f32_transpose_kernel) unless the caller stores them k-major, as
// the MLP's fc1 does for fc2 (C stored transposed); K cut by f32_chunk's
// rule for this form (the fewest wave-steps, gtax_torch/kernels/block.py
// f32_fwd_chunk); chip_smoke.py [sass] prints its main loop's FFMA share.
// The backward's design (gemm_f32_bwd_kernel, the training step's 11,520
// token rows): one kernel for both forms, C = A^T @ B over token rows
// that lie k-major. A 128-row tile of 256 threads, each thread 8 rows
// (ty*4 + 64 i ..) by 8 or 16 columns (tx*4 + 64 j ..); both operands
// staged k-major by 16-byte cp.async copies into a ring (one barrier a
// step), so a k's operands are float4 loads (a warp's A loads one
// broadcast, its B loads contiguous) for 64 or 128 FFMAs; the tile's
// shape by epilogue (BwdShape: 128 x 256 over 32-row steps, one block an
// SM, or 128 x 128 over 16-row steps, two). OP_NT's operands lie k
// contiguous (128 rows of 64 bytes a step): staged so, by cp.async or
// through registers, that product ran at 32-34 TFLOP/s against the
// token-row form's 42 (gtax_torch/tools/gemm_sweep.py, NVIDIA H100 80GB
// HBM3, 700 W), so OP_NT first copies A and W transposed
// (f32_transpose_kernel; 0.05-0.4 GB moved a product) and runs the
// token-row form.
// The gelu' epilogue's column sums come per 64-row slab, as the forward
// tile's.
// Each sum is taken in one fixed order (a chunk's products in K order,
// then the chunks in order; no atomics), so two calls agree bit for bit,
// and a given element's products are added in the same order in every
// form, so the forms' bits agree on the same values.
#include <cooperative_groups.h>

#include <climits>
#include <initializer_list>

#include "gemm_epi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;  // the K granule: K and its chunks are multiples

// The backward's forms (gemm_f32_bwd_kernel), by epilogue: a 128-row
// tile of TW columns, a cp.async ring of STAGES steps of KS token rows,
// and the blocks an SM its launch bounds ask for. EPI_F32 (the weight
// gradients, A @ W^T) on 128 x 256 tiles of 32-row steps, one block an
// SM; EPI_DGELU on 128 x 128 tiles of 16-row steps, two blocks an SM
// (its epilogue reads h1 and stores u and gelu(h1): on the wide tile it
// ran 20% slower). Ring depths of 2-4 moved either by < 2% (PERF.md
// section 6, NVIDIA H100 80GB HBM3, 700 W).
constexpr int kBwdTile = 128;  // rows of a tile
template <int EPI>
struct BwdShape {
  static constexpr int TW = 256, KS = 32, STAGES = 2, BLOCKS = 1;
};
template <>
struct BwdShape<EPI_DGELU> {
  static constexpr int TW = 128, KS = 16, STAGES = 3, BLOCKS = 2;
};

// One stage: KS token rows of the A and B tiles, k-major.
template <int EPI>
struct BwdStage {
  float a[BwdShape<EPI>::KS][kBwdTile];
  float b[BwdShape<EPI>::KS][BwdShape<EPI>::TW];
};

// What an fp32 epilogue reads and writes besides the accumulators.
struct F32Args {
  float* C;
  float* C2;  // EPI_ROPE_QKV: k; the _Y, _H epilogues: y, h1; EPI_DGELU:
              // gelu(h1)
  float* C3;  // EPI_ROPE_QKV: v
  const float* aux;  // EPI_DGELU: h1 (M, N)
  float* colsum;     // EPI_DGELU: (ceil(M / 64), N) slab column sums
  const void* bias;
  int bias_f32;
  const float* resid;
  const float* gate;
  int gate_stride;
  int S;
  const float* freqs;  // EPI_ROPE_QKV: (slots, hd) rotary table
  int n_q, q_off, hd;
  int M, N, K;
  int k_chunk;  // the K a block sums: K, or a chunk of a split product
  int lda;      // gemm_f32_bwd_kernel, gemm_f32_fwd_kernel (A k-major):
                // A's row stride (at least M, a multiple of 4)
  int ldc;      // gemm_f32_fwd_kernel with C transposed: C's row stride
  unsigned* flags;  // gemm_f32_persist_kernel (split K): two counters a
                    // tile, zero before and after a launch
};

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A bias epilogue's value at columns gn .. gn + 3 of row gm (gn a
// multiple of 4, all inside N), left in v for C; the second output (acc +
// bias to C2: the _Y and _H epilogues) stored here.
template <int EPI>
__device__ __forceinline__ void bias_value4(const F32Args& e, int gm, int gn,
                                            float (&v)[4]) {
  const size_t o = (size_t)gm * e.N + gn;
  float y[4], z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = v[i] + load_bias(e.bias, e.bias_f32, gn + i);
  if constexpr (EPI == EPI_BIAS_GATED || EPI == EPI_BIAS_GATED_Y ||
                EPI == EPI_BIAS_BF16_RESID) {
    float x[4];
    ld4(e.resid + o, x);
    if constexpr (EPI == EPI_BIAS_GATED || EPI == EPI_BIAS_GATED_Y) {
      float g[4];
      ld4(e.gate + (size_t)(gm / e.S) * e.gate_stride + gn, g);
#pragma unroll
      for (int i = 0; i < 4; ++i) z[i] = x[i] + g[i] * y[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) z[i] = x[i] + y[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (EPI == EPI_BIAS_GELU_TANH ||
                    EPI == EPI_BIAS_GELU_TANH_H)
        z[i] = gelu_tanh(y[i]);
      else if constexpr (EPI == EPI_BIAS_GELU_ERF ||
                         EPI == EPI_BIAS_GELU_ERF_H)
        z[i] = gelu_exact(y[i]);
      else if constexpr (EPI == EPI_BIAS_BF16_GELU) z[i] = gelu_erf(y[i]);
      else z[i] = y[i];  // EPI_BIAS_BF16
    }
  }
  if constexpr (EPI == EPI_BIAS_GATED_Y || EPI == EPI_BIAS_GELU_TANH_H ||
                EPI == EPI_BIAS_GELU_ERF_H)
    st4(e.C2 + o, y);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = z[i];
}

// Columns gn .. gn + 3 of row gm (gn a multiple of 4, all inside N).
// EPI_DGELU leaves u in v (the column sums' values).
template <int EPI>
__device__ __forceinline__ void store4(const F32Args& e, int gm, int gn,
                                       float (&v)[4]) {
  const size_t o = (size_t)gm * e.N + gn;
  if constexpr (EPI == EPI_F32) {
    st4(e.C + o, v);
  } else if constexpr (EPI == EPI_DGELU) {
    float h[4], g[4];
    ld4(e.aux + o, h);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 vg = gelu_tanh_val_grad(h[i]);
      v[i] = vg.y * v[i];
      g[i] = vg.x;
    }
    st4(e.C + o, v);
    st4(e.C2 + o, g);
  } else if constexpr (EPI == EPI_ROPE_QKV) {
    const int D = e.N / 3, third = gn / D, c_d = gn - third * D;
    float z[4] = {v[0], v[1], v[2], v[3]};
    if (third < 2) {  // q or k: rope at the row's window slot
      const float* f = e.freqs +
                       (size_t)(e.q_off + (gm / e.S) % e.n_q) * e.hd +
                       c_d % e.hd;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        float s0, c0, s1, c1;
        sincosf(f[i], &s0, &c0);
        if (f[i + 1] == f[i]) {  // the repo's tables repeat each angle
          s1 = s0;
          c1 = c0;
        } else {
          sincosf(f[i + 1], &s1, &c1);
        }
        const float2 r =
            rope_pair_cs(make_float2(v[i], v[i + 1]), c0, s0, c1, s1);
        z[i] = r.x;
        z[i + 1] = r.y;
      }
    }
    float* dst = third == 0 ? e.C : third == 1 ? e.C2 : e.C3;
    st4(dst + (size_t)gm * D + c_d, z);
  } else {  // the bias epilogues
    bias_value4<EPI>(e, gm, gn, v);
    st4(e.C + o, v);
  }
}

// The forward's serving form (gemm_f32_serve_kernel): a kServeTile x
// kServeTN tile of kServeThreads threads (12 row groups by 16 column
// groups, 4 x 4 outputs each), a ring of kServeStages steps of kServeKS k
// rows, kServeBlocks blocks an SM; K in at most kServeMaxCluster chunks,
// one a block of a cluster.
constexpr int kServeTile = 48, kServeRG = 12, kServeTN = 64, kServeKS = 32;
constexpr int kServeStages = 3, kServeBlocks = 4, kServeMaxCluster = 8;
constexpr int kServeThreads = kServeRG * 16;
constexpr int kServeLdA = kServeKS + 4;  // A rows: 9 16-byte slots apart
constexpr int kServeLdR = kServeTN + 4;  // the partial's rows
struct ServeStage {
  float a[kServeTile][kServeLdA];  // A rows as they lie
  float b[kServeKS][kServeTN];     // B's k rows
};
constexpr size_t kServeSmem = kServeStages * sizeof(ServeStage);
static_assert(kServeTile == kServeRG * 4 && kServeTN == 16 * 4 &&
                  kServeSmem >= kServeTile * kServeLdR * sizeof(float),
              "4 x 4 outputs a thread; the cluster's partial reuses the ring");

// C = epilogue(A @ B), A (M, K) and B (K, N) row-major: block x of the
// grid is column tile x / splits and K chunk x % splits (its cluster rank:
// the cluster is the tile's `splits` blocks), y the row tile. Thread (ty,
// tx) holds rows ty * 4 .. and columns tx * 4 ..: a 4-deep slice of K is
// four float4 loads of A's rows and four of B for 64 FFMAs. A's rows and
// B's k rows land as they lie by 16-byte cp.async copies; a chunk's steps
// past its end (K a multiple of 16, not of kServeKS) are zero-filled.
template <int EPI>
__global__ void __launch_bounds__(kServeThreads, kServeBlocks)
    gemm_f32_serve_kernel(const float* __restrict__ A,
                          const float* __restrict__ B, F32Args e) {
  namespace cg = cooperative_groups;
  constexpr int KS = kServeKS, STAGES = kServeStages, TN = kServeTN;
  extern __shared__ __align__(16) unsigned char serve_smem[];
  ServeStage* ring = reinterpret_cast<ServeStage*>(serve_smem);
  const int splits = e.K / e.k_chunk;
  const int chunk = blockIdx.x % splits;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kServeTile;
  const int n0 = blockIdx.x / splits * TN;
  const int M = e.M, N = e.N, K = e.K;
  const int k_begin = chunk * e.k_chunk, k_end = k_begin + e.k_chunk;
  const int steps = (e.k_chunk + KS - 1) / KS;

  auto load = [&](int s, int k0) {  // stage s: A rows, B rows of step k0
    ServeStage& st = ring[s];
    for (int c = tid; c < kServeTile * KS / 4; c += kServeThreads) {
      const int r = c / (KS / 4), kq = c % (KS / 4) * 4;
      const int gm = m0 + r, k = k0 + kq;
      const bool ok = gm < M && k < k_end;
      cp_async16(&st.a[r][kq], ok ? A + (size_t)gm * K + k : A,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < KS * TN / 4; c += kServeThreads) {
      const int r = c / (TN / 4), nq = c % (TN / 4) * 4;
      const int gn = n0 + nq, k = k0 + r;
      const bool ok = gn < N && k < k_end;
      cp_async16(&st.b[r][nq], ok ? B + (size_t)k * N + gn : B,
                 ok ? 16 : 0);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, k_begin + s * KS);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt landed; every thread left step kt - 1
    const int next = kt + STAGES - 1;
    if (next < steps) load(next % STAGES, k_begin + next * KS);
    cp_async_commit();
    const ServeStage& st = ring[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < KS; kk += 4) {
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld4(&st.a[ty * 4 + i][kk], a[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float b[4];
        ld4(&st.b[kk + k][tx * 4], b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][k], b[j], acc[i][j]);
      }
    }
  }

  if (splits == 1) {
    const int gn = n0 + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty * 4 + i;
      if (gm < M && gn < N) store4<EPI>(e, gm, gn, acc[i]);
    }
    return;
  }
  // the chunk's partial to this block's shared memory (the ring is idle),
  // then this block's rows of the tile from every chunk's, in chunk order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(serve_smem);  // [kServeTile][LdR]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    st4(red + (ty * 4 + i) * kServeLdR + tx * 4, acc[i]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (kServeTile + splits - 1) / splits;
  const int r0 = chunk * rows;
  for (int g = tid; g < rows * (TN / 4); g += kServeThreads) {
    const int r = r0 + g / (TN / 4), c = g % (TN / 4) * 4;
    const int gm = m0 + r, gc = n0 + c;
    if (r >= kServeTile || gm >= M || gc >= N) continue;
    float v[4];
    ld4(cluster.map_shared_rank(red, 0) + r * kServeLdR + c, v);
    for (int z = 1; z < splits; ++z) {
      float w[4];
      ld4(cluster.map_shared_rank(red, z) + r * kServeLdR + c, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] += w[j];
    }
    store4<EPI>(e, gm, gc, v);
  }
  cluster.sync();  // every block's partial stays until all have read it
}

// The forward's persistent form (gemm_f32_persist_kernel): a kPersistTile
// x kPersistTN tile of kPersistThreads threads (kPersistRG row groups by
// 16 column groups; thread (ty, tx) holds rows ty + kPersistRG i, i <
// kPersistR, and columns tx * 4 + 64 j, j < kPersistCJ, 4 each), a ring
// of kPersistStages steps of kPersistKS k rows, kPersistBlocks blocks an
// SM.
// The shape is a macro so that gtax_torch/tools/gemm_sweep.py
// --persist-shapes can time other shapes from copies built with
// -DGTAX_PERSIST_*; the library is built with the defaults below.
#ifndef GTAX_PERSIST_R
#define GTAX_PERSIST_R 6
#endif
#ifndef GTAX_PERSIST_RG
#define GTAX_PERSIST_RG 8
#endif
#ifndef GTAX_PERSIST_CJ
#define GTAX_PERSIST_CJ 2
#endif
#ifndef GTAX_PERSIST_KS
#define GTAX_PERSIST_KS 32
#endif
#ifndef GTAX_PERSIST_STAGES
#define GTAX_PERSIST_STAGES 2
#endif
#ifndef GTAX_PERSIST_BLOCKS
#define GTAX_PERSIST_BLOCKS 4
#endif
constexpr int kPersistR = GTAX_PERSIST_R, kPersistRG = GTAX_PERSIST_RG;
constexpr int kPersistCJ = GTAX_PERSIST_CJ;
constexpr int kPersistTile = kPersistR * kPersistRG;
constexpr int kPersistTN = 64 * kPersistCJ;
constexpr int kPersistKS = GTAX_PERSIST_KS;
constexpr int kPersistStages = GTAX_PERSIST_STAGES;
constexpr int kPersistBlocks = GTAX_PERSIST_BLOCKS;
constexpr int kPersistThreads = kPersistRG * 16;
constexpr int kPersistLdA = kPersistKS + 4;  // A rows: ty, ty + 1 apart
constexpr unsigned kPersistSpins = 1u << 24;  // a wait this long traps
constexpr int kPersistLoads = 8;  // a fix-up's partial loads in flight
struct PersistStage {
  float a[kPersistTile][kPersistLdA];  // A rows as they lie
  float b[kPersistKS][kPersistTN];     // B's k rows
};
constexpr size_t kPersistSmem = kPersistStages * sizeof(PersistStage);
static_assert(kPersistKS % BK == 0 && kPersistThreads % 32 == 0 &&
                  kPersistStages >= 2,
              "whole K granules a step, whole warps");

// a release add of 1 at gpu scope: the block's writes before the barrier
// that precedes it are seen by whoever acquires the count
__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// C = epilogue(A @ B), A (M, K) and B (K, N) row-major, on a grid of
// blocks that are all on the card at once (a cooperative launch). The
// units, (tile, K chunk) with the chunks of a tile consecutive and the
// tiles row tile by row tile, are dealt to the blocks in turn: block b
// takes units b, b + G, b + 2G, .. (G = gridDim.x). A block walks its
// units' k-steps as one sequence, so its cp.async ring runs on from one
// unit into the next and fills once a launch. A unit of an unsplit
// product stores its tile through the epilogue; a split unit stores its
// partial to part (units x kPersistTile x kPersistTN floats, a unit's
// tile dense) and then counts itself into its tile's first counter
// (flags[2 tile]). When a block's units are done, it takes the same units'
// indices as fix-up jobs: job (tile, q) waits until the tile's counter
// holds its chunks, counts itself into the second counter (the job that
// completes it zeroes both for the next launch), then sums its q-th share
// of the tile's rows over the partials in chunk order and runs the
// epilogue. Every element's sum is
// the chunks' partials, each an FFMA chain in K order, added in chunk
// order: the bits depend on k_chunk only, not on the grid or on timing
// (and equal gemm_f32_serve_kernel's at the same k_chunk). No block waits
// before its own units are done, and the cooperative launch puts every
// block on the card, so each wait ends; one that does not traps.
template <int EPI>
__global__ void __launch_bounds__(kPersistThreads, kPersistBlocks)
    gemm_f32_persist_kernel(const float* __restrict__ A,
                            const float* __restrict__ B, F32Args e,
                            float* __restrict__ part) {
  constexpr int KS = kPersistKS, STAGES = kPersistStages;
  constexpr int TM = kPersistTile, TN = kPersistTN, R = kPersistR;
  constexpr int RG = kPersistRG, CJ = kPersistCJ, NT = kPersistThreads;
  extern __shared__ __align__(16) unsigned char persist_smem[];
  PersistStage* ring = reinterpret_cast<PersistStage*>(persist_smem);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int M = e.M, N = e.N, K = e.K, G = gridDim.x, b = blockIdx.x;
  const int splits = (K + e.k_chunk - 1) / e.k_chunk;
  const int col_tiles = (N + TN - 1) / TN;
  const int units = (M + TM - 1) / TM * col_tiles * splits;
  const int steps = (e.k_chunk + KS - 1) / KS;
  const int mine = b < units ? (units - 1 - b) / G + 1 : 0;
  const int total = mine * steps;
  // a thread's 16-byte copies a step: A_COPIES of A's rows, B_COPIES of
  // B's k rows, each at a fixed place of the stage (int offsets: the entry
  // refuses an operand of 2^31 elements or more)
  constexpr int A_CHUNKS = TM * KS / 4, B_CHUNKS = KS * TN / 4;
  constexpr int A_COPIES = (A_CHUNKS + NT - 1) / NT;
  constexpr int B_COPIES = (B_CHUNKS + NT - 1) / NT;

  // the load cursor: unit lu's step lk, its tile's corner and K range
  int lu = b, lk = 0, lm0 = 0, ln0 = 0, lk0 = 0, lke = 0;
  auto start = [&]() {
    const int t = lu / splits;
    lm0 = t / col_tiles * TM;
    ln0 = (t - t / col_tiles * col_tiles) * TN;
    lk0 = (lu - t * splits) * e.k_chunk;
    lke = min(K, lk0 + e.k_chunk);
  };
  // stage s: B's k rows of the cursor's step, then (load_a) A's rows and
  // the cursor advanced
  auto load_b = [&](int s) {
    PersistStage& st = ring[s];
    const int k0 = lk0 + lk * KS;
#pragma unroll
    for (int q = 0; q < B_COPIES; ++q) {
      const int c = tid + q * NT;
      if (B_CHUNKS % NT == 0 || c < B_CHUNKS) {
        const int r = c / (TN / 4), nq = c % (TN / 4) * 4;
        const int gn = ln0 + nq, k = k0 + r;
        const bool ok = gn < N && k < lke;
        cp_async16(&st.b[r][nq], B + (ok ? k * N + gn : 0), ok ? 16 : 0);
      }
    }
  };
  auto load_a = [&](int s) {
    PersistStage& st = ring[s];
    const int k0 = lk0 + lk * KS;
#pragma unroll
    for (int q = 0; q < A_COPIES; ++q) {
      const int c = tid + q * NT;
      if (A_CHUNKS % NT == 0 || c < A_CHUNKS) {
        const int r = c / (KS / 4), kq = c % (KS / 4) * 4;
        const int gm = lm0 + r, k = k0 + kq;
        const bool ok = gm < M && k < lke;
        cp_async16(&st.a[r][kq], A + (ok ? gm * K + k : 0), ok ? 16 : 0);
      }
    }
    if (++lk == steps) {
      lk = 0;
      lu += G;
      if (lu < units) start();
    }
  };

  float acc[R][4 * CJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CJ; ++j) acc[i][j] = 0.f;
  // a programmatic dependent of this grid may launch now (its blocks
  // wait for this grid's end before reading its output); this grid's
  // first B rows (the weights) load before it waits for the grid before
  // it, whose output A may be
  asm volatile("griddepcontrol.launch_dependents;");
  if (total) start();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_b(s);
    if (s == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
    if (s < total) load_a(s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  // the stage a step reads (cs) and the one the next load fills (ls)
  int it = 0, cs = 0, ls = STAGES - 1;
  for (int j = 0, u = b; j < mine; ++j, u += G) {
    for (int kt = 0; kt < steps; ++kt, ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // step it landed; every thread left step it - 1
      if (it + STAGES - 1 < total) {
        load_b(ls);
        load_a(ls);
      }
      cp_async_commit();
      ls = ls == STAGES - 1 ? 0 : ls + 1;
      const PersistStage& st = ring[cs];
      cs = cs == STAGES - 1 ? 0 : cs + 1;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 4) {
        float a[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) ld4(&st.a[ty + RG * i][kk], a[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float bv[CJ][4];
#pragma unroll
          for (int h = 0; h < CJ; ++h)
            ld4(&st.b[kk + k][64 * h + tx * 4], bv[h]);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int c = 0; c < 4 * CJ; ++c)
              acc[i][c] = fmaf(a[i][k], bv[c / 4][c % 4], acc[i][c]);
        }
      }
    }
    // the unit's tile through the epilogue, or its partial
    const int t = u / splits;
    const int m0 = t / col_tiles * TM, n0 = t % col_tiles * TN;
    if (splits == 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int gm = m0 + ty + RG * i;
#pragma unroll
        for (int h = 0; h < CJ; ++h) {
          const int gn = n0 + 64 * h + tx * 4;
          float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]};
          if (gm < M && gn < N) store4<EPI>(e, gm, gn, v);
        }
      }
    } else {
      float* p = part + (size_t)u * TM * TN;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int h = 0; h < CJ; ++h)
          __stcg(reinterpret_cast<float4*>(p + (ty + RG * i) * TN + 64 * h +
                                           tx * 4),
                 make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]));
      __syncthreads();  // the whole partial is out before the count
      if (tid == 0) red_release(e.flags + 2 * t);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4 * CJ; ++c) acc[i][c] = 0.f;
  }
  if (splits == 1) return;

  // the fix-up jobs: the q-th share of a tile's rows over its chunks
  const int rows = (TM + splits - 1) / splits;
  for (int job = b; job < units; job += G) {
    const int t = job / splits, r0 = job % splits * rows;
    const int m0 = t / col_tiles * TM, n0 = t % col_tiles * TN;
    if (tid == 0) {
      unsigned* f = e.flags + 2 * t;
      for (unsigned spins = 0; ld_acquire(f) < (unsigned)splits;) {
        __nanosleep(64);
        if (++spins == kPersistSpins) __trap();
      }
      if (atomicAdd(f + 1, 1u) == (unsigned)splits - 1) {
        atomicExch(f, 0u);  // every job of the tile has seen it complete
        atomicExch(f + 1, 0u);
      }
    }
    __syncthreads();
    const float* p = part + (size_t)t * splits * TM * TN;
    for (int g = tid; g < rows * (TN / 4); g += NT) {
      const int r = r0 + g / (TN / 4), c = g % (TN / 4) * 4;
      const int gm = m0 + r, gn = n0 + c;
      if (r >= TM || gm >= M || gn >= N) continue;
      // the chunks' partials kPersistLoads at a time, all loads issued
      // before their sums, which run in chunk order
      const float* q = p + r * TN + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int z0 = 0; z0 < splits; z0 += kPersistLoads) {
        float4 w[kPersistLoads];
#pragma unroll
        for (int z = 0; z < kPersistLoads; ++z)
          if (z0 + z < splits)
            w[z] = __ldcg(reinterpret_cast<const float4*>(
                q + (size_t)(z0 + z) * TM * TN));
#pragma unroll
        for (int z = 0; z < kPersistLoads; ++z) {
          if (z0 + z >= splits) break;
          if (z0 + z == 0) {
            v[0] = w[z].x, v[1] = w[z].y, v[2] = w[z].z, v[3] = w[z].w;
          } else {
            v[0] += w[z].x, v[1] += w[z].y, v[2] += w[z].z, v[3] += w[z].w;
          }
        }
      }
      store4<EPI>(e, gm, gn, v);
    }
  }
}

// The backward's products, C = A^T @ B over the token rows with A (K, M)
// of row stride e.lda and B (K, N) row-major (OP_TN; OP_NT runs it on
// transposed copies), a
// 128 x TW tile (BwdShape) a block over K chunk blockIdx.z (its partial
// at C + z M N; EPI_F32, or over the whole of K EPI_DGELU). Both tiles are
// staged k-major as they lie, by a cp.async ring of STAGES; a chunk's
// steps past K (the short last chunk) are zero-filled. Thread (ty, tx)
// holds rows ty*4 + 64 i .. and columns tx*4 + 64 j .., reading each k's
// operands as float4s.
template <int EPI>
__global__ void __launch_bounds__(kThreads, BwdShape<EPI>::BLOCKS)
    gemm_f32_bwd_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, F32Args e) {
  using Shape = BwdShape<EPI>;
  using Stage = BwdStage<EPI>;
  constexpr int T = kBwdTile, TW = Shape::TW, TJ = TW / 16, KS = Shape::KS;
  constexpr int STAGES = Shape::STAGES;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  Stage* ring = reinterpret_cast<Stage*>(bwd_smem);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * TW;
  const int M = e.M, N = e.N, K = e.K, lda = e.lda;
  const int k_begin = blockIdx.z * e.k_chunk;
  const int k_end = min(K, k_begin + e.k_chunk);
  const int steps = (k_end - k_begin + KS - 1) / KS;
  if constexpr (EPI == EPI_F32) e.C += (size_t)blockIdx.z * M * N;

  auto load = [&](int s, int k0) {  // stage s: KS token rows of A and B
    Stage& st = ring[s];
    for (int c = tid; c < KS * T / 4; c += kThreads) {
      const int r = c / (T / 4), q = c % (T / 4) * 4, k = k0 + r;
      const int gm = m0 + q;
      cp_async16(&st.a[r][q],
                 A + (size_t)min(k, K - 1) * lda + min(gm, lda - 4),
                 k < k_end && gm < lda ? 16 : 0);
    }
    for (int c = tid; c < KS * TW / 4; c += kThreads) {
      const int r = c / (TW / 4), q = c % (TW / 4) * 4, k = k0 + r;
      const int gn = n0 + q;
      cp_async16(&st.b[r][q],
                 B + (size_t)min(k, K - 1) * N + min(gn, N - 4),
                 k < k_end && gn < N ? 16 : 0);
    }
  };

  float acc[8][TJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, k_begin + s * KS);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt landed; every thread left step kt - 1
    const int next = kt + STAGES - 1;
    if (next < steps) load(next % STAGES, k_begin + next * KS);
    cp_async_commit();
    const Stage& st = ring[kt % STAGES];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      float a[2][4], b[TJ / 4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) ld4(&st.a[k][64 * h + ty * 4], a[h]);
#pragma unroll
      for (int h = 0; h < TJ / 4; ++h) ld4(&st.b[k][64 * h + tx * 4], b[h]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          acc[i][j] = fmaf(a[i / 4][i % 4], b[j / 4][j % 4], acc[i][j]);
    }
  }

  // EPI_DGELU: the thread's column sums of u over its rows of each
  // 64-row slab (i < 4, i >= 4), in row order; rows past M add nothing
  float cs[2][TJ];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < TJ; ++j) cs[h][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TJ; j += 4) {
      const int gn = n0 + (j / 4) * 64 + tx * 4;
      if (gn >= N) continue;
      float v[4] = {acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]};
      store4<EPI>(e, gm, gn, v);
      if constexpr (EPI == EPI_DGELU) {
#pragma unroll
        for (int c = 0; c < 4; ++c) cs[i / 4][j + c] += v[c];
      }
    }
  }
  if constexpr (EPI == EPI_DGELU) {
    // a slab's column sum: the 16 row groups' sums added in ty order,
    // through the ring (its last copy groups are empty)
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(bwd_smem);  // [2][16][TW]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        red[(h * 16 + ty) * TW + (j / 4) * 64 + tx * 4 + j % 4] = cs[h][j];
    __syncthreads();
    for (int c = tid; c < 2 * TW; c += kThreads) {
      const int slab = c / TW, col = c % TW, gn = n0 + col;
      const int row = m0 / 64 + slab;
      if (gn >= N || row * 64 >= M) continue;
      float t = 0.f;
      for (int y = 0; y < 16; ++y) t += red[(slab * 16 + y) * TW + col];
      e.colsum[(size_t)row * N + gn] = t;
    }
  }
}

// The forward product at prefill, training and VAE rows
// (gemm_f32_fwd_kernel, the k-major form): a 128 x TW tile a block over a
// ring of STAGES steps of KS k rows, BLOCKS blocks an SM (8 x 8 outputs a
// thread, in at most 128 registers), A k-major (K, lda) as the backward's
// token rows lie: the entry point copies a row-major A transposed first
// (f32_transpose_kernel), or the caller hands it over k-major (the fc1
// epilogue's transposed store of the GELU rows that fc2 reads). Two blocks of 128 x 128 an SM beat one
// of 128 x 256 at the VAE's rows (27 row tiles) and matched it at 11,520;
// A staged from its (M, K) rows, through registers or by 4-byte cp.async,
// ran below k-major A; loading k + 1's operands while k's FFMAs ran moved
// nothing (PERF.md section 6; gtax_torch/tools/gemm_sweep.py --f32
// times the shape constants below from a copy of the tree).
struct FwdShape {
  static constexpr int TW = 128, KS = 32, STAGES = 2, BLOCKS = 2;
};

struct FwdStage {
  float a[FwdShape::KS][kBwdTile];
  float b[FwdShape::KS][FwdShape::TW];
};

// C = epilogue(A @ B) over K chunk blockIdx.z (its partial, EPI_F32, at C
// + z M N; the steps past the chunk's end zero-filled), A (K, lda)
// k-major, B (K, N) row-major. Thread (ty, tx) holds rows ty*4 + 64 i ..
// and columns tx*4 + 64 j ..; each k's operands are four float4 shared
// loads for 64 FFMAs. A step's copies are 16-byte cp.async from pointers
// set up once (only the last step of a chunk checks each row against its
// end). CT: C stored transposed, (N, e.ldc): a bias epilogue's value, its
// second output row-major; a thread's four rows of a column one float4,
// rows past M zero.
template <int EPI, bool CT>
__global__ void __launch_bounds__(kThreads, FwdShape::BLOCKS)
    gemm_f32_fwd_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, F32Args e) {
  constexpr int T = kBwdTile, TW = FwdShape::TW, TJ = TW / 16;
  constexpr int KS = FwdShape::KS, STAGES = FwdShape::STAGES;
  // a thread's copies: a 16-byte column, rows AR (BR) apart
  constexpr int AR = kThreads / (T / 4), BR = kThreads / (TW / 4);
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  FwdStage* ring = reinterpret_cast<FwdStage*>(fwd_smem);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * TW;
  const int M = e.M, N = e.N, K = e.K, lda = e.lda;
  const int k_begin = blockIdx.z * e.k_chunk;
  const int k_end = min(K, k_begin + e.k_chunk);
  const int steps = (k_end - k_begin + KS - 1) / KS;
  if constexpr (EPI == EPI_F32) e.C += (size_t)blockIdx.z * M * N;
  const int a_col = (tid % (T / 4)) * 4, a_row = tid / (T / 4);
  const int b_col = (tid % (TW / 4)) * 4, b_row = tid / (TW / 4);
  const bool a_ok = m0 + a_col < lda, b_ok = n0 + b_col < N;
  const float* a_src =
      A + (size_t)(k_begin + a_row) * lda + min(m0 + a_col, lda - 4);
  const float* b_src =
      B + (size_t)(k_begin + b_row) * N + min(n0 + b_col, N - 4);

  auto load = [&](int s, int step) {  // the chunk's step `step` to stage s
    FwdStage& st = ring[s];
    const int k0 = k_begin + step * KS;
    const float* pa = a_src + (size_t)step * KS * lda;
    const float* pb = b_src + (size_t)step * KS * N;
    if (k0 + KS <= k_end) {
#pragma unroll
      for (int q = 0; q < KS / AR; ++q)
        cp_async16(&st.a[q * AR + a_row][a_col], pa + (size_t)q * AR * lda,
                   a_ok ? 16 : 0);
#pragma unroll
      for (int q = 0; q < KS / BR; ++q)
        cp_async16(&st.b[q * BR + b_row][b_col], pb + (size_t)q * BR * N,
                   b_ok ? 16 : 0);
    } else {  // the chunk's last, short step
#pragma unroll
      for (int q = 0; q < KS / AR; ++q) {
        const bool ok = a_ok && k0 + q * AR + a_row < k_end;
        cp_async16(&st.a[q * AR + a_row][a_col],
                   ok ? pa + (size_t)q * AR * lda : A, ok ? 16 : 0);
      }
#pragma unroll
      for (int q = 0; q < KS / BR; ++q) {
        const bool ok = b_ok && k0 + q * BR + b_row < k_end;
        cp_async16(&st.b[q * BR + b_row][b_col],
                   ok ? pb + (size_t)q * BR * N : B, ok ? 16 : 0);
      }
    }
  };

  float acc[8][TJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt landed; every thread left step kt - 1
    const int next = kt + STAGES - 1;
    if (next < steps) load(next % STAGES, next);
    cp_async_commit();
    const FwdStage& st = ring[kt % STAGES];
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      float a[2][4], b[TJ / 4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) ld4(&st.a[k][64 * h + ty * 4], a[h]);
#pragma unroll
      for (int h = 0; h < TJ / 4; ++h) ld4(&st.b[k][64 * h + tx * 4], b[h]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          acc[i][j] = fmaf(a[i / 4][i % 4], b[j / 4][j % 4], acc[i][j]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm0 = m0 + 64 * h + ty * 4;
#pragma unroll
    for (int j = 0; j < TJ; j += 4) {
      const int gn = n0 + (j / 4) * 64 + tx * 4;
      if (gn >= N || gm0 >= M) continue;
      float z[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v[4] = {acc[4 * h + r][j], acc[4 * h + r][j + 1],
                      acc[4 * h + r][j + 2], acc[4 * h + r][j + 3]};
        if (gm0 + r < M) {
          if constexpr (CT)
            bias_value4<EPI>(e, gm0 + r, gn, v);
          else
            store4<EPI>(e, gm0 + r, gn, v);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) z[r][c] = gm0 + r < M ? v[c] : 0.f;
      }
      if constexpr (CT) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float col[4] = {z[0][c], z[1][c], z[2][c], z[3][c]};
          st4(e.C + (size_t)(gn + c) * e.ldc + gm0, col);
        }
      }
    }
  }
}

// out (C, ldo) = in (R, C)^T, fp32, C a multiple of 4 and ldo R rounded
// up to 4 (out's columns past R zero), through 64 x 65 shared tiles:
// 16-byte loads along C and stores along R (OP_NT's operand copies,
// k-major for the ring)
__global__ void __launch_bounds__(256)
    f32_transpose_kernel(const float* __restrict__ in,
                         float* __restrict__ out, int R, int C, int ldo) {
  __shared__ float t[64][65];
  const int c0 = blockIdx.x * 64, r0 = blockIdx.y * 64;
  const int q = (threadIdx.x & 15) * 4, y = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = y + 16 * i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R && c0 + q < C)
      v = *reinterpret_cast<const float4*>(in + (size_t)(r0 + r) * C + c0 + q);
    t[r][q] = v.x, t[r][q + 1] = v.y, t[r][q + 2] = v.z, t[r][q + 3] = v.w;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = y + 16 * i;
    if (c0 + c < C && r0 + q < ldo)
      *reinterpret_cast<float4*>(out + (size_t)(c0 + c) * ldo + r0 + q) =
          make_float4(t[q][c], t[q + 1][c], t[q + 2][c], t[q + 3][c]);
  }
}

// The split product's second step: the chunks' partials (splits, M, N)
// added in chunk order, then the epilogue; a thread a four-column group
// (CT: stored transposed, (N, e.ldc), four 4-byte stores).
template <int EPI, bool CT = false>
__global__ void __launch_bounds__(kThreads)
    f32_reduce_kernel(const float* __restrict__ part, int splits,
                      const F32Args e) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int G = e.N / 4;
  if (g >= (long long)e.M * G) return;
  const int gm = (int)(g / G), gn = (int)(g % G) * 4;
  const size_t mn = (size_t)e.M * e.N, o = (size_t)gm * e.N + gn;
  float v[4];
  ld4(part + o, v);
  for (int z = 1; z < splits; ++z) {
    float w[4];
    ld4(part + z * mn + o, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += w[i];
  }
  if constexpr (CT) {  // the last row's thread zeroes the rows past M
    bias_value4<EPI>(e, gm, gn, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* col = e.C + (size_t)(gn + c) * e.ldc;
      col[gm] = v[c];
      if (gm == e.M - 1)
        for (int r = e.M; r < e.ldc; ++r) col[r] = 0.f;
    }
  } else {
    store4<EPI>(e, gm, gn, v);
  }
}

// gemm_f32_serve_kernel over K / e.k_chunk chunks, a cluster of them a
// column tile (the ring's shared memory opted into at its first launch)
template <int EPI>
int launch_serve(const float* A, const float* B, const F32Args& e,
                 cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t err =
      opt_in_smem(gemm_f32_serve_kernel<EPI>, kServeSmem, opted);
  if (err != cudaSuccess) return (int)err;
  const int splits = e.K / e.k_chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((e.N + kServeTN - 1) / kServeTN * splits,
                     (e.M + kServeTile - 1) / kServeTile, 1);
  cfg.blockDim = dim3(kServeThreads, 1, 1);
  cfg.dynamicSmemBytes = kServeSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched =
      cudaLaunchKernelEx(&cfg, gemm_f32_serve_kernel<EPI>, A, B, e);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

// gemm_f32_persist_kernel on `blocks` blocks (at most one a unit): a
// cooperative launch, so that every block is on the card at once (the
// fix-up jobs wait for other blocks' units); a grid larger than the card
// holds is refused
template <int EPI>
int launch_persist(const float* A, const float* B, const F32Args& e,
                   int blocks, float* part, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  const cudaError_t err =
      opt_in_smem(gemm_f32_persist_kernel<EPI>, kPersistSmem, opted);
  if (err != cudaSuccess) return (int)err;
  const int units = (e.M + kPersistTile - 1) / kPersistTile *
                    ((e.N + kPersistTN - 1) / kPersistTN) *
                    ((e.K + e.k_chunk - 1) / e.k_chunk);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks < units ? blocks : units, 1, 1);
  cfg.blockDim = dim3(kPersistThreads, 1, 1);
  cfg.dynamicSmemBytes = kPersistSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, gemm_f32_persist_kernel<EPI>, A, B, e, part);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

// gemm_f32_bwd_kernel over `splits` K chunks of e.k_chunk (the ring's
// shared memory opted into at its first launch)
template <int EPI>
int launch_bwd(const float* A, const float* B, const F32Args& e, int splits,
               cudaStream_t st) {
  static size_t opted = 48 * 1024;
  constexpr size_t smem = BwdShape<EPI>::STAGES * sizeof(BwdStage<EPI>);
  const cudaError_t err = opt_in_smem(gemm_f32_bwd_kernel<EPI>, smem, opted);
  if (err != cudaSuccess) return (int)err;
  constexpr int TW = BwdShape<EPI>::TW;
  const dim3 grid((e.N + TW - 1) / TW, (e.M + kBwdTile - 1) / kBwdTile,
                  splits);
  gemm_f32_bwd_kernel<EPI><<<grid, kThreads, smem, st>>>(A, B, e);
  return (int)cudaGetLastError();
}

// out (C, ldo) = in (R, C)^T; returns ldo, R rounded up to 4
int transpose(const float* in, float* out, int R, int C, cudaStream_t st) {
  const int ldo = (R + 3) & ~3;
  const dim3 grid((C + 63) / 64, (R + 63) / 64);
  f32_transpose_kernel<<<grid, 256, 0, st>>>(in, out, R, C, ldo);
  return ldo;
}

// A @ W^T = (A^T)^T @ W^T: A (M, K) and W (N, K) copied transposed into
// ws ((K, M4), M4 = M rounded up to 4, then (K, N)), then the token-row
// product over the whole of K, or (EPI_F32, e.k_chunk < K) the chunks'
// partials (after the copies in ws) and their sum in chunk order
template <int EPI>
int launch_nt(const float* A, const float* W, F32Args e, float* ws,
              cudaStream_t st) {
  float* at = ws;
  e.lda = transpose(A, at, e.M, e.K, st);
  float* wt = at + (size_t)e.K * e.lda;
  transpose(W, wt, e.N, e.K, st);
  const int splits = e.K / e.k_chunk;
  if (splits == 1) return launch_bwd<EPI>(at, wt, e, 1, st);
  F32Args p = e;
  p.C = wt + (size_t)e.K * e.N;
  const int err = launch_bwd<EPI_F32>(at, wt, p, splits, st);
  if (err) return err;
  const long long groups = (long long)e.M * (e.N / 4);
  f32_reduce_kernel<EPI>
      <<<(unsigned)((groups + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          p.C, splits, e);
  return (int)cudaGetLastError();
}

// gemm_f32_fwd_kernel over `splits` K chunks of e.k_chunk (the ring's
// shared memory opted into at its first launch)
template <int EPI, bool CT>
int launch_fwd_kernel(const float* A, const float* B, const F32Args& e,
                      int splits, cudaStream_t st) {
  static size_t opted = 48 * 1024;
  constexpr size_t smem = FwdShape::STAGES * sizeof(FwdStage);
  const cudaError_t err = opt_in_smem(gemm_f32_fwd_kernel<EPI, CT>, smem,
                                      opted);
  if (err != cudaSuccess) return (int)err;
  constexpr int TW = FwdShape::TW;
  const dim3 grid((e.N + TW - 1) / TW, (e.M + kBwdTile - 1) / kBwdTile,
                  splits);
  gemm_f32_fwd_kernel<EPI, CT><<<grid, kThreads, smem, st>>>(A, B, e);
  return (int)cudaGetLastError();
}

// The forward's k-major form: A (M, K) row-major (e.lda 0) copied
// transposed into ws ((K, M4), M4 = M rounded up to 4) first, or given
// k-major (e.lda); then the product over ceil(K / e.k_chunk) chunks, their
// partials (after the copy in ws) added in chunk order by the reduction
// with the epilogue
template <int EPI, bool CT>
int launch_fwd(const float* A, const float* B, F32Args e, float* ws,
               cudaStream_t st) {
  if (e.lda == 0) {
    e.lda = transpose(A, ws, e.M, e.K, st);
    A = ws;
    ws += (size_t)e.K * e.lda;
  }
  const int splits = (e.K + e.k_chunk - 1) / e.k_chunk;
  if (splits == 1) return launch_fwd_kernel<EPI, CT>(A, B, e, 1, st);
  F32Args p = e;
  p.C = ws;
  const int err = launch_fwd_kernel<EPI_F32, false>(A, B, p, splits, st);
  if (err) return err;
  const long long groups = (long long)e.M * (e.N / 4);
  f32_reduce_kernel<EPI, CT>
      <<<(unsigned)((groups + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          ws, splits, e);
  return (int)cudaGetLastError();
}

// the epilogues whose C can be stored transposed (the GELU rows fc2 reads)
template <int EPI>
constexpr bool kGeluEpi =
    EPI == EPI_BIAS_GELU_TANH || EPI == EPI_BIAS_GELU_TANH_H ||
    EPI == EPI_BIAS_GELU_ERF || EPI == EPI_BIAS_GELU_ERF_H ||
    EPI == EPI_BIAS_BF16_GELU;

// the forward's forms (the C entry's fwd_form)
constexpr int kFormServe = 0, kFormKMajor = 1, kFormPersist = 2;

// the forward's launch by form: gemm_f32_serve_kernel,
// gemm_f32_fwd_kernel, or gemm_f32_persist_kernel on `blocks` blocks
template <int EPI>
int launch_any(const float* A, const float* B, const F32Args& e, int form,
               int blocks, float* ws, cudaStream_t st) {
  if (form == kFormServe) return launch_serve<EPI>(A, B, e, st);
  if constexpr (EPI != EPI_ROPE_QKV) {  // the rope product takes two forms
    if (form == kFormPersist)
      return launch_persist<EPI>(A, B, e, blocks, ws, st);
  }
  if constexpr (kGeluEpi<EPI>) {
    if (e.ldc) return launch_fwd<EPI, true>(A, B, e, ws, st);
  }
  return launch_fwd<EPI, false>(A, B, e, ws, st);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace

// A (M, K), B (K, N) (trans_b: (N, K), the product A @ B^T), C (M, N), all
// fp32 row-major; bias (N,) fp32 (bias_f32 = 1) or bf16; resid (M, N)
// fp32; gate: per-frame fp32 rows of gate_stride, frame = row / S. K a
// multiple of 16, N of 4, every row 16-byte aligned. epi: EPI_F32,
// EPI_BIAS_BF16, EPI_BIAS_GELU_TANH, EPI_BIAS_GELU_ERF, EPI_BIAS_BF16_GELU,
// EPI_BIAS_GATED or EPI_BIAS_BF16_RESID (gemm_epi.cuh), each stored
// unrounded; EPI_BIAS_GATED_Y, EPI_BIAS_GELU_TANH_H and EPI_BIAS_GELU_ERF_H
// also store acc + bias to C2 (M, N); with trans_b, EPI_F32, or EPI_DGELU:
// C = u = gelu'(aux) * acc, C2 = gelu(aux), aux (M, N) fp32, colsum
// (ceil(M / 64), N) the column sums of u over each 64-row slab, K one pass.
// k_chunk: K, or a K chunk (a multiple of 16 dividing K) whose partials are
// added in order before the epilogue: on the serving form (fwd_form 0) at
// most kServeMaxCluster chunks, through the cluster's shared memory (part
// unused); with trans_b through part, (K / k_chunk, M, N) fp32.
// trans_b (fwd_form 0): part a workspace of K M4 + K N floats (A^T, its
// rows padded to M4 = M rounded up to 4, and W^T), then the partials' (K /
// k_chunk) M N where K is split. fwd_form 1, the k-major form
// (gemm_f32_fwd_kernel): k_chunk any multiple of 16 up to K (ceil(K /
// k_chunk) chunks, the last one short); lda 0, A (M, K) row-major, copied
// transposed to the start of part (K M4 floats), or lda > 0, A given
// k-major, (K, lda), lda >= M a multiple of 4; ldc > 0 (a GELU epilogue):
// C stored transposed, (N, ldc), ldc >= M a multiple of 4, rows past M
// zero (C2 stays (M, N)); the partials follow the copy in part. fwd_form
// 0: lda = ldc = 0. fwd_form 2, the persistent form
// (gemm_f32_persist_kernel): K / k_chunk chunks (k_chunk dividing K) over
// `blocks` blocks, at most the card's round (more are refused); where K is
// split, part holds the units' partials (units x kPersistTile x
// kPersistTN floats, units = ceil(M / kPersistTile) ceil(N / kPersistTN)
// K / k_chunk) and flags two counters a tile (ceil(M / kPersistTile)
// ceil(N / kPersistTN) tiles), zero before the launch and left zero by
// it, which no launch on another stream uses at the same time; lda = ldc
// = 0.
GTAX_ENTRY gtax_gemm_f32(const void* A, const void* B, void* C, void* C2,
                         const void* aux, void* colsum, const void* bias,
                         int bias_f32, const void* resid, const void* gate,
                         int gate_stride, int M, int N, int K, int S, int epi,
                         int trans_b, int k_chunk, int lda, int ldc,
                         int fwd_form, int blocks, void* flags, void* part,
                         void* stream) {
  const bool fwd = !trans_b && fwd_form == kFormKMajor;
  const bool serve = !trans_b && fwd_form == kFormServe;
  const bool persist = !trans_b && fwd_form == kFormPersist;
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % BK || S <= 0 ||
      fwd_form < 0 || fwd_form > 2 || (trans_b && fwd_form) ||
      (serve && k_chunk > 0 && K / k_chunk > kServeMaxCluster) ||
      !aligned16({A, B, C, C2, aux, resid, gate, part}) || gate_stride % 4 ||
      k_chunk <= 0 || k_chunk % BK || k_chunk > K ||
      (!fwd && ((K % k_chunk && !persist) || lda || ldc)) ||
      (fwd && (lda < 0 || (lda && (lda < M || lda % 4)) || ldc < 0 ||
               (ldc && (ldc < M || ldc % 4)))) ||
      (persist && (blocks <= 0 || (k_chunk < K && flags == nullptr) ||
                   (long long)M * K >= INT_MAX ||
                   (long long)K * N >= INT_MAX)) ||
      (((k_chunk < K && !serve) || trans_b || (fwd && !lda)) &&
       part == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool has_bias = epi != EPI_F32 && epi != EPI_DGELU;
  const bool has_resid = epi == EPI_BIAS_GATED || epi == EPI_BIAS_GATED_Y ||
                         epi == EPI_BIAS_BF16_RESID;
  const bool has_c2 = epi == EPI_BIAS_GATED_Y ||
                      epi == EPI_BIAS_GELU_TANH_H ||
                      epi == EPI_BIAS_GELU_ERF_H || epi == EPI_DGELU;
  if ((has_bias && bias == nullptr) || (has_resid && resid == nullptr) ||
      ((epi == EPI_BIAS_GATED || epi == EPI_BIAS_GATED_Y) &&
       gate == nullptr) ||
      has_c2 != (C2 != nullptr) ||
      (epi == EPI_DGELU &&
       (aux == nullptr || colsum == nullptr || k_chunk < K || !trans_b)) ||
      (trans_b && epi != EPI_F32 && epi != EPI_DGELU) ||
      (ldc && epi != EPI_BIAS_GELU_TANH && epi != EPI_BIAS_GELU_TANH_H &&
       epi != EPI_BIAS_GELU_ERF && epi != EPI_BIAS_GELU_ERF_H &&
       epi != EPI_BIAS_BF16_GELU))
    return (int)cudaErrorInvalidValue;
  F32Args e{};
  e.C = static_cast<float*>(C);
  e.C2 = static_cast<float*>(C2);
  e.aux = static_cast<const float*>(aux);
  e.colsum = static_cast<float*>(colsum);
  e.bias = bias;
  e.bias_f32 = bias_f32;
  e.resid = static_cast<const float*>(resid);
  e.gate = static_cast<const float*>(gate);
  e.gate_stride = gate_stride;
  e.S = S;
  e.M = M;
  e.N = N;
  e.K = K;
  e.k_chunk = k_chunk;
  e.lda = lda;
  e.ldc = ldc;
  e.flags = static_cast<unsigned*>(flags);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* p = static_cast<float*>(part);
  cudaStream_t st = (cudaStream_t)stream;
  if (trans_b)
    return epi == EPI_F32 ? launch_nt<EPI_F32>(a, b, e, p, st)
                          : launch_nt<EPI_DGELU>(a, b, e, p, st);
  switch (epi) {
#define GTAX_F32_CASE(E) \
  case E:                \
    return launch_any<E>(a, b, e, fwd_form, blocks, p, st);
    GTAX_F32_CASE(EPI_F32)
    GTAX_F32_CASE(EPI_BIAS_BF16)
    GTAX_F32_CASE(EPI_BIAS_GELU_TANH)
    GTAX_F32_CASE(EPI_BIAS_GELU_ERF)
    GTAX_F32_CASE(EPI_BIAS_BF16_GELU)
    GTAX_F32_CASE(EPI_BIAS_GATED)
    GTAX_F32_CASE(EPI_BIAS_BF16_RESID)
    GTAX_F32_CASE(EPI_BIAS_GATED_Y)
    GTAX_F32_CASE(EPI_BIAS_GELU_TANH_H)
    GTAX_F32_CASE(EPI_BIAS_GELU_ERF_H)
#undef GTAX_F32_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 weight gradient: C = A^T @ B summed over the M token rows, A
// (M, Ka) and B (M, N) fp32 row-major, into C (splits, Ka, N) fp32, one
// partial a chunk of `chunk` rows (a multiple of 16; splits = ceil(M /
// chunk); the last chunk may be short), which gtax_reduce_rows adds in
// chunk order: gemm_f32_bwd_kernel, a block a (tile, chunk).
GTAX_ENTRY gtax_gemm_f32_wgrad(const void* A, const void* B, void* C, int M,
                               int Ka, int N, int chunk, void* stream) {
  if (M <= 0 || Ka <= 0 || N <= 0 || Ka % 4 || N % 4 || chunk <= 0 ||
      chunk % BK || !aligned16({A, B, C}))
    return (int)cudaErrorInvalidValue;
  F32Args e{};
  e.C = static_cast<float*>(C);
  e.S = 1;
  e.M = Ka;
  e.N = N;
  e.K = M;
  e.k_chunk = chunk;
  e.lda = Ka;
  return launch_bwd<EPI_F32>(static_cast<const float*>(A),
                            static_cast<const float*>(B), e,
                            (M + chunk - 1) / chunk, (cudaStream_t)stream);
}

// The temporal branch's qkv product with rope in its epilogue, in fp32:
// q, k, v (M, D) = the three column thirds of A (M, D) @ B (D, 3D), rope
// (fp32, sincosf) on q and k at the row's window slot q_off + (r / S) % n_q
// of freqs ((slots, hd) fp32), nothing rounded; the form and the K split
// as gtax_gemm_f32's (fwd 0: at most kServeMaxCluster chunks, part unused;
// fwd 1: A's transposed copy in part, D M4 floats, then ceil(D / k_chunk)
// partials).
GTAX_ENTRY gtax_gemm_f32_rope_qkv(const void* A, const void* B, void* q,
                                  void* k, void* v, const void* freqs, int M,
                                  int D, int S, int n_q, int q_off, int hd,
                                  int k_chunk, int fwd, void* part,
                                  void* stream) {
  if (M <= 0 || D <= 0 || D % BK || S <= 0 || n_q <= 0 || q_off < 0 ||
      hd <= 0 || hd % 4 || D % hd || freqs == nullptr || q == nullptr ||
      k == nullptr || v == nullptr || !aligned16({A, B, q, k, v, part}) ||
      k_chunk <= 0 || k_chunk % BK || k_chunk > D || fwd < 0 || fwd > 1 ||
      (!fwd && (D % k_chunk || D / k_chunk > kServeMaxCluster)) ||
      (fwd && part == nullptr))
    return (int)cudaErrorInvalidValue;
  F32Args e{};
  e.C = static_cast<float*>(q);
  e.C2 = static_cast<float*>(k);
  e.C3 = static_cast<float*>(v);
  e.freqs = static_cast<const float*>(freqs);
  e.S = S;
  e.n_q = n_q;
  e.q_off = q_off;
  e.hd = hd;
  e.M = M;
  e.N = 3 * D;
  e.K = D;
  e.k_chunk = k_chunk;
  return launch_any<EPI_ROPE_QKV>(static_cast<const float*>(A),
                                  static_cast<const float*>(B), e, fwd, 0,
                                  static_cast<float*>(part),
                                  (cudaStream_t)stream);
}
