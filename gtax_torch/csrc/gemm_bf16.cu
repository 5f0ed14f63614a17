// bf16 GEMM with fp32 accumulation on the tensor cores and the epilogues
// the fused branches need: C = epilogue(A @ B), A (M, K) row-major bf16,
// B (K, N) row-major bf16 (gtax's (in, out) kernel layout), or, with
// trans_b, B = W^T for W (N, K) row-major: the input-gradient products
// dY @ W^T of the branch backwards, reading the weight as it is stored.
// The MLP's exact GELU (approx_gelu=False: EPI_BIAS_GELU_ERF, and _H with
// emit_train's h1) takes the forward layout only.
//
// Replaces the in-kernel jnp.dot calls of the TPU branch kernels
// (gtax/kernels/block.py _kernel/_mlp_kernel/_temporal_kernel/
// _temporal_step_kernel, gtax/kernels/vae_block.py _vae_block_kernel) and
// the dX products of the backward kernels (gtax/kernels/backward.py
// _spatial_bwd_kernel/_temporal_bwd_kernel/_mlp_bwd_kernel: dy @ W^T with
// the gelu' and bf16 epilogues).
// Bound: at the serving shapes (M = 144..720 rows, K, N = 1024..4096) the
// weight bytes; at the VAE and training shapes (M = 2,304..11,520) the
// tensor-core rate.
// Design: the Hopper kernel of gemm_sm90.cuh (TMA ring, wgmma, two
// consumer warpgroups), with the epilogues of gemm_epi.cuh. Up to 320
// rows (a serving step), when the wrapper passes a K chunk
// (gtax_torch/kernels/block.py gemm_chunk): the small-M path, one block
// per 64-column tile and K chunk covering every row, the chunks' fp32
// partials summed in order, slice by slice over every block after a grid
// barrier, before the epilogue.
// Above it: 128x256 tiles where they alone fill the card, else 128x128.
// It replaced a 64x64-tile wmma kernel that was
// slower at every main-path product, 144 rows included (PERF.md section 6);
// its tensor maps are cached on the host, so a serving step's launches do
// not encode them again. The emit_train epilogues store a second bf16
// output (C2): the pre-gate y, or the pre-GELU h1; the temporal branch's
// qkv product stores q, k and v after rope (gtax_gemm_rope_qkv). The gelu'
// epilogue also sums its fp32 products over each tile's rows, one partial
// per (128-row tile, column), so the bias gradient is reduced in a fixed
// order (no atomics).
#include <initializer_list>

#include "gemm_sm90.cuh"

namespace {

template <int EPI>
int launch(const void* a, const void* b, const EpiArgs& e, int M, int N,
           int K, bool trans_b, int k_chunk, float* part, cudaStream_t st) {
  // the wide tile where its tiles alone fill the card's SMs: 128 x 128 at
  // the serving row counts, where a weight-bound product wants every SM
  const bool wide = N % sm90::kWideBN == 0 &&
                    (long long)((M + sm90::BM - 1) / sm90::BM) *
                            (N / sm90::kWideBN) >=
                        sm90::sm_count();
  // the exact-GELU epilogues serve forward products only: no W^T forms
  if constexpr (EPI == EPI_BIAS_GELU_ERF || EPI == EPI_BIAS_GELU_ERF_H) {
    if (trans_b) return (int)cudaErrorInvalidValue;
    return k_chunk > 0 ? sm90::launch_small<EPI, true>(a, b, e, M, N, K,
                                                       k_chunk, part, st)
                       : sm90::launch<EPI, false, true>(a, b, e, M, N, K, K,
                                                        1, wide, st);
  } else {
    if (k_chunk > 0)  // the small-M path
      return trans_b ? sm90::launch_small<EPI, false>(a, b, e, M, N, K,
                                                      k_chunk, part, st)
                     : sm90::launch_small<EPI, true>(a, b, e, M, N, K,
                                                     k_chunk, part, st);
    // trans_b: W (N, K) is K-major; else B (K, N) is N-major
    return trans_b ? sm90::launch<EPI, false, false>(a, b, e, M, N, K, K, 1,
                                                     wide, st)
                   : sm90::launch<EPI, false, true>(a, b, e, M, N, K, K, 1,
                                                    wide, st);
  }
}

}  // namespace

// The tiling the wrappers size buffers and plans from: {tile rows,
// k-step} of the Hopper kernel (gelu' partials, weight-gradient chunks),
// then the small-M path's {tile columns, rows, most K chunks}.
GTAX_ENTRY gtax_gemm_consts(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = sm90::BM;
  o[1] = sm90::BK;
  o[2] = sm90::kSmallBN;
  o[3] = sm90::SmallTile::kRows;
  o[4] = sm90::kSmallMaxSplits;
  return 0;
}

// trans_b = 0: B (K, N) row-major; trans_b = 1: B is W (N, K) row-major and
// the product is A @ W^T. C2: the second bf16 output of the emit_train and
// gelu' epilogues; aux: the bf16 h1 the gelu' epilogue reads; colsum:
// (ceil(M / 128), N) fp32 per-tile column sums of the gelu' epilogue.
// k_chunk > 0 takes the small-M path (M <= 320) with K in chunks of
// k_chunk; with more than one chunk, part is a (chunks, M, N) fp32
// workspace.
GTAX_ENTRY gtax_gemm_bf16(const void* A, const void* B, void* C, void* C2,
                          const void* aux, void* colsum, const void* bias,
                          int bias_f32, const void* resid, const void* gate,
                          int gate_stride, int M, int N, int K, int S, int epi,
                          int trans_b, int k_chunk, void* part,
                          void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 64 || K % sm90::BK || S <= 0)
    return (int)cudaErrorInvalidValue;
  const bool needs_c2 = epi == EPI_BIAS_GATED_Y ||
                        epi == EPI_BIAS_GELU_TANH_H ||
                        epi == EPI_BIAS_GELU_ERF_H || epi == EPI_DGELU;
  if ((needs_c2 && C2 == nullptr) ||
      (epi == EPI_DGELU && (aux == nullptr || colsum == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the epilogue moves eight elements at a time: 16-byte aligned rows
  for (const void* p : {(const void*)C, (const void*)C2, aux, resid, gate})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (gate != nullptr && gate_stride % 8) return (int)cudaErrorInvalidValue;
  const EpiArgs e{C,        static_cast<bf16*>(C2),
                  static_cast<const bf16*>(aux), static_cast<float*>(colsum),
                  bias,     bias_f32,
                  static_cast<const bf16*>(resid),
                  static_cast<const bf16*>(gate), gate_stride, S};
  cudaStream_t st = (cudaStream_t)stream;
  switch (epi) {
#define GTAX_GEMM_CASE(E) \
  case E:                 \
    return launch<E>(A, B, e, M, N, K, trans_b != 0, k_chunk,     \
                     static_cast<float*>(part), st);
    GTAX_GEMM_CASE(EPI_F32)
    GTAX_GEMM_CASE(EPI_BIAS_BF16)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_TANH)
    GTAX_GEMM_CASE(EPI_BIAS_BF16_GELU)
    GTAX_GEMM_CASE(EPI_BIAS_GATED)
    GTAX_GEMM_CASE(EPI_BIAS_BF16_RESID)
    GTAX_GEMM_CASE(EPI_BF16)
    GTAX_GEMM_CASE(EPI_BIAS_GATED_Y)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_TANH_H)
    GTAX_GEMM_CASE(EPI_DGELU)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_ERF)
    GTAX_GEMM_CASE(EPI_BIAS_GELU_ERF_H)
#undef GTAX_GEMM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The temporal branch's qkv product with rope in its epilogue
// (EPI_ROPE_QKV): q, k, v (M, D) bf16 = the three column thirds of
// A (M, D) @ B (D, 3D), rope (rope_pair, fp32) applied to q and k at the
// row's window slot q_off + (r / S) % n_q of freqs ((slots, hd) fp32) and
// each value rounded to bf16 once. The mainloop and tiles are those of the
// EPI_F32 call of gtax_gemm_bf16 at the same k_chunk, so q, k and v are
// the fp32 product's values through the attention kernels' own rope and
// rounding (csrc/attn_temporal.cuh attn_temporal_unit).
GTAX_ENTRY gtax_gemm_rope_qkv(const void* A, const void* B, void* q, void* k,
                              void* v, const void* freqs, int M, int D, int S,
                              int n_q, int q_off, int hd, int k_chunk,
                              void* part, void* stream) {
  if (M <= 0 || D <= 0 || D % 64 || S <= 0 || n_q <= 0 || q_off < 0 ||
      hd <= 0 || hd % 8 || D % hd || freqs == nullptr)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)q, (const void*)k, (const void*)v})
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16)
      return (int)cudaErrorInvalidValue;
  EpiArgs e{};
  e.C = q;
  e.C2 = static_cast<bf16*>(k);
  e.C3 = static_cast<bf16*>(v);
  e.freqs = static_cast<const float*>(freqs);
  e.S = S;
  e.n_q = n_q;
  e.q_off = q_off;
  e.hd = hd;
  return launch<EPI_ROPE_QKV>(A, B, e, M, 3 * D, D, false, k_chunk,
                              static_cast<float*>(part),
                              (cudaStream_t)stream);
}
