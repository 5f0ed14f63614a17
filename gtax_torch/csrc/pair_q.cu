// The paired int8 (W8A8) serving kernels: an attention branch and the MLP
// branch that follows it, one half of a DiT block, as ONE cooperative
// launch.
//
// Replaces gtax/kernels/pair.py fused_spatial_pair_q (pallas_call at :227,
// body _spatial_pair_kernel_q :114) and fused_temporal_pair_q (:303, body
// _temporal_pair_kernel_q :152): the spatial branch (or the incremental
// temporal step over the cached context K/V) then the MLP branch, equal to
// the sequential int8 wrappers of gtax_torch/kernels/quant.py. The TPU kernel
// keeps its intermediates in VMEM scratch and runs the attention under the
// first MLP chunk's grid step; Hopper has no sequential grid, so here every
// block of a grid that fits on the card at once walks nine phases, each
// striding its work units (rows, GEMM units of gemm_s8.cuh's weight-
// streaming tile, attention units) over the blocks, with a grid-wide
// barrier (cooperative_groups grid sync) between phases:
//   1. LN/modulate of x -> int8 rows + row scales          (ln_mod_row)
//   2. qkv GEMM, fp32 out                                  (gemm_s8 units)
//   3. attention, fp32 out: per (query tile, head, frame) for the spatial
//      branch (attn_frame_unit), per (batch, site, head) over the cached
//      context for the temporal step (attn_temporal_unit)
//   4. row quantization of the attention output   (quant_rows_unit, a warp)
//   5. out-projection + bias + gated residual -> bf16 xm   (gemm_s8 units)
//   6. LN/modulate of xm -> int8                           (ln_mod_row)
//   7. fc1 + bias + tanh-GELU (or the exact GELU), fp32    (gemm_s8 units)
//   8. per-chunk quantization of the GELU output  (quant_rows_unit, a warp)
//   9. fc2 over the chunks as K groups, folded in chunk order, + bias +
//      gated residual -> out                               (gemm_s8 units)
// Every phase is the device function the sequential kernels run (the
// *.cuh headers), so the result is bit-equal to the sequential launches:
// xm is rounded to bf16 where the sequential pair stores it
// (gtax/kernels/pair.py:139), and fc2's groups fold in chunk order.
// Intermediates live in one workspace the wrapper allocates (about 12 MB
// at two frames, inside the 50 MB L2), with the GEMMs' split-K partials
// (one region the four GEMM phases share, read through L2 only); no other
// buffer is written after it was read within a launch, so no block can
// see a stale cached line. The GEMM phases' K chunks come from the wrapper's
// plan (gtax_torch/kernels/pair.py), and their operands arrive by TMA
// through tensor maps the entry point makes (cached on the host).
// Bound: bytes, the 12 MB of int8 weights at one or two frames. What the
// pair saves is host work and launches: one launch for nine. The device
// code is pair_q.cuh's; the exact-GELU kernels (approx_gelu=False) are
// instantiated apart, in pair_q_exact.cu.
#include "pair_q.cuh"

using namespace pairq;

namespace {

template <int HD, bool TEMPORAL>
int launch(const PairArgs& a, const PairMaps& maps, cudaStream_t st) {
  return a.exact_gelu ? launch_exact(HD, TEMPORAL, a, maps, st)
                      : launch_gelu<HD, TEMPORAL, false>(a, maps, st);
}

template <bool TEMPORAL>
int grid_blocks_for(int hd, int S, int D) {
  size_t smem = 0;
  switch (hd) {
    case 32:
      return grid_blocks<32, TEMPORAL>(S, D, &smem);
    case 64:
      return grid_blocks<64, TEMPORAL>(S, D, &smem);
    default:
      return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The cooperative grid's block count for these shapes (what a launch
// uses), or minus a CUDA error code.
GTAX_ENTRY gtax_pair_q_blocks(int temporal, int hd, int S, int D) {
  return temporal ? grid_blocks_for<true>(hd, S, D)
                  : grid_blocks_for<false>(hd, S, D);
}

// One paired half-block. x: (M, D) bf16 rows, M = frames * S (spatial) or
// B * n_live * S (temporal, frame-major within a batch element);
// sh*/sc*/g*: per-frame bf16 rows of the given strides (shift and scale of
// a branch share theirs); *_q int8 (in, out) kernels stored column-major
// (W^T row-major), *_s fp32 column scales, biases fp32 (*_f32 = 1) or
// bf16; Hd the MLP width, G its chunk width; freqs: spatial (S, hd) rope
// table, temporal (n_ctx + n_live, hd); k_ctx/v_ctx: temporal only;
// valid_mask: bit j = window slot j is real; kc_*: the K chunks of the
// qkv, out-projection, fc1 and fc2 GEMMs (gemm_s8.cuh); ws: workspace of
// at least the bytes workspace_layout gives; exact_gelu: fc1's GELU is
// jax.nn.gelu(approximate=False) (1) or the tanh form (0).
GTAX_ENTRY gtax_pair_q(
    int temporal, const void* x, const void* sh1, const void* sc1,
    const void* g1, const void* sh2, const void* sc2, const void* g2,
    int p1_stride, int g1_stride, int p2_stride, int g2_stride,
    const void* qkv_q, const void* qkv_s, const void* out_q,
    const void* out_s, const void* out_b, int out_b_f32, const void* w1_q,
    const void* w1_s, const void* b1, int b1_f32, const void* w2_q,
    const void* w2_s, const void* b2, int b2_f32, const void* freqs,
    const void* k_ctx, const void* v_ctx, void* out, void* ws,
    long long ws_bytes, int M, int S, int D, int Hd, int G, int num_heads,
    int B, int n_live, int n_ctx, int valid_mask, int kc_qkv, int kc_out,
    int kc_fc1, int kc_fc2, int exact_gelu, void* stream) {
  if (M <= 0 || S <= 0 || M % S || D <= 0 || D % gemm_s8::BN ||
      D % gemm_s8::BK || num_heads <= 0 || D % num_heads || Hd <= 0 ||
      Hd % gemm_s8::BN || G <= 0 || G % gemm_s8::BK || Hd % G ||
      x == nullptr || out == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (temporal &&
      (B <= 0 || n_live <= 0 || n_ctx <= 0 || n_live + n_ctx > kMaxT ||
       (size_t)B * n_live * S != (size_t)M || k_ctx == nullptr ||
       v_ctx == nullptr))
    return (int)cudaErrorInvalidValue;
  const int chunks[kGemms] = {kc_qkv, kc_out, kc_fc1, kc_fc2};
  int nk[kGemms][2];
  gemm_shapes(D, Hd, nk);
  for (int i = 0; i < kGemms; ++i) {
    const int group = i == 3 ? G : nk[i][1];
    gemm_s8::Args p{};
    p.n_groups = nk[i][1] / group;
    p.group = group;
    p.M = M;
    p.N = nk[i][0];
    p.K = nk[i][1];
    p.S = S;
    p.k_chunk = chunks[i];
    p.part = static_cast<int*>(ws);
    if (!gemm_s8::valid(p)) return (int)cudaErrorInvalidValue;
  }
  size_t sizes[kBuffers];
  const size_t carved = workspace_layout(M, D, Hd, G, chunks, sizes);
  unsigned long long* stamps = nullptr;
#ifdef GTAX_PAIR_PROBE
  // the probe's stamps follow the buffers: kStamps per block of the grid
  const int blocks = temporal ? grid_blocks_for<true>(D / num_heads, S, D)
                              : grid_blocks_for<false>(D / num_heads, S, D);
  if (blocks < 0) return -blocks;
  if ((size_t)ws_bytes < carved + (size_t)blocks * kStamps * 8)
    return (int)cudaErrorInvalidValue;
  stamps = reinterpret_cast<unsigned long long*>(static_cast<char*>(ws) +
                                                 carved);
#endif
  if ((size_t)ws_bytes < carved) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  void* buf[kBuffers];
  for (int i = 0; i < kBuffers; ++i) {
    buf[i] = w;
    w += align256(sizes[i]);
  }
  PairArgs a{
      static_cast<const bf16*>(x),
      static_cast<const bf16*>(sh1), static_cast<const bf16*>(sc1),
      static_cast<const bf16*>(g1), static_cast<const bf16*>(sh2),
      static_cast<const bf16*>(sc2), static_cast<const bf16*>(g2),
      p1_stride, g1_stride, p2_stride, g2_stride,
      static_cast<const float*>(qkv_s), static_cast<const float*>(out_s),
      static_cast<const float*>(w1_s), static_cast<const float*>(w2_s),
      out_b, b1, b2, out_b_f32, b1_f32, b2_f32,
      static_cast<const float*>(freqs),
      static_cast<const bf16*>(k_ctx), static_cast<const bf16*>(v_ctx),
      static_cast<bf16*>(out),
      static_cast<signed char*>(buf[0]), static_cast<float*>(buf[1]),
      static_cast<float*>(buf[2]), static_cast<float*>(buf[3]),
      static_cast<signed char*>(buf[4]), static_cast<float*>(buf[5]),
      static_cast<bf16*>(buf[6]), static_cast<signed char*>(buf[7]),
      static_cast<float*>(buf[8]), static_cast<float*>(buf[9]),
      static_cast<signed char*>(buf[10]), static_cast<float*>(buf[11]),
      static_cast<int*>(buf[12]),
      {kc_qkv, kc_out, kc_fc1, kc_fc2},
      M, S, D, Hd, G, num_heads, B, n_live, n_ctx, valid_mask, stamps,
      exact_gelu};
  // the GEMMs' operands: the int8 rows of the workspace, and the weights
  PairMaps maps;
  const void* act[kGemms] = {a.mq1, a.aq, a.mq2, a.hq};
  const void* wt[kGemms] = {qkv_q, out_q, w1_q, w2_q};
  for (int i = 0; i < kGemms; ++i) {
    int rc = sm90::make_map(&maps.a[i], act[i], M, nk[i][1], 64, 1);
    if (rc) return rc;
    rc = sm90::make_map(&maps.b[i], wt[i], nk[i][0], nk[i][1], 64, 1);
    if (rc) return rc;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = D / num_heads;
  if (temporal) {
    switch (hd) {
      case 32:
        return launch<32, true>(a, maps, st);
      case 64:
        return launch<64, true>(a, maps, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32:
      return launch<32, false>(a, maps, st);
    case 64:
      return launch<64, false>(a, maps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
