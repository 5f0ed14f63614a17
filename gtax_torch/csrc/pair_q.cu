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
// instantiated apart, in pair_q_exact.cu, and the fp32 forms in
// pair_q_f32.cu and pair_q_f32_exact.cu.
#include "pair_q.cuh"

using namespace pairq;

namespace {

int launch_bf16(int hd, bool temporal, const PairArgs& a,
                const PairMaps& maps, cudaStream_t st) {
  return a.exact_gelu ? launch_exact(hd, temporal, a, maps, st)
                      : launch_hd<bf16, false>(hd, temporal, a, maps, st);
}

}  // namespace

// The cooperative grid's block count for these shapes (what a launch
// uses), or minus a CUDA error code.
GTAX_ENTRY gtax_pair_q_blocks(int temporal, int hd, int S, int D) {
  return blocks_hd<bf16>(temporal, hd, S, D);
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
// jax.nn.gelu(approximate=False) (1) or the tanh form (0); attn_shape:
// the fp32 spatial form's attention query tile (attn_f32.cuh
// GTAX_F32_FRAME_SHAPES; unread by the bf16 forms and the temporal step).
GTAX_ENTRY gtax_pair_q(GTAX_PAIR_PARAMS) {
  return pair_call<bf16>(blocks_hd<bf16>, launch_bf16, GTAX_PAIR_ARGS);
}
