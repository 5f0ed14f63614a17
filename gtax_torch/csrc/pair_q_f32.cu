// The fp32 forms of the paired int8 (W8A8) serving kernels: gtax's paired
// kernels at x.dtype = float32 (gtax serves fp32 with int8 weights,
// gtax/serving.py:82-92), as ONE cooperative launch of the nine phases of
// pair_q.cu over fp32 activations.
//
// Replaces gtax/kernels/pair.py fused_spatial_pair_q (pallas_call at :227)
// and fused_temporal_pair_q (:303) at x.dtype = float32, where every
// astype(x.dtype) is a no-op: the seam xm (gtax/kernels/pair.py:139) and
// the output are fp32, the context cache is fp32, and only the int8
// activations are rounded (per row from fp32 values, half to even, as in
// bf16). The phases are the fp32 sequential kernels' device functions:
// ln_mod_row over fp32 rows (ln_mod's mode 5), the int8 GEMM units with
// the fp32 gated epilogue (gemm_s8's EPI_BIAS_GATED_F32), and the fp32
// attention bodies on the CUDA cores: for the spatial branch
// attn_frame_f32's rope (each position's angles reduced once in phase 1,
// q and k roped by the qkv product's epilogue, gemm_s8's EPI_F32_ROPE, as
// attn_frame_f32's rope pass ropes them) and its units (attn_f32.cuh: the
// call's query tile, from block.f32_frame_shape on the cooperative grid; a
// head's K and V in the GEMM ring's data region; a unit on the first 192
// or 128 threads of a block), attn_temporal_unit<hd, float> over the fp32
// cache for the temporal step. So each pair is bit-equal to the fp32
// sequential wrappers (#7 + #9, #6 + #9). The kernels hold the int8 tensor
// cores' instructions and no bf16 or TF32 one.
// Bound: bytes, the 12 MB of int8 weights at one or two frames. Each GELU
// mode has its own instantiation; the exact GELU's are in
// pair_q_f32_exact.cu, compiled beside this file.
#include "pair_q.cuh"

using namespace pairq;

namespace {

int launch_f32(int hd, bool temporal, const PairArgs& a,
               const PairMaps& maps, cudaStream_t st) {
  return a.exact_gelu ? launch_f32_exact(hd, temporal, a, maps, st)
                      : launch_hd<float, false>(hd, temporal, a, maps, st);
}

}  // namespace

// The fp32 kernels' cooperative grid for these shapes, or minus a CUDA
// error code (their own registers and shared memory).
GTAX_ENTRY gtax_pair_q_f32_blocks(int temporal, int hd, int S, int D) {
  return blocks_hd<float>(temporal, hd, S, D);
}

// gtax_pair_q's arguments with fp32 x, sh*/sc*/g*, k_ctx/v_ctx and out.
GTAX_ENTRY gtax_pair_q_f32(GTAX_PAIR_PARAMS) {
  return pair_call<float>(blocks_hd<float>, launch_f32, GTAX_PAIR_ARGS);
}
