"""The paired W8A8 serving kernels: one half of a DiT block, an attention
branch and the MLP branch after it, as one kernel call (counterpart of
gtax/kernels/pair.py).

Semantics are gtax's (gtax/kernels/pair.py:14-18): each pair equals the
two sequential int8 branch wrappers of gtax_torch.kernels.quant back to
back, bit for bit. The attention half's output is rounded to the compute
dtype exactly where the sequential pair stores it, and the MLP half is the
same per-chunk int8 arithmetic.

The tensor's device picks the path, as in quant.py: a CPU tensor gets the
plain version, which IS the sequential pair of plain versions
(`spatial_branch_q_plain` then `mlp_branch_q_plain`; `temporal_step_q_plain`
then `mlp_branch_q_plain`); a CUDA tensor gets one cooperative launch of
gtax_torch/csrc/pair_q.cu (nine phases separated by grid-wide barriers, each
phase the device code of the sequential kernels) or an exception. The
activations are bf16, or fp32 (x's dtype: the fp32 seam, output and context
cache of gtax's pair at x.dtype = float32), which launch the fp32 forms of
csrc/pair_q_f32.cu, bit-equal to the fp32 sequential wrappers. The int8
weights are read as quant.card_layout stores them. A device
that refuses a cooperative launch raises; nothing falls back to the
sequential wrappers. Each wrapper counts its launches in `launches`.
"""

from __future__ import annotations

import functools

import torch

from gtax_torch.kernels import block, build, capture, quant
from gtax_torch.kernels.block import _check_branch, _check_mat, _need, _stream

# int8 params and at most this many live frames take the pair
# (gtax/models/dit.py:705; a Hopper gate is for measurement to choose)
PAIR_MAX_FRAMES = 2


def spatial_pair_q_plain(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s, out_q,
                         out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s, b2,
                         rope_freqs, num_heads, approx_gelu=True):
    h = quant.spatial_branch_q_plain(x, sh1, sc1, g1, qkv_q, qkv_s, out_q,
                                     out_s, out_b, rope_freqs, num_heads)
    return quant.mlp_branch_q_plain(h, sh2, sc2, g2, w1_q, w1_s, b1, w2_q,
                                    w2_s, b2, approx_gelu)


def temporal_pair_q_plain(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s,
                          out_q, out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s,
                          b2, k_ctx, v_ctx, rope_freqs, valid, num_heads,
                          n_ctx, n_live=1, approx_gelu=True):
    h = quant.temporal_step_q_plain(x, sh1, sc1, g1, qkv_q, qkv_s, out_q,
                                    out_s, out_b, k_ctx, v_ctx, rope_freqs,
                                    valid, num_heads, n_ctx, n_live)
    return quant.mlp_branch_q_plain(h, sh2, sc2, g2, w1_q, w1_s, b1, w2_q,
                                    w2_s, b2, approx_gelu)


def _align256(n: int) -> int:
    return (n + 255) // 256 * 256


def gemm_shapes(D: int, Hd: int):
    """(N, K) of the pair's four int8 GEMMs: qkv, out-projection, fc1,
    fc2."""
    return ((3 * D, D), (D, D), (Hd, D), (D, Hd))


def workspace_bytes(M: int, D: int, Hd: int, G: int, chunks,
                    elem: int = 2) -> int:
    """Bytes of the pair kernel's workspace: the int8 LN rows and scales,
    fp32 qkv, fp32 attention, its int8 rows and scales, the seam (elem
    bytes an element: bf16, or 4 for the fp32 forms), the second LN's int8
    rows and scales, the fp32 GELU output and its int8 chunks and scales,
    and the int32 split-K partials of the GEMM that needs the most (chunks:
    the four GEMMs' K chunks), each on a 256-byte boundary
    (csrc/pair_q.cuh workspace_layout)."""
    part = max([-(-K // c) * M * N * 4
                for (N, K), c in zip(gemm_shapes(D, Hd), chunks)
                if -(-K // c) > 1], default=0)
    sizes = (M * D, M * 4, M * 3 * D * 4, M * D * 4, M * D, M * 4,
             M * D * elem, M * D, M * 4, M * Hd * 4, M * Hd,
             M * (Hd // G) * 4, part)
    return sum(_align256(s) for s in sizes)


def _entry(dtype) -> str:
    """The pair's C entry point for activations of `dtype`."""
    return "gtax_pair_q_f32" if dtype == torch.float32 else "gtax_pair_q"


def grid_blocks(temporal: bool, head_dim: int, S: int, D: int,
                dtype=torch.bfloat16, lib=None) -> int:
    """Blocks of the cooperative grid the pair kernel over `dtype`
    activations launches with (what co-resides on the card at its
    registers and shared-memory size), in `lib` (else the library)."""
    name = _entry(dtype) + "_blocks"
    n = getattr(lib or build.library(), name)(int(temporal), head_dim, S, D)
    if n <= 0:
        raise RuntimeError(f"{name}: CUDA error {-n}")
    return n


@functools.lru_cache(maxsize=None)
def gemm_chunks(M: int, D: int, Hd: int, G: int, blocks: int):
    """The K chunks of the pair's four GEMMs on a grid of `blocks`
    (quant.s8_plan; fc2's stay inside its K groups of G)."""
    return tuple(quant.s8_chunk(M, N, K, G if i == 3 else K, blocks)
                 for i, (N, K) in enumerate(gemm_shapes(D, Hd)))


def _check_pair(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s, out_q, out_s,
                out_b, w1_q, w1_s, b1, w2_q, w2_s, b2):
    N, S, D = _check_branch(x, sh1, sc1, g1)
    _check_branch(x, sh2, sc2, g2)
    for a, b in ((sh1, sc1), (sh2, sc2)):
        _need(a.stride(0) == b.stride(0),
              lambda: "shift and scale must share a row stride")
    quant._check_attn_weights_q(qkv_q, qkv_s, out_q, out_s, out_b, D)
    Hd = w1_q.shape[-1]
    block._check_hidden(Hd)
    quant._check_qlinear("w1", w1_q, w1_s, D, Hd)
    quant._check_qlinear("w2", w2_q, w2_s, Hd, D)
    block._check_bias("b1", b1, Hd)
    block._check_bias("b2", b2, D)
    G = Hd // quant._mlp_chunks(Hd)
    _need(max(D, G) <= quant.MAX_EXACT_K and G % 128 == 0,
          lambda: f"int8 K groups of D={D} and chunk {G}: each must be a "
                  f"multiple of 128 and at most {quant.MAX_EXACT_K}")
    return N, S, D, Hd, G


def _f32(t):
    return int(t.dtype == torch.float32)


def attn_shape(temporal, dtype, S, num_heads, n_frames, blocks):
    """The query tile of the fp32 spatial pair's attention phase: the fp32
    frame attention's rule (block.f32_frame_shape) on the pair's
    cooperative grid; 0 (unread) for the other forms."""
    if temporal or dtype != torch.float32:
        return 0
    return block.f32_frame_shape(S, num_heads, n_frames, blocks)


def _launch(temporal, x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s, out_q,
            out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s, b2, freqs, k_ctx,
            v_ctx, num_heads, Hd, G, B=0, n_live=0, n_ctx=0, bits=0,
            lib=None, extra=0, approx_gelu=True, shape=None):
    """One launch (of `lib`, else the library; x's dtype picks the bf16 or
    fp32 entry) with `extra` bytes past the workspace's buffers; fc1's GELU
    the tanh form (approx_gelu) or the exact one; shape: the fp32 spatial
    attention's query tile, attn_shape's by default; returns (out,
    workspace)."""
    N, S, D = x.shape
    M = N * S
    blocks = grid_blocks(temporal, D // num_heads, S, D, x.dtype, lib)
    if shape is None:
        shape = attn_shape(temporal, x.dtype, S, num_heads, N, blocks)
    chunks = gemm_chunks(M, D, Hd, G, blocks)
    size = workspace_bytes(M, D, Hd, G, chunks, x.element_size()) + extra
    ws = torch.empty(size, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    build.launch(
        _entry(x.dtype), int(temporal), x.data_ptr(), sh1.data_ptr(),
        sc1.data_ptr(), g1.data_ptr(), sh2.data_ptr(), sc2.data_ptr(),
        g2.data_ptr(), sh1.stride(0), g1.stride(0), sh2.stride(0),
        g2.stride(0), qkv_q.data_ptr(), qkv_s.data_ptr(), out_q.data_ptr(),
        out_s.data_ptr(), out_b.data_ptr(), _f32(out_b), w1_q.data_ptr(),
        w1_s.data_ptr(), b1.data_ptr(), _f32(b1), w2_q.data_ptr(),
        w2_s.data_ptr(), b2.data_ptr(), _f32(b2), freqs.data_ptr(),
        None if k_ctx is None else k_ctx.data_ptr(),
        None if v_ctx is None else v_ctx.data_ptr(), out.data_ptr(),
        ws.data_ptr(), size, M, S, D, Hd, G, num_heads, B, n_live, n_ctx,
        bits, *chunks, int(not approx_gelu), shape, _stream(x), lib=lib)
    return out, ws


def fused_spatial_pair_q(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s, out_q,
                         out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s, b2,
                         rope_freqs, num_heads, approx_gelu=True):
    """Spatial attention branch + spatial MLP branch as ONE kernel call:
    equals quant.fused_spatial_branch_q followed by quant.fused_mlp_branch_q
    (arguments as theirs, the branch vectors (N, D) of both halves first;
    approx_gelu: the MLP's GELU, as fused_mlp_branch_q's).

    Replaces gtax/kernels/pair.py fused_spatial_pair_q (pallas_call at :227,
    body _spatial_pair_kernel_q :114). On the card: one cooperative launch
    of csrc/pair_q.cu (pair_q_f32.cu for fp32 activations). Bound: the 12
    MB of int8 weights (bytes)."""
    block.forward_only("fused_spatial_pair_q", x, sh1, sc1, g1, sh2, sc2,
                       g2, out_b, b1, b2)
    if x.device.type == "cpu":
        return spatial_pair_q_plain(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q,
                                    qkv_s, out_q, out_s, out_b, w1_q, w1_s,
                                    b1, w2_q, w2_s, b2, rope_freqs,
                                    num_heads, approx_gelu)
    N, S, D, Hd, G = _check_pair(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s,
                                 out_q, out_s, out_b, w1_q, w1_s, b1, w2_q,
                                 w2_s, b2)
    d = block._check_heads(D, num_heads, (32, 64))
    block._check_freqs(rope_freqs, S, d)
    out = _launch(False, x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s, out_q,
                  out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s, b2, rope_freqs,
                  None, None, num_heads, Hd, G, approx_gelu=approx_gelu)[0]
    capture.launched(fused_spatial_pair_q)
    return out


fused_spatial_pair_q.launches = 0


def fused_temporal_pair_q(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s,
                          out_q, out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s,
                          b2, k_ctx, v_ctx, rope_freqs, valid, num_heads,
                          n_ctx, n_live=1, approx_gelu=True):
    """Incremental temporal step + temporal MLP branch as ONE kernel call:
    equals quant.fused_temporal_step_q followed by quant.fused_mlp_branch_q
    (approx_gelu: the MLP's GELU, as fused_mlp_branch_q's).
    x: (B * n_live, S, D), the live frames at window slots n_ctx ..
    n_ctx + n_live - 1; k_ctx/v_ctx: (B * n_ctx * S, D) post-rope cache;
    rope_freqs: (n_ctx + n_live, head_dim); valid: (T,) or None.

    Replaces gtax/kernels/pair.py fused_temporal_pair_q (pallas_call at
    :303, body _temporal_pair_kernel_q :152). On the card: one cooperative
    launch of csrc/pair_q.cu (pair_q_f32.cu for fp32 activations). Bound:
    the int8 weights (bytes); the bf16 context cache adds ~1.2 MB per batch
    element (fp32: ~2.4 MB)."""
    block.forward_only("fused_temporal_pair_q", x, sh1, sc1, g1, sh2, sc2,
                       g2, out_b, b1, b2, k_ctx, v_ctx)
    if x.device.type == "cpu":
        return temporal_pair_q_plain(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q,
                                     qkv_s, out_q, out_s, out_b, w1_q, w1_s,
                                     b1, w2_q, w2_s, b2, k_ctx, v_ctx,
                                     rope_freqs, valid, num_heads, n_ctx,
                                     n_live, approx_gelu)
    N, S, D, Hd, G = _check_pair(x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s,
                                 out_q, out_s, out_b, w1_q, w1_s, b1, w2_q,
                                 w2_s, b2)
    _need(N % n_live == 0,
          lambda: f"N={N} is not a multiple of n_live={n_live}")
    B = N // n_live
    _need(n_ctx >= 1, lambda: "the step needs at least one context frame")
    T = n_ctx + n_live
    d = block.check_temporal(D, num_heads, T, rope_freqs)
    _need(d in (32, 64), lambda: f"head dim {d}: the pair takes 32 or 64")
    for name, t in (("k_ctx", k_ctx), ("v_ctx", v_ctx)):
        _check_mat(name, t, (B * n_ctx * S, D), x.dtype)
    out = _launch(True, x, sh1, sc1, g1, sh2, sc2, g2, qkv_q, qkv_s, out_q,
                  out_s, out_b, w1_q, w1_s, b1, w2_q, w2_s, b2, rope_freqs,
                  k_ctx, v_ctx, num_heads, Hd, G, B, n_live, n_ctx,
                  block.valid_bits(valid, T), approx_gelu=approx_gelu)[0]
    capture.launched(fused_temporal_pair_q)
    return out


fused_temporal_pair_q.launches = 0
