"""W8A8 (int8 weights x int8 activations) twins of the fused DiT branches:
CUDA kernels on the card, plain PyTorch on the CPU.

Counterpart of gtax/kernels/quant.py, for serving and for int8-forward
training (emit_train: the branches' backward residuals, which
gtax_torch.nn.branches feeds to the bf16 backward kernels). The scheme is
gtax's:
  - weights: symmetric per-output-column int8 with fp32 scales, computed
    once by `quantize_weight` (gtax_torch.models.dit.quantize_for_inference);
    on the card the (in, out) int8 kernel is stored column-major
    (`card_layout`), as the int8 tensor cores read it (K-major), with the
    same values and shape;
  - activations: symmetric per-row int8, quantized dynamically from fp32
    (`quant_rows`: s = max(amax, 1e-12) * (1/127), q = round_half_even(
    a * (1/s)));
  - products accumulate exactly in int32 and are dequantized as
    (acc * s_row) * s_col before any bias.
The LN/modulate output is quantized from fp32 (it is never cast to bf16 on
this path), and so is the attention output. The MLP's GELU output is
requantized per H-chunk (`_mlp_chunks`: 8 chunks of 512 at H=4096), so fc2
sums its chunks in fp32, each scaled by its own per-row scale, in chunk
order. Everything else (LN statistics, rope, softmax, the gated residual)
rounds where the bf16 branches of gtax_torch.kernels.block round. The
emit_train residuals round where gtax's do (gtax/kernels/quant.py:91-160,
:267-338): q and k post-rope from the fp32 dequantized qkv, and v, cast to
x.dtype; y = acc * s_row * s_col + b once to x.dtype; the MLP's h1 = acc1 *
s_row * s_col + b1 to x.dtype before the GELU.

The tensor's device picks the path, as in block.py: a CPU tensor gets the
plain version (`*_q_plain`), a CUDA tensor gets the sm_90a kernels of
gtax_torch/csrc (`ln_mod` int8 mode, `gemm_s8`, `quant_rows`, and the
fp32-output modes of `attn_frame` / `attn_temporal`) or an exception.
The int8 GEMM has two forms, picked by rows (`s8_form`): below
S8_TRAIN_ROWS the weight-streaming tile (`gemm_s8`: all rows of a step in
one unit, split K), from it the training form (`gemm_s8_train`:
persistent 128-row tiles, K whole, fc1's requantization in its epilogue);
both give the same bits.
The activations' dtype is x's: bf16, or fp32 (gtax's kernels at x.dtype =
float32, as gtax serves dtype="float32" with int8): there every cast to
x.dtype is a no-op, the int8 rows are quantized from fp32 values as in
bf16, and the fp32 forms run: `ln_mod`'s int8 mode over fp32 rows, the
fp32 attention kernels (`attn_frame_f32`, `attn_temporal_f32` with its
fp32 K/V outputs for emit_kv) and `gemm_s8`'s fp32 gated epilogue, over
an fp32 context cache. fp32 emit_train (int8-forward training at
compute_dtype float32) stores its residuals unrounded: the fp32 q/k/v of
`attn_frame_f32` and `attn_temporal_f32`, and `gemm_s8`'s epilogues 5-7
(fp32 h1 and y beside the fp32 GELU and gated outputs, instantiations of
their own). Each wrapper counts its kernel-launching calls in `launches`.
"""

from __future__ import annotations

import functools

import torch

from gtax_torch.core.rope import apply_rotary_emb as rope
from gtax_torch.kernels import block, build, capture
from gtax_torch.kernels.block import (
    _check_bias,
    _check_branch,
    _check_freqs,
    _check_heads,
    _check_hidden,
    _check_mat,
    _need,
    _stream,
    attend_frames,
    attend_temporal,
    gelu32,
    gelu_tanh32,  # noqa: F401  (quant.gelu_tanh32, as before)
    modulated32,
    temporal_bias,
    valid_bits,
)

F32, I8 = torch.float32, torch.int8

# gemm_s8 epilogues (csrc/gemm_s8.cu)
EPI_F32 = 0
EPI_BIAS_GELU_F32 = 1
EPI_BIAS_GATED = 2
EPI_BIAS_GELU_ERF_F32 = 3  # epilogue 1 with the exact GELU
EPI_BIAS_GATED_F32 = 4  # epilogue 2 over fp32 x and gate, stored fp32
# the fp32 emit_train forms: 1, 3 and 4 with an fp32 second output y + b
EPI_BIAS_GELU_F32_H = 5
EPI_BIAS_GELU_ERF_F32_H = 6
EPI_BIAS_GATED_F32_Y = 7

# int8 products summed in fp32 are exact while every partial sum stays an
# integer below 2**24: at most 1040 terms of 127 * 127
MAX_EXACT_K = (2**24 - 1) // (127 * 127)


# ----------------------------------------------------------- plain parts

def quantize_weight(w):
    """Symmetric per-output-column int8: w ~= q * s, s: (..., 1, dout)
    fp32, for (din, dout) kernels and stacked (L, din, dout) arrays; on the
    card q is stored in card_layout."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    s = amax.clamp_min(1e-12) / 127.0
    q = torch.round(w32 / s).to(I8)
    return (card_layout(q) if q.is_cuda else q), s


def card_layout(w_q):
    """An (in, out) int8 kernel (or a stack of them) stored column-major:
    the same values and shape, each output column's `in` weights
    contiguous, which is W^T (out, in) row-major, the K-major operand the
    int8 tensor cores read (csrc/gemm_s8.cuh). A copy made once, when the
    params are prepared for the card; unchanged if already so."""
    return w_q.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_card_layout(w_q) -> bool:
    return (w_q.dim() >= 2 and w_q.stride(-2) == 1
            and w_q.stride(-1) == w_q.shape[-2])


def quant_rows(a32, group=None):
    """Dynamic symmetric int8 of fp32 rows, one scale per `group` columns
    (default: the whole row). Returns (q int8 of a32's shape, s fp32 of
    shape (..., cols // group)) with a ~= q * s."""
    cols = a32.shape[-1]
    G = group or cols
    a = a32.reshape(*a32.shape[:-1], cols // G, G)
    s = a.abs().amax(-1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    q = torch.round(a * (1.0 / s)).to(I8)
    return q.reshape(a32.shape), s.squeeze(-1)


def mm_int(q, w_q):
    """Exact int8 product as fp32 values: the operands' int8 values in fp32
    with fp32 accumulation (exact up to MAX_EXACT_K terms; on the card it
    needs strict_matmul, i.e. no TF32)."""
    if q.shape[-1] > MAX_EXACT_K:
        raise ValueError(f"K={q.shape[-1]} exceeds the exact fp32 range of "
                         f"int8 products ({MAX_EXACT_K})")
    return torch.matmul(q.float(), w_q.float())


def qdot(a32, w_q, w_s):
    """fp32 rows -> per-row int8 -> int8 product -> (acc * s_row) * s_col
    (gtax/kernels/quant.py _qdot)."""
    q, sa = quant_rows(a32)
    return mm_int(q, w_q) * sa * w_s.reshape(-1)


def s8_fold_plain(q, sa, w_q, w_s):
    """The int8 product as the card's GEMMs fold it (the plain version of
    gemm_s8 and gemm_s8_train before their epilogues): each K group's
    exact sum times its row scale (sa: (M, groups)), added in group order
    from 0, times the column scale."""
    group = q.shape[-1] // sa.shape[-1]
    acc = torch.zeros((*q.shape[:-1], w_q.shape[-1]), device=q.device)
    for g in range(sa.shape[-1]):
        cols = slice(g * group, (g + 1) * group)
        acc = acc + mm_int(q[..., cols], w_q[cols]) * sa[..., g:g + 1]
    return acc * w_s.reshape(-1)


def requant_plain(u, approx_gelu, group):
    """The MLP's hidden requantization: the GELU (tanh or exact) of the
    fp32 fc1 rows u + b1, then per-row int8 in groups of `group` columns
    (gtax's _quant_rows of each H-chunk). Returns (hq, hs)."""
    return quant_rows(gelu32(approx_gelu)(u), group)


def fc1_quant_plain(a32, w1_q, w1_s, b1, approx_gelu, group, dtype):
    """The plain version of fc1's training form (gemm_s8_train with the
    requantization in its epilogue): u = dequant(int8 rows of a32 @ w1_q)
    + b1 in fp32; returns (h1 = u in dtype, hq, hs), hq and hs
    requant_plain's of u."""
    u = qdot(a32, w1_q, w1_s) + b1.float()
    return (u.to(dtype), *requant_plain(u, approx_gelu, group))


def _mlp_chunks(h: int) -> int:
    """gtax's H split for the int8 MLP: the largest of 8, 4, 2 whose chunk
    width is a multiple of 128, else 1 (gtax/kernels/quant.py
    _mlp_chunks)."""
    for nc in (8, 4, 2):
        if h % nc == 0 and (h // nc) % 128 == 0:
            return nc
    return 1


def _gated(x32, gate, y, dtype):
    return (x32 + gate.float()[:, None] * y).to(dtype)


# ------------------------------------------------------ plain branches

def spatial_branch_q_plain(x, shift, scale, gate, qkv_q, qkv_s, out_q,
                           out_s, out_b, rope_freqs, num_heads,
                           emit_train=False):
    N, S, D = x.shape
    dt, H = x.dtype, num_heads
    x32 = x.float()
    qkv = qdot(modulated32(x32, shift, scale), qkv_q, qkv_s)
    q, k, v = (t.reshape(N, S, H, D // H) for t in qkv.split(D, dim=-1))
    f = rope_freqs[:, None, :]
    qr, kr, vb = rope(f, q).to(dt), rope(f, k).to(dt), v.to(dt)
    o = attend_frames(qr, kr, vb, dt, F32)
    y = qdot(o.reshape(N, S, D), out_q, out_s) + out_b.float()
    out = _gated(x32, gate, y, dt)
    if emit_train:
        return (out, *(t.reshape(N, S, D) for t in (qr, kr, vb)),
                y.to(dt))
    return out


def mlp_branch_q_plain(x, shift, scale, gate, w1_q, w1_s, b1, w2_q, w2_s,
                       b2, approx_gelu=True, emit_train=False):
    x32 = x.float()
    Hd = w1_q.shape[-1]
    nc = _mlp_chunks(Hd)
    G = Hd // nc
    h1, hq, hs = fc1_quant_plain(modulated32(x32, shift, scale), w1_q, w1_s,
                                 b1, approx_gelu, G, x.dtype)
    acc = torch.zeros_like(x32)
    for c in range(nc):  # chunk order, as the TPU kernel's grid
        cols = slice(c * G, (c + 1) * G)
        acc = acc + mm_int(hq[..., cols], w2_q[cols]) * hs[..., c:c + 1]
    y = acc * w2_s.reshape(-1) + b2.float()
    out = _gated(x32, gate, y, x.dtype)
    if emit_train:  # h1 before the GELU, column by column as gtax's chunks
        return out, h1, y.to(x.dtype)
    return out


def temporal_branch_q_plain(x, shift, scale, gate, qkv_q, qkv_s, out_q,
                            out_s, out_b, rope_freqs, valid, num_heads,
                            n_frames, emit_kv=False, emit_train=False):
    block.check_emit(emit_kv, emit_train)
    N, S, D = x.shape
    dt, H, T = x.dtype, num_heads, n_frames
    B = N // T
    x32 = x.float()
    qkv = qdot(modulated32(x32, shift, scale), qkv_q, qkv_s)
    q, k, v = (t.reshape(B, T, S, H, D // H) for t in qkv.split(D, dim=-1))
    f = rope_freqs[None, :, None, None, :]
    qr, kr, vb = rope(f, q).to(dt), rope(f, k).to(dt), v.to(dt)
    o = attend_temporal(qr, kr, vb, temporal_bias(valid, T, x.device), dt,
                        F32)
    y = qdot(o.reshape(N, S, D), out_q, out_s) + out_b.float()
    out = _gated(x32, gate, y, dt)
    if emit_kv:
        return out, kr.reshape(N, S, D), vb.reshape(N, S, D)
    if emit_train:
        return (out, *(t.reshape(N, S, D) for t in (qr, kr, vb)),
                y.to(dt))
    return out


def temporal_step_q_plain(x, shift, scale, gate, qkv_q, qkv_s, out_q, out_s,
                          out_b, k_ctx, v_ctx, rope_freqs, valid, num_heads,
                          n_ctx, n_live=1):
    N, S, D = x.shape
    dt, H = x.dtype, num_heads
    B, T = N // n_live, n_ctx + n_live
    d = D // H
    x32 = x.float()
    qkv = qdot(modulated32(x32, shift, scale), qkv_q, qkv_s)
    q, k, v = (t.reshape(B, n_live, S, H, d) for t in qkv.split(D, dim=-1))
    f = rope_freqs[n_ctx:T][None, :, None, None, :]
    keys = torch.cat([k_ctx.reshape(B, n_ctx, S, H, d).to(dt),
                      rope(f, k).to(dt)], dim=1)
    vals = torch.cat([v_ctx.reshape(B, n_ctx, S, H, d).to(dt), v.to(dt)],
                     dim=1)
    bias = temporal_bias(valid, T, x.device)[n_ctx:]
    o = attend_temporal(rope(f, q).to(dt), keys, vals, bias, dt, F32)
    y = qdot(o.reshape(N, S, D), out_q, out_s) + out_b.float()
    return _gated(x32, gate, y, dt)


# --------------------------------------------------- the int8 plan

# in k-steps: a unit's fixed cost (ring fill, epilogue), and a chunk's
# partial (stored, then read by the split sum after the grid barrier);
# gemm_sweep --int8 and the pair's chunk variants (PERF.md section 6)
S8_UNIT_STEPS = 3.0
S8_PARTIAL_STEPS = 0.5


def s8_cost(M, N, K, group, blocks, rows, tile_n, k_step, chunk_steps):
    """(relative time, splits) of the int8 GEMM with K chunks of
    chunk_steps k-steps on `blocks` co-resident blocks: the waves of units,
    each streaming its chunk, plus the chunks' partials."""
    tiles = -(-M // rows) * (N // tile_n)
    splits = -(-(K // k_step) // chunk_steps)
    waves = -(-tiles * splits // blocks)
    cost = waves * (chunk_steps + S8_UNIT_STEPS)
    if splits > 1:
        cost += splits * S8_PARTIAL_STEPS
    return cost, splits


def s8_plan(M, N, K, group, blocks, rows, tile_n, k_step, max_splits):
    """K chunk of the int8 GEMM (csrc/gemm_s8.cuh units: every row up to
    `rows` in one unit, so each weight byte is read once, K split so the
    units spread the read over the blocks): of the chunks of whole k-steps
    (inside one K group where K has several; at most max_splits chunks),
    the one s8_cost finds cheapest, the longer on a tie."""
    steps, g_steps = K // k_step, group // k_step
    best = None
    for c in range(steps, 0, -1):
        if (group < K and g_steps % c) or -(-steps // c) > max_splits:
            continue
        cost = s8_cost(M, N, K, group, blocks, rows, tile_n, k_step, c)[0]
        if best is None or cost < best[0]:
            best = (cost, c)
    return best[1] * k_step


@functools.lru_cache(maxsize=None)
def s8_chunk(M, N, K, group, blocks):
    """s8_plan at the library's unit."""
    c = build.gemm_consts()
    return s8_plan(M, N, K, group, blocks, c.s8_rows, c.s8_n, c.s8_k_step,
                   c.s8_splits)


# The training form (csrc/gemm_s8_train.cuh: persistent, 128-row tiles, K
# whole, each K group folded in registers): every int8 product from this
# many rows takes it, the least row count from which it beats the
# weight-streaming tile at all four products (gemm_sweep.py --int8);
# below, the streaming tile, as the pairs (csrc/pair_q.cuh) always.
S8_TRAIN_ROWS = 1440
S8_TRAIN_K_STEP = 128  # its k-step (a K group is a whole number of them)
# fc1's requantization group in the fused form (_mlp_chunks' 512 at H =
# 4096): a cluster of two 128 x 256 tiles
S8_QGROUP = 512
# the epilogues the training form builds with several K groups (fc2's);
# EPI_F32 it builds with one (qkv), the GELU ones with one and fc1's
# requantization only (gemm_s8_train.cu)
S8_TRAIN_GATED = (EPI_BIAS_GATED, EPI_BIAS_GATED_F32, EPI_BIAS_GATED_F32_Y)
S8_TRAIN_GELU = (EPI_BIAS_GELU_F32, EPI_BIAS_GELU_ERF_F32,
                 EPI_BIAS_GELU_F32_H, EPI_BIAS_GELU_ERF_F32_H)


def s8_form(M):
    """The int8 GEMM's form at M rows: "train" or "stream"."""
    return "train" if M >= S8_TRAIN_ROWS else "stream"


def s8_train_tile(N, K, group):
    """The training form's tile columns for a product: 256 with one K
    group (qkv, out, fc1: each B stage read for twice the products), 128
    with several (fc2: the fp32 fold beside the int32 sums), as
    gemm_sweep.py --int8 measured them; the kernel derives the same."""
    return 256 if group == K else 128


def s8_train_builds(epi, groups, requant):
    """Whether the training form has a kernel for epilogue `epi` over
    `groups` K groups, with fc1's requantization (requant) or without."""
    if epi in S8_TRAIN_GELU:
        return requant and groups == 1
    return not requant and (epi in S8_TRAIN_GATED or groups == 1)


def s8_plan_of(M, N, K, group, blocks):
    """The int8 GEMM's plan at M rows: {"form", "tile" (rows, columns of
    a tile or a unit), "k_chunk", "splits", "partials_mb" (the int32
    partials the split stores)}."""
    if s8_form(M) == "train":
        return {"form": "train", "tile": [128, s8_train_tile(N, K, group)],
                "k_chunk": K, "splits": 1, "partials_mb": 0.0}
    c = build.gemm_consts()
    chunk = s8_chunk(M, N, K, group, blocks)
    splits = -(-K // chunk)
    return {"form": "stream", "tile": [c.s8_rows, c.s8_n], "k_chunk": chunk,
            "splits": splits,
            "partials_mb": splits * M * N * 4 / 1e6 if splits > 1 else 0.0}


# ------------------------------------------------------- kernel launches

def _check_scale(name, s, n):
    _need(s.is_cuda and s.dtype == F32 and s.numel() == n
          and s.is_contiguous(),
          lambda: f"{name} must be a contiguous CUDA fp32 tensor of {n} "
                  f"scales, got {block._desc(s)}")


def _check_qlinear(name, w_q, w_s, din, dout):
    _need(w_q.is_cuda and w_q.dtype == I8 and w_q.shape == (din, dout)
          and is_card_layout(w_q),
          lambda: f"{name}_q must be a CUDA int8 ({din}, {dout}) kernel "
                  f"stored column-major (quantize_weight on the card, or "
                  f"card_layout), got {block._desc(w_q)} strides "
                  f"{tuple(w_q.stride())}")
    _check_scale(f"{name}_s", w_s, dout)


def _check_attn_weights_q(qkv_q, qkv_s, out_q, out_s, out_b, D):
    _check_qlinear("qkv", qkv_q, qkv_s, D, 3 * D)
    _check_qlinear("out", out_q, out_s, D, D)
    _check_bias("out_b", out_b, D)


def _ln_mod_q(x, shift, scale):
    """int8 LN/modulate rows of x (bf16 or fp32) and their fp32 scales,
    (N*S, 1)."""
    N, S, D = x.shape
    _need(shift.stride(0) == scale.stride(0),
          lambda: "shift and scale must share a row stride")
    q = torch.empty((N * S, D), dtype=I8, device=x.device)
    s = torch.empty((N * S, 1), dtype=F32, device=x.device)
    block.launch_ln_mod(x, q, N * S, D, S, block.LN_INT8, shift, scale,
                        shift.stride(0), row_scale=s)
    return q, s


def _quant_rows_cuda(a, group):
    rows, cols = a.shape
    q = torch.empty((rows, cols), dtype=I8, device=a.device)
    s = torch.empty((rows, cols // group), dtype=F32, device=a.device)
    build.launch("gtax_quant_rows", a.data_ptr(), q.data_ptr(), s.data_ptr(),
                 rows, cols, group, _stream(a))
    return q, s


def _epi_args(out, bias, resid, gate):
    """The epilogue's pointers of a gemm_s8 / gemm_s8_train launch: C,
    bias, bias_f32, resid, gate, gate_stride."""
    return (block._ptr(out), None if bias is None else bias.data_ptr(),
            int(bias is not None and bias.dtype == F32),
            None if resid is None else resid.data_ptr(),
            None if gate is None else gate.data_ptr(),
            0 if gate is None else gate.stride(0))


def gemm_s8_train(a, sa, w_q, w_s, out, epi, bias=None, resid=None,
                  gate=None, S=1, out2=None, hq=None, hs=None):
    """The int8 GEMM's training form on CUDA tensors (csrc/gemm_s8_train.cuh):
    _gemm_s8's arguments without the split; hq, hs: fc1's requantized GELU
    rows ((M, N) int8, (M, N // S8_QGROUP) fp32; a GELU epilogue, one K
    group, out None). Its tile is s8_train_tile's; a product it builds no
    kernel for (s8_train_builds) raises.
    Its plain versions: s8_fold_plain and the epilogue, fc1_quant_plain.
    Counts its launches in `launches`."""
    M, K = a.shape
    N = w_q.shape[1]
    group = K // sa.shape[1]
    _need(a.is_cuda, lambda: "gemm_s8_train takes CUDA tensors")
    tile = s8_train_tile(N, K, group)
    _need(N % tile == 0 and s8_train_builds(epi, K // group, hq is not None),
          lambda: f"gemm_s8_train: no kernel for epilogue {epi} at N={N}, "
                  f"K={K} in groups of {group}"
                  + (" with the requantization" if hq is not None else ""))
    C, b, b32, r, g, gs = _epi_args(out, bias, resid, gate)
    build.launch(
        "gtax_gemm_s8_train", a.data_ptr(), w_q.data_ptr(), C,
        block._ptr(out2), sa.data_ptr(), group, w_s.data_ptr(), b, b32, r, g,
        gs, M, N, K, S, epi, block._ptr(hq), block._ptr(hs), _stream(a))
    capture.launched(gemm_s8_train)


gemm_s8_train.launches = 0


def _gemm_s8(a, sa, w_q, w_s, out, epi, bias=None, resid=None, gate=None,
             S=1, k_chunk=None, out2=None, form=None):
    """out = epilogue(dequant(a @ w_q)); sa (M, K // group) row-group
    scales, the group width following from sa's shape; w_q in card_layout;
    out2: the bf16 y + bias of the GELU epilogues / EPI_BIAS_GATED
    (emit_train), or the fp32 one of epilogues 5-7. form: "stream" (the
    weight-streaming tile, gemm_s8; k_chunk: its split-K chunk, s8_chunk's
    by default) or "train" (gemm_s8_train), s8_form's by default."""
    M, K = a.shape
    N = w_q.shape[1]
    group = K // sa.shape[1]
    _need(group <= MAX_EXACT_K and group % 128 == 0,
          lambda: f"int8 K group of {group}: must be a multiple of 128 and "
                  f"at most {MAX_EXACT_K}")
    form = form or s8_form(M)
    _need(form in ("stream", "train"),
          lambda: f"int8 GEMM form {form!r}: 'stream' or 'train'")
    if form == "train":
        _need(k_chunk is None,
              lambda: "the training form takes K whole: no k_chunk")
        gemm_s8_train(a, sa, w_q, w_s, out, epi, bias, resid, gate, S, out2)
        return
    if k_chunk is None:
        k_chunk = s8_chunk(M, N, K, group, block.sm_count(a.device))
    splits = -(-K // k_chunk)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.int32,
                           device=a.device)
    C, b, b32, r, g, gs = _epi_args(out, bias, resid, gate)
    build.launch(
        "gtax_gemm_s8", a.data_ptr(), w_q.data_ptr(), C, block._ptr(out2),
        sa.data_ptr(), group, w_s.data_ptr(), b, b32, r, g, gs, M, N, K, S,
        epi, k_chunk, block._ptr(part), _stream(a))


def _fc1_quant_cuda(a, sa, w_q, w_s, bias, epi, h1, group):
    """fc1 on the training form with the requantization of its GELU rows
    in its epilogue: (hq (M, N) int8, hs (M, N // group) fp32), as
    _quant_rows_cuda of epilogue `epi`'s output; h1: its second output
    (y + bias, or None)."""
    M, N = a.shape[0], w_q.shape[1]
    _need(group == S8_QGROUP,
          lambda: f"the fused requantization takes groups of {S8_QGROUP}, "
                  f"not {group}")
    hq = torch.empty((M, N), dtype=I8, device=a.device)
    hs = torch.empty((M, N // group), dtype=F32, device=a.device)
    gemm_s8_train(a, sa, w_q, w_s, None, epi, bias=bias, out2=h1, hq=hq,
                  hs=hs)
    return hq, hs


def _qkv_cuda(x, shift, scale, qkv_q, qkv_s):
    """fp32 qkv rows (N*S, 3D) of the int8 qkv product."""
    mq, ms = _ln_mod_q(x, shift, scale)
    qkv = torch.empty((mq.shape[0], qkv_q.shape[1]), dtype=F32,
                      device=x.device)
    _gemm_s8(mq, ms, qkv_q, qkv_s, qkv, EPI_F32)
    return qkv


def _out_cuda(att, x, gate, out_q, out_s, out_b, y=None):
    """x + gate * (int8 out-projection of the fp32 attention rows + b);
    y: the pre-gate rows' output in x's dtype (emit_train), or None."""
    aq, as_ = _quant_rows_cuda(att, att.shape[1])
    out = torch.empty_like(x)
    _gemm_s8(aq, as_, out_q, out_s, out, _gated_epi(x, y is not None),
             bias=out_b, resid=x, gate=gate, S=x.shape[1], out2=y)
    return out


def _gated_epi(x, emit=False):
    """The gated residual's epilogue in x's dtype (emit: with the second
    output y, fp32's its own instantiation)."""
    if x.dtype == F32:
        return EPI_BIAS_GATED_F32_Y if emit else EPI_BIAS_GATED_F32
    return EPI_BIAS_GATED


def _gelu_epi(x, approx_gelu, emit=False):
    """fc1's epilogue: the GELU over fp32 h; with emit, also h1 (bf16 by
    epilogues 1 / 3's second store, fp32 by 5 / 6 over fp32 x)."""
    if emit and x.dtype == F32:
        return EPI_BIAS_GELU_F32_H if approx_gelu else EPI_BIAS_GELU_ERF_F32_H
    return EPI_BIAS_GELU_F32 if approx_gelu else EPI_BIAS_GELU_ERF_F32


def _emit_train_outputs(x):
    """The emit_train residuals' buffers: q, k, v, y, each like x."""
    return tuple(torch.empty_like(x) for _ in range(4))


# ------------------------------------------------------------- wrappers

def fused_spatial_branch_q(x, shift, scale, gate, qkv_q, qkv_s, out_q,
                           out_s, out_b, rope_freqs, num_heads,
                           emit_train=False):
    """int8 twin of block.fused_spatial_branch: qkv_q (D, 3D) / out_q (D, D)
    int8 with per-column fp32 scales qkv_s / out_s ((1, n) or (n,)). With
    emit_train, (out, q, k, v, y), all (N, S, D) in x's dtype: the
    post-rope q and k, the cast v and the pre-gate y.

    Replaces gtax/kernels/quant.py fused_spatial_branch_q (pallas_call at
    :368, body _spatial_kernel_q :91). On the card: ln_mod (int8 + row
    scales) -> gemm_s8 (fp32 qkv) -> attn_frame (fp32 out; with
    emit_train it also stores the bf16 q, k, v it attends with) ->
    quant_rows -> gemm_s8 (+bias, gated residual; with emit_train also the
    bf16 y): 5 launches, the two products on gemm_s8_train from
    S8_TRAIN_ROWS rows. Bound: the 4 MB of int8 qkv/out weights at the
    serving row counts (bytes), operations at training's."""
    block.forward_only("fused_spatial_branch_q", x, shift, scale, gate,
                       out_b)
    if x.device.type == "cpu":
        return spatial_branch_q_plain(x, shift, scale, gate, qkv_q, qkv_s,
                                      out_q, out_s, out_b, rope_freqs,
                                      num_heads, emit_train)
    N, S, D = _check_branch(x, shift, scale, gate)
    _check_attn_weights_q(qkv_q, qkv_s, out_q, out_s, out_b, D)
    d = _check_heads(D, num_heads, (32, 64))
    _check_freqs(rope_freqs, S, d)
    qkv = _qkv_cuda(x, shift, scale, qkv_q, qkv_s)
    att = torch.empty((N * S, D), dtype=F32, device=x.device)
    res = _emit_train_outputs(x) if emit_train else None
    if x.dtype == F32:
        block.launch_attn_frame_f32(qkv, rope_freqs, att, N, S, D,
                                    num_heads, d, qkv_out=res and res[:3])
    else:
        block.launch_attn_frame(qkv, rope_freqs, att, N, S, D, num_heads, d,
                                qkv_out=res and res[:3])
    out = _out_cuda(att, x, gate, out_q, out_s, out_b, res and res[3])
    capture.launched(fused_spatial_branch_q)
    return (out, *res) if emit_train else out


fused_spatial_branch_q.launches = 0


def fused_mlp_branch_q(x, shift, scale, gate, w1_q, w1_s, b1, w2_q, w2_s,
                       b2, approx_gelu=True, emit_train=False):
    """int8 twin of block.fused_mlp_branch: w1_q (D, H), w2_q (H, D) int8
    with per-column fp32 scales; the tanh GELU (approx_gelu) or the exact
    one, on fp32 h = acc * s_row * s_col + b1 before the requantization
    (gtax/kernels/quant.py:322); the hidden activation
    requantized per H-chunk (_mlp_chunks). With emit_train, (out, h1
    (N, S, H), y (N, S, D)) in x's dtype: the pre-GELU fc1 output and the
    pre-gate y.

    Replaces gtax/kernels/quant.py fused_mlp_branch_q (pallas_call at :530,
    body _mlp_kernel_q :267). On the card: ln_mod (int8) -> gemm_s8 (+b1,
    GELU, fp32; with emit_train also the bf16 h1 before the GELU) ->
    quant_rows (one scale per row and chunk) -> gemm_s8 (K grouped by
    chunk, +b2, gated residual; with emit_train also the bf16 y): 4
    launches; from S8_TRAIN_ROWS rows, ln_mod -> gemm_s8_train (fc1 with
    the requantization in its epilogue: no fp32 h) -> gemm_s8_train (fc2,
    its K groups folded in registers): 3. Bound: the 8 MB of int8 fc1/fc2
    weights at serving row counts (bytes), operations at training's."""
    block.forward_only("fused_mlp_branch_q", x, shift, scale, gate, b1, b2)
    if x.device.type == "cpu":
        return mlp_branch_q_plain(x, shift, scale, gate, w1_q, w1_s, b1,
                                  w2_q, w2_s, b2, approx_gelu, emit_train)
    N, S, D = _check_branch(x, shift, scale, gate)
    Hd = w1_q.shape[-1]
    _check_hidden(Hd)
    _check_qlinear("w1", w1_q, w1_s, D, Hd)
    _check_qlinear("w2", w2_q, w2_s, Hd, D)
    _check_bias("b1", b1, Hd)
    _check_bias("b2", b2, D)
    mq, ms = _ln_mod_q(x, shift, scale)
    h1 = (torch.empty((N, S, Hd), dtype=x.dtype, device=x.device)
          if emit_train else None)
    G = Hd // _mlp_chunks(Hd)
    epi = _gelu_epi(x, approx_gelu, emit_train)
    if s8_form(N * S) == "train" and G == S8_QGROUP:
        hq, hs = _fc1_quant_cuda(mq, ms, w1_q, w1_s, b1, epi, h1, G)
    else:  # the training form builds its GELU epilogues fused only
        h = torch.empty((N * S, Hd), dtype=F32, device=x.device)
        _gemm_s8(mq, ms, w1_q, w1_s, h, epi, bias=b1, out2=h1, form="stream")
        hq, hs = _quant_rows_cuda(h, G)
    out = torch.empty_like(x)
    y = torch.empty_like(x) if emit_train else None
    _gemm_s8(hq, hs, w2_q, w2_s, out, _gated_epi(x, emit_train), bias=b2,
             resid=x, gate=gate, S=S, out2=y)
    capture.launched(fused_mlp_branch_q)
    return (out, h1, y) if emit_train else out


fused_mlp_branch_q.launches = 0


def _temporal_q_cuda(x, shift, scale, gate, qkv_q, qkv_s, out_q, out_s,
                     out_b, rope_freqs, num_heads, B, n_q, q_off, bits,
                     k_ctx=None, v_ctx=None, emit_kv=False,
                     emit_train=False):
    N, S, D = x.shape
    block.check_temporal(D, num_heads, q_off + n_q, rope_freqs)
    _check_attn_weights_q(qkv_q, qkv_s, out_q, out_s, out_b, D)
    qkv = _qkv_cuda(x, shift, scale, qkv_q, qkv_s)
    att = torch.empty((N * S, D), dtype=F32, device=x.device)
    res = _emit_train_outputs(x) if emit_train else None
    kv_out = ((torch.empty_like(x), torch.empty_like(x)) if emit_kv
              else res and res[1:3])
    if x.dtype == F32:  # the K/V cache (and residuals) in fp32, as x
        block.launch_attn_temporal_f32(qkv, rope_freqs, att, B, n_q, q_off,
                                       S, D, num_heads, bits, k_ctx, v_ctx,
                                       kv_out, q_out=res and res[0])
    else:
        block.launch_attn_temporal(qkv, rope_freqs, att, B, n_q, q_off, S,
                                   D, num_heads, bits, k_ctx, v_ctx, kv_out,
                                   q_out=res and res[0])
    out = _out_cuda(att, x, gate, out_q, out_s, out_b, res and res[3])
    if emit_train:
        return (out, *res)
    return out if kv_out is None else (out, *kv_out)


def fused_temporal_branch_q(x, shift, scale, gate, qkv_q, qkv_s, out_q,
                            out_s, out_b, rope_freqs, valid, num_heads,
                            n_frames, emit_kv=False, emit_train=False):
    """int8 twin of block.fused_temporal_branch (same arguments, int8
    weights with per-column scales); with emit_kv also the post-rope K and
    cast V rows, the context cache fused_temporal_step_q reads; with
    emit_train (not both) (out, q, k, v, y), gtax's order (its kernel's
    (o, k, v, q, y) reordered, gtax/kernels/quant.py:446-449).

    Replaces gtax/kernels/quant.py fused_temporal_branch_q (pallas_call at
    :427, body _temporal_kernel_q :127). On the card: ln_mod (int8) ->
    gemm_s8 (fp32 qkv) -> attn_temporal (full window, fp32 out, optional
    K/V store, and Q with emit_train) -> quant_rows -> gemm_s8 (gated
    residual; y with emit_train): 5 launches. Bound: int8 weight bytes at
    the prefill's rows, operations at training's."""
    block.check_emit(emit_kv, emit_train)
    block.forward_only("fused_temporal_branch_q", x, shift, scale, gate,
                       out_b)
    if x.device.type == "cpu":
        return temporal_branch_q_plain(x, shift, scale, gate, qkv_q, qkv_s,
                                       out_q, out_s, out_b, rope_freqs,
                                       valid, num_heads, n_frames, emit_kv,
                                       emit_train)
    N, S, D = _check_branch(x, shift, scale, gate)
    _need(N % n_frames == 0,
          lambda: f"N={N} is not a multiple of T={n_frames}")
    out = _temporal_q_cuda(x, shift, scale, gate, qkv_q, qkv_s, out_q, out_s,
                           out_b, rope_freqs, num_heads, N // n_frames,
                           n_frames, 0, valid_bits(valid, n_frames),
                           emit_kv=emit_kv, emit_train=emit_train)
    capture.launched(fused_temporal_branch_q)
    return out


fused_temporal_branch_q.launches = 0


def fused_temporal_step_q(x, shift, scale, gate, qkv_q, qkv_s, out_q, out_s,
                          out_b, k_ctx, v_ctx, rope_freqs, valid, num_heads,
                          n_ctx, n_live=1):
    """int8 twin of block.fused_temporal_step: the live frames' rows
    against the cached post-rope context K/V (x's dtype, from
    fused_temporal_branch_q emit_kv).

    Replaces gtax/kernels/quant.py fused_temporal_step_q (pallas_call at
    :216/:243, body _temporal_step_kernel_q :163). On the card: ln_mod
    (int8) -> gemm_s8 (fp32 qkv) -> attn_temporal (step mode, fp32 out) ->
    quant_rows -> gemm_s8 (gated residual): 5 launches. Bound: int8 weight
    bytes; the bf16 context cache adds ~1.2 MB per batch element (fp32:
    ~2.4 MB)."""
    block.forward_only("fused_temporal_step_q", x, shift, scale, gate,
                       out_b, k_ctx, v_ctx)
    if x.device.type == "cpu":
        return temporal_step_q_plain(x, shift, scale, gate, qkv_q, qkv_s,
                                     out_q, out_s, out_b, k_ctx, v_ctx,
                                     rope_freqs, valid, num_heads, n_ctx,
                                     n_live)
    N, S, D = _check_branch(x, shift, scale, gate)
    _need(N % n_live == 0,
          lambda: f"N={N} is not a multiple of n_live={n_live}")
    B = N // n_live
    _need(n_ctx >= 1, lambda: "the step needs at least one context frame")
    for name, t in (("k_ctx", k_ctx), ("v_ctx", v_ctx)):
        _check_mat(name, t, (B * n_ctx * S, D), x.dtype)
    out = _temporal_q_cuda(x, shift, scale, gate, qkv_q, qkv_s, out_q, out_s,
                           out_b, rope_freqs, num_heads, B, n_live, n_ctx,
                           valid_bits(valid, n_ctx + n_live), k_ctx, v_ctx)
    capture.launched(fused_temporal_step_q)
    return out


fused_temporal_step_q.launches = 0
