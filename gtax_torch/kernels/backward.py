"""The DiT branch backwards: CUDA kernels on the card, plain PyTorch on the
CPU.

Counterpart of gtax/kernels/backward.py. Each public wrapper is the whole
backward of one fused branch of gtax_torch.kernels.block,

    out = x + g * y,  y = Branch(modulate(LN(x), shift, scale)) + bias,

from the branch's emit_train residuals (post-rope q/k and cast v, or the
pre-GELU h1; the pre-gate y) and the output cotangent ct. It returns
(dx, dshift, dscale, dg, weight and bias gradients): dx in x's dtype, every
other gradient fp32 (the autograd Functions of gtax_torch.nn.branches cast
them to the parameters' dtypes, as gtax's custom_vjps do). The tensor's
device picks the path: a CPU tensor gets the plain version (`*_plain`, any
float dtype), a CUDA tensor gets the hand-written sm_90a kernels or an
exception. Each wrapper counts its calls that launch kernels in
`launches`.

On the card a backward is a few launches of shared kernels: `gate_bwd` and
`ln_mod_bwd` (csrc/branch_bwd.cu: the gated residual and LayerNorm +
modulate backwards, with the per-frame sums in a fixed order), `gemm_bf16`
with trans_b (dY @ W^T, with a bf16, fp32 or gelu' epilogue), `gemm_wgrad`
(A^T @ B over the token rows, split into row chunks whose fp32 partials
`reduce_rows` adds in order), `ln_mod` (the modulate recompute) and the
attention backward (`attn_frame_bwd` / `attn_temporal_bwd`). No float
atomics anywhere: a run is bit-equal to the next.

The backwards take x's dtype, bf16 or fp32 (gtax's backward kernels at
x.dtype = float32, as gtax trains with compute_dtype="float32"): every
residual, ct and dx in it. In fp32 every cast to the compute dtype is a
no-op and the fp32 forms run, on fp32 FFMA with no TF32: `gate_bwd_f32`
and `ln_mod_bwd_f32`, `gemm_f32` with trans_b (EPI_F32, and the gelu'
epilogue EPI_DGELU with its 64-row column partials) and `gemm_f32_wgrad`
(A^T @ B in row chunks, their partials added in order by `reduce_rows`),
both on gemm_f32's token-row kernel (trans_b on transposed copies of its
operands; 128 x 256 tiles, 128 x 128 for the gelu' epilogue),
`attn_frame_bwd_f32` (two passes over 48-row tiles: the
bf16 design's S x S P and dS do not fit a block's shared memory in fp32)
and `attn_temporal_bwd_f32` (four fp32 dims a lane).

Rounding points (shared by kernels and plain versions, as in the TPU
kernels): elementwise math in fp32; GEMM operands in the compute dtype with
fp32 sums; dy = ct * g, the attention output recompute, dO = dy @ W_out^T,
dq/dk/dv, dh1 = gelu'(h1) * (dy @ W2^T) and the GELU value each rounded to
the compute dtype once; bias gradients summed from the unrounded fp32
values; dW and db in fp32.
"""

from __future__ import annotations

import functools

import torch

from gtax_torch.core.rope import rotate_half
from gtax_torch.kernels import block, build, capture
from gtax_torch.kernels.block import (
    EPI_BF16,
    EPI_DGELU,
    EPI_F32,
    LN_EPS,
    MOD_EPS,
    _check_branch,
    _check_mat,
    _desc,
    _need,
    _stream,
    mm32,
    modulated32,
    temporal_bias,
    valid_bits,
)

# Split K of the weight gradients: a row chunk is at least this many rows,
# and at most this many chunks
WGRAD_MIN_ROWS = 512
WGRAD_MAX_SPLITS = 8
# wgrad_plan's cost model of one split, fitted to the H100 SXM's times of
# `python -m gtax_torch.tools.gemm_sweep --wgrad-splits` at 1-8 chunks:
# the bf16 rate of one block on its SM, the memory rate the fp32 partials
# and their reduction move at, and the reduce_rows launch
WGRAD_BLOCK_FLOPS = 6.2e12
WGRAD_PARTIAL_BYTES_PER_S = 2.0e12
WGRAD_REDUCE_S = 3e-6
# the fp32 weight gradient (gemm_f32.cu gtax_gemm_f32_wgrad on the
# backward tile, one block an SM): wgrad_cost's rate of one block, 44
# TFLOP/s over 132 SMs (`python -m gtax_torch.tools.gemm_sweep --f32`,
# NVIDIA H100 80GB HBM3, 700 W: 42.7-45.7 TFLOP/s at the plan's chunks)
F32_WGRAD_BLOCK_FLOPS = 3.3e11


# ----------------------------------------------------------- plain parts

def gelu_tanh_val_grad32(h):
    """(gelu(h), gelu'(h)) in fp32 from one tanh (gtax/kernels/backward.py
    _gelu_tanh_val_grad32)."""
    c, a = 0.7978845608028654, 0.044715
    t = torch.tanh(c * (h + a * h * h * h))
    du = c * (1.0 + 3.0 * a * h * h)
    return 0.5 * h * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


def rope_transpose32(freqs, u):
    """Adjoint of the rotary embedding: u * cos - rotate_half(u * sin) in
    fp32 (gtax/nn/branches.py _rope_transpose)."""
    f = freqs.float()
    return u * torch.cos(f) - rotate_half(u * torch.sin(f))


def gate_bwd_plain(ct, g, y):
    """out = x + g * y per frame: (ct32, dg (N, D), dy32) in fp32."""
    ct32 = ct.float()
    return ct32, (ct32 * y.float()).sum(1), ct32 * g.float()[:, None]


def ln_mod_bwd_plain(x, scale, dmod32, ct32):
    """vjp of modulate(LN(x), shift, scale) plus the residual cotangent:
    (dx in x's dtype, dshift, dscale) with the per-frame sums in fp32 (the
    shift's value is not needed: its gradient is dmod itself)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    r = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + LN_EPS)
    ln = (x32 - mean) * r
    dln = dmod32 * (1.0 + scale.float()[:, None] + MOD_EPS)
    dx32 = r * (dln - dln.mean(-1, keepdim=True)
                - ln * (dln * ln).mean(-1, keepdim=True))
    return ((ct32 + dx32).to(x.dtype), dmod32.sum(1), (dmod32 * ln).sum(1))


def wgrad32(a, b):
    """a^T @ b summed over every leading (token) axis, fp32."""
    return torch.matmul(a.reshape(-1, a.shape[-1]).float().t(),
                        b.reshape(-1, b.shape[-1]).float())


def _attention_bwd_plain(q, k, v, dao, bias, dt, scale_attn, spec):
    """The shared attention recompute + backward over einsum `spec`
    ("query", "key", "probs" subscripts). Returns (ao, dq32, dk32, dv)."""
    sq, sk, sp = spec
    s = torch.einsum(f"{sq},{sk}->{sp}", q.float(), k.float()) * scale_attn
    if bias is not None:
        s = s + bias
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p32 = e / e.sum(-1, keepdim=True)
    pb = p32.to(dt).float()
    ao = torch.einsum(f"{sp},{sk}->{sq}", pb, v.float()).to(dt)
    dp = torch.einsum(f"{sq},{sk}->{sp}", dao.float(), v.float())
    ds = (p32 * (dp - (dp * p32).sum(-1, keepdim=True)) * scale_attn).to(dt)
    dq = torch.einsum(f"{sp},{sk}->{sq}", ds.float(), k.float())
    dk = torch.einsum(f"{sp},{sq}->{sk}", ds.float(), q.float())
    dv = torch.einsum(f"{sp},{sq}->{sk}", pb, dao.float()).to(dt)
    return ao, dq, dk, dv


def _attn_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w, y, ct, attn,
                           mod=None):
    """Shared body of the attention-branch backwards; `attn(dao)` returns
    (ao, dq, dk, dv) as (N, S, D) tensors (dq/dk fp32, rope adjoint
    applied); mod: the forward's modulated rows, else formed again."""
    N, S, D = x.shape
    dt = x.dtype
    ct32, dg, dy32 = gate_bwd_plain(ct, g, y)
    dy = dy32.to(dt)
    dao = mm32(dy, out_w.t()).to(dt)
    ao, dq, dk, dv = attn(dao)
    dW_out = wgrad32(ao, dy)
    db_out = dy32.sum((0, 1))
    dqkv = torch.cat([dq, dk, dv.float()], dim=-1).to(dt)
    if mod is None:
        mod = modulated32(x.float(), shift, scale).to(dt)
    dW_qkv = wgrad32(mod, dqkv)
    dmod32 = mm32(dqkv, qkv_w.t())
    dx, dshift, dscale = ln_mod_bwd_plain(x, scale, dmod32, ct32)
    return dx, dshift, dscale, dg, dW_qkv, dW_out, db_out


def spatial_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w, rope_freqs,
                             qr, kr, vr, y, ct, num_heads):
    N, S, D = x.shape
    d = D // num_heads
    shape = (N, S, num_heads, d)
    f = rope_freqs[:, None, :]

    def attn(dao):
        ao, dq, dk, dv = _attention_bwd_plain(
            qr.reshape(shape), kr.reshape(shape), vr.reshape(shape),
            dao.reshape(shape), None, x.dtype, 1.0 / d**0.5,
            ("nqhd", "nkhd", "nhqk"))
        return (ao.reshape(N, S, D), rope_transpose32(f, dq).reshape(N, S, D),
                rope_transpose32(f, dk).reshape(N, S, D), dv.reshape(N, S, D))

    return _attn_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w, y, ct,
                                  attn)


def temporal_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w, rope_freqs,
                              valid, qr, kr, vr, y, ct, num_heads, n_frames,
                              mod=None):
    N, S, D = x.shape
    T = n_frames
    d = D // num_heads
    shape = (N // T, T, S, num_heads, d)
    f = rope_freqs[None, :, None, None, :]
    bias = temporal_bias(valid, T, x.device)

    def attn(dao):
        ao, dq, dk, dv = _attention_bwd_plain(
            qr.reshape(shape), kr.reshape(shape), vr.reshape(shape),
            dao.reshape(shape), bias, x.dtype, 1.0 / d**0.5,
            ("bishd", "bjshd", "bshij"))
        return (ao.reshape(N, S, D), rope_transpose32(f, dq).reshape(N, S, D),
                rope_transpose32(f, dk).reshape(N, S, D), dv.reshape(N, S, D))

    return _attn_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w, y, ct,
                                  attn, mod)


def mlp_branch_bwd_plain(x, shift, scale, g, w1, w2, h1, y, ct):
    dt = x.dtype
    ct32, dg, dy32 = gate_bwd_plain(ct, g, y)
    dy = dy32.to(dt)
    ha32, gp32 = gelu_tanh_val_grad32(h1.float())
    ha = ha32.to(dt)
    dW2 = wgrad32(ha, dy)
    db2 = dy32.sum((0, 1))
    dh132 = gp32 * mm32(dy, w2.t())
    dh1 = dh132.to(dt)
    mod = modulated32(x.float(), shift, scale).to(dt)
    dW1 = wgrad32(mod, dh1)
    db1 = dh132.sum((0, 1))
    dmod32 = mm32(dh1, w1.t())
    dx, dshift, dscale = ln_mod_bwd_plain(x, scale, dmod32, ct32)
    return dx, dshift, dscale, dg, dW1, db1, dW2, db2


# -------------------------------------------- launch arithmetic (plain)

def wgrad_cost(M, Ka, N, sms, tile_m, tile_n, k_step, splits,
               block_flops=WGRAD_BLOCK_FLOPS):
    """(seconds, splits, chunk) of the weight-gradient GEMM over M token
    rows cut into `splits` row chunks (each a multiple of the k-step, so the
    last may be short and the count may come out lower): the waves of
    (Ka/tile_m) x (N/tile_n) x splits blocks on `sms` block slots (an SM
    each, or the blocks that share one), each block summing a chunk of
    rows at block_flops; the fp32 partials written,
    read and reduced (2 splits + 1 passes over Ka x N, one with no split)
    at WGRAD_PARTIAL_BYTES_PER_S; and the reduce_rows launch."""
    chunk = -(-M // splits)
    chunk = -(-chunk // k_step) * k_step
    splits = -(-M // chunk)
    tiles = -(-Ka // tile_m) * -(-N // tile_n)
    waves = -(-tiles * splits // sms)
    seconds = waves * chunk * tile_m * tile_n * 2 / block_flops
    passes = 1 if splits == 1 else 2 * splits + 1
    seconds += passes * Ka * N * 4 / WGRAD_PARTIAL_BYTES_PER_S
    if splits > 1:
        seconds += WGRAD_REDUCE_S
    return seconds, splits, chunk


def wgrad_plan(M, Ka, N, sms, tile_m, tile_n, k_step,
               block_flops=WGRAD_BLOCK_FLOPS):
    """(splits, chunk) of the weight-gradient GEMM over M token rows: of 1
    to WGRAD_MAX_SPLITS row chunks of at least WGRAD_MIN_ROWS rows, the
    count wgrad_cost finds fastest (the fewer chunks on a tie); the chunks
    cover rows [0, M) once."""
    best = None
    for s in range(1, WGRAD_MAX_SPLITS + 1):
        if s > 1 and M < s * WGRAD_MIN_ROWS:
            break
        cost = wgrad_cost(M, Ka, N, sms, tile_m, tile_n, k_step, s,
                          block_flops)
        if best is None or cost[0] < best[0]:
            best = cost
    return best[1], best[2]


def wgrad_f32_plan(M, Ka, N, sms):
    """(splits, chunk) of the fp32 weight gradient over M token rows:
    wgrad_plan on the backward tile (F32_BWD_TILE x F32_BWD_TILE_N,
    F32_BWD_BLOCKS block slots an SM, F32_WGRAD_BLOCK_FLOPS a block),
    chunks of whole 16-row steps."""
    return wgrad_plan(M, Ka, N, sms * block.F32_BWD_BLOCKS,
                      block.F32_BWD_TILE, block.F32_BWD_TILE_N,
                      block.F32_K_STEP, F32_WGRAD_BLOCK_FLOPS)


def dgelu_partial_rows(M, tile_m):
    """Rows of the gelu' epilogue's column partials: one per tile_m-row
    output tile of the M rows."""
    return -(-M // tile_m)


# ------------------------------------------------------- kernel launches

def _empty(shape, like, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=like.device)


def reduce_rows(a):
    """(R, C) fp32 -> (C,) fp32 column sums, rows added in order."""
    out = _empty(a.shape[1:], a)
    build.launch("gtax_reduce_rows", a.data_ptr(), out.data_ptr(),
                 a.shape[0], a[0].numel(), _stream(a))
    return out


@functools.lru_cache(maxsize=None)
def _wgrad_tile_n(N) -> int:
    n = build.library().gtax_gemm_wgrad_tile_n(N)
    if n <= 0:
        raise RuntimeError(f"gtax_gemm_wgrad_tile_n: CUDA error {-n}")
    return n


def wgrad_split(M, Ka, N, device):
    """(splits, chunk) of wgrad over M rows on `device`: wgrad_plan at the
    kernel's tile for width N."""
    c = build.gemm_consts()
    return wgrad_plan(M, Ka, N, block.sm_count(device), c.tile_m, _wgrad_tile_n(N),
                      c.k_step)


def wgrad(a, b):
    """a (M, Ka)^T @ b (M, N) in fp32, bf16 or fp32 operands; M split into
    row chunks by wgrad_plan (bf16) or wgrad_f32_plan (fp32)."""
    M, Ka = a.shape
    N = b.shape[1]
    if _f32(a):
        splits, chunk = wgrad_f32_plan(M, Ka, N, block.sm_count(a.device))
        name = "gtax_gemm_f32_wgrad"
    else:
        splits, chunk = wgrad_split(M, Ka, N, a.device)
        name = "gtax_gemm_wgrad"
    part = _empty((splits, Ka, N), a)
    build.launch(name, a.data_ptr(), b.data_ptr(), part.data_ptr(), M, Ka, N,
                 chunk, _stream(a))
    return part[0] if splits == 1 else reduce_rows(part)


def _f32(t):
    return t.dtype == torch.float32


def gate_bwd(ct, y, g, S):
    """-> (dy (M, D) in ct's dtype, dg (N, D) fp32, db (D,) fp32)."""
    M, D = ct.shape
    N = M // S
    dy = torch.empty_like(ct)
    dg, dys = _empty((N, D), ct), _empty((N, D), ct)
    build.launch("gtax_gate_bwd_f32" if _f32(ct) else "gtax_gate_bwd",
                 ct.data_ptr(), y.data_ptr(), g.data_ptr(), g.stride(0),
                 dy.data_ptr(), dg.data_ptr(), dys.data_ptr(), N, S, D,
                 _stream(ct))
    return dy, dg, reduce_rows(dys)


def ln_mod_bwd(x, dmod, scale, ct, S):
    """-> (dx (M, D) in ct's dtype, dshift, dscale (N, D) fp32)."""
    M, D = dmod.shape
    N = M // S
    dx = torch.empty_like(ct)
    dsh, dsc = _empty((N, D), x), _empty((N, D), x)
    build.launch("gtax_ln_mod_bwd_f32" if _f32(x) else "gtax_ln_mod_bwd",
                 x.data_ptr(), dmod.data_ptr(), scale.data_ptr(),
                 scale.stride(0), ct.data_ptr(), dx.data_ptr(),
                 dsh.data_ptr(), dsc.data_ptr(), N, S, D, _stream(x))
    return dx, dsh, dsc


def rope_tables(freqs):
    """fp32 cos and sin of a rotary table, the rope adjoint's factors
    (gtax's kernels take these tables; rope_transpose32 forms the same)."""
    f = freqs.float()
    return torch.cos(f).contiguous(), torch.sin(f).contiguous()


def launch_attn_frame_bwd(q, k, v, dout, cos, sin, dqkv, ao, n_frames, S,
                          D, num_heads, rot):
    """attn_frame_bwd over n_frames frames of S tokens: q/k/v/dout and ao
    (n_frames * S, D), dqkv (n_frames * S, 3D), all bf16 or all fp32,
    cos/sin (S, rot) fp32 (rope_tables), the rope adjoint on the first rot
    dims of each head. The bf16 kernel takes frames up to its shared
    memory's limit (176 tokens at head dim 64, 192 at 32), the fp32 one
    (attn_frame_bwd_f32, two passes over 48-row tiles and an (n_frames,
    heads, S, 3) fp32 scratch of row statistics) up to 432 and 528; past
    them they report an error."""
    if _f32(q):
        stats = _empty((n_frames, num_heads, S, 3), q)
        build.launch("gtax_attn_frame_bwd_f32", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), dout.data_ptr(), cos.data_ptr(),
                     sin.data_ptr(), dqkv.data_ptr(), ao.data_ptr(),
                     stats.data_ptr(), n_frames, S, D, num_heads, rot,
                     _stream(q))
        return
    build.launch("gtax_attn_frame_bwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), dout.data_ptr(), cos.data_ptr(),
                 sin.data_ptr(), dqkv.data_ptr(), ao.data_ptr(), n_frames, S,
                 D, num_heads, rot, _stream(q))


def _check_bwd(x, shift, scale, g, residuals, ct):
    """x (N, S, D) bf16 or fp32; every residual and ct contiguous (N, S,
    ...) in x's dtype."""
    N, S, D = _check_branch(x, shift, scale, g)
    _need(D in (64, 128, 256, 512, 1024),
          lambda: f"D={D}: the LayerNorm backward takes 64 .. 1024, powers "
                  "of two")
    for name, t in residuals + (("ct", ct),):
        _need(t.is_cuda and t.dtype == x.dtype and t.is_contiguous()
              and t.shape[:2] == (N, S),
              lambda name=name, t=t: f"{name} must be a contiguous CUDA "
              f"{x.dtype} ({N}, {S}, ...) tensor (x's dtype), got "
              f"{_desc(t)}")
    return N, S, D


def _attn_branch_bwd_cuda(x, shift, scale, g, qkv_w, out_w, y, ct,
                          attention, mod=None):
    """Shared launch sequence of the attention-branch backwards;
    `attention(dao, dqkv, ao)` launches the attention backward; mod: the
    forward's modulated rows, else ln_mod forms them again."""
    N, S, D = x.shape
    M = N * S
    _check_mat("qkv_w", qkv_w, (D, 3 * D), x.dtype)
    _check_mat("out_w", out_w, (D, D), x.dtype)
    _need(shift.stride(0) == scale.stride(0),
          lambda: "shift and scale must share a row stride")
    dy, dg, db_out = gate_bwd(ct.reshape(M, D), y.reshape(M, D), g, S)
    dao = torch.empty_like(dy)
    block.gemm_any(dy, out_w, dao, M, D, D, EPI_F32 if _f32(x) else EPI_BF16,
                   trans_b=True)
    dqkv = _empty((M, 3 * D), x, x.dtype)
    ao = torch.empty_like(dy)
    attention(dao, dqkv, ao)
    dW_out = wgrad(ao, dy)
    if mod is None:
        mod = block._modulate_cuda(x, shift, scale)
    dW_qkv = wgrad(mod.reshape(M, D), dqkv)
    dmod = _empty((M, D), x)
    block.gemm_any(dqkv, qkv_w, dmod, M, D, 3 * D, EPI_F32, trans_b=True)
    dx, dshift, dscale = ln_mod_bwd(x, dmod, scale, ct.reshape(M, D), S)
    return (dx.reshape(N, S, D), dshift, dscale, dg, dW_qkv, dW_out, db_out)


# ------------------------------------------------------------- wrappers

def fused_spatial_branch_bwd(x, shift, scale, g, qkv_w, out_w, rope_freqs,
                             qr, kr, vr, y, ct, num_heads, rope_cs=None):
    """Whole spatial-attention-branch backward. x/ct/y/qr/kr/vr: (N, S, D);
    shift/scale/g: (N, D); qkv_w: (D, 3D); out_w: (D, D); rope_freqs:
    (S, head_dim); rope_cs: rope_tables(rope_freqs) where the caller formed
    them once for many calls (the DiT, once a forward), else formed here.
    Returns (dx, dshift, dscale, dg, dW_qkv, dW_out, db_out).

    Replaces gtax/kernels/backward.py fused_spatial_branch_bwd (pallas_call
    at :386, body _spatial_bwd_kernel :208). On the card: gate_bwd,
    reduce_rows (db_out), gemm dy @ W_out^T, attn_frame_bwd (recomputes P
    and the attention output on the tensor cores, writes dq/dk/dv; the
    rope adjoint from the table's cos and sin), gemm_wgrad dW_out, ln_mod,
    gemm_wgrad dW_qkv, gemm dqkv @ W_qkv^T, ln_mod_bwd: 9-11 launches.
    Bound: operations (four token-row GEMMs of the forward's size, plus the
    attention backward); see PERF.md for the measured time."""
    if x.device.type == "cpu":
        return spatial_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w,
                                        rope_freqs, qr, kr, vr, y, ct,
                                        num_heads)
    N, S, D = _check_bwd(x, shift, scale, g, (("qr", qr), ("kr", kr),
                                              ("vr", vr), ("y", y)), ct)
    d = block._check_heads(D, num_heads, (32, 64))
    block._check_freqs(rope_freqs, S, d)
    cos, sin = rope_tables(rope_freqs) if rope_cs is None else rope_cs

    def attention(dao, dqkv, ao):
        launch_attn_frame_bwd(qr, kr, vr, dao, cos, sin, dqkv, ao, N, S, D,
                              num_heads, d)

    out = _attn_branch_bwd_cuda(x, shift, scale, g, qkv_w, out_w, y, ct,
                                attention)
    capture.launched(fused_spatial_branch_bwd)
    return out


fused_spatial_branch_bwd.launches = 0


def fused_temporal_branch_bwd(x, shift, scale, g, qkv_w, out_w, rope_freqs,
                              valid, qr, kr, vr, y, ct, num_heads, n_frames,
                              mod=None):
    """Whole temporal-attention-branch backward. x/ct/y/qr/kr/vr:
    (N = B*T, S, D) frame-major; shift/scale/g: (N, D); rope_freqs:
    (T, head_dim); valid: (T,) bools or None; mod: the forward's modulated
    rows (N, S, D) (fused_temporal_branch emit_mod), else formed again.
    Returns (dx, dshift, dscale, dg, dW_qkv, dW_out, db_out).

    Replaces gtax/kernels/backward.py fused_temporal_branch_bwd
    (pallas_call at :632, body _temporal_bwd_kernel :424, rope adjoint
    _rope_transpose_rows :411). On the card: as the spatial backward, with
    attn_temporal_bwd (causal, slot-validity bias; 16-byte lanes, T a
    template parameter) as the attention part, and no ln_mod where mod is
    given: 8-10 launches. Bound: operations (the four GEMMs; the attention
    part is bytes)."""
    if x.device.type == "cpu":
        return temporal_branch_bwd_plain(x, shift, scale, g, qkv_w, out_w,
                                         rope_freqs, valid, qr, kr, vr, y, ct,
                                         num_heads, n_frames, mod)
    residuals = (("qr", qr), ("kr", kr), ("vr", vr), ("y", y))
    if mod is not None:
        residuals += (("mod", mod),)
    N, S, D = _check_bwd(x, shift, scale, g, residuals, ct)
    T = n_frames
    _need(N % T == 0, lambda: f"N={N} is not a multiple of T={T}")
    block.check_temporal(D, num_heads, T, rope_freqs)
    bits = valid_bits(valid, T)

    def attention(dao, dqkv, ao):
        build.launch("gtax_attn_temporal_bwd_f32" if _f32(x)
                     else "gtax_attn_temporal_bwd", qr.data_ptr(),
                     kr.data_ptr(), vr.data_ptr(), dao.data_ptr(),
                     rope_freqs.data_ptr(), dqkv.data_ptr(), ao.data_ptr(),
                     N // T, T, S, D, num_heads, bits, _stream(x))

    out = _attn_branch_bwd_cuda(x, shift, scale, g, qkv_w, out_w, y, ct,
                                attention, mod)
    capture.launched(fused_temporal_branch_bwd)
    return out


fused_temporal_branch_bwd.launches = 0


def fused_mlp_branch_bwd(x, shift, scale, g, w1, w2, h1, y, ct):
    """Whole MLP-branch backward. x/ct/y: (N, S, D); h1: (N, S, H);
    shift/scale/g: (N, D); w1: (D, H); w2: (H, D). Returns (dx, dshift,
    dscale, dg, dW1, db1, dW2, db2).

    Replaces gtax/kernels/backward.py fused_mlp_branch_bwd (pallas_call at
    :709, body _mlp_bwd_kernel :132, GELU value and derivative from one tanh
    _gelu_tanh_val_grad32 :116). On the card: gate_bwd, reduce_rows (db2),
    gemm dy @ W2^T with the gelu' epilogue (writes dh1, gelu(h1) and the
    per-tile sums of db1), reduce_rows (db1), gemm_wgrad dW2, ln_mod,
    gemm_wgrad dW1, gemm dh1 @ W1^T, ln_mod_bwd: 9-10 launches; in fp32
    their fp32 forms (gemm_f32's token-row kernel: trans_b with the
    gelu' epilogue's 64-row partials, gemm_f32_wgrad). Bound: operations
    (four GEMMs of the forward's fc1/fc2 size)."""
    if x.device.type == "cpu":
        return mlp_branch_bwd_plain(x, shift, scale, g, w1, w2, h1, y, ct)
    N, S, D = _check_bwd(x, shift, scale, g, (("h1", h1), ("y", y)), ct)
    Hd = w1.shape[-1]
    block._check_hidden(Hd)
    _check_mat("w1", w1, (D, Hd), x.dtype)
    _check_mat("w2", w2, (Hd, D), x.dtype)
    _need(shift.stride(0) == scale.stride(0),
          lambda: "shift and scale must share a row stride")
    M = N * S
    ct2 = ct.reshape(M, D)
    dy, dg, db2 = gate_bwd(ct2, y.reshape(M, D), g, S)
    dh1 = _empty((M, Hd), x, x.dtype)
    ha = torch.empty_like(dh1)
    slab = block.F32_SLAB if _f32(x) else build.gemm_consts().tile_m
    part = _empty((dgelu_partial_rows(M, slab), Hd), x)
    block.gemm_any(dy, w2, dh1, M, Hd, D, EPI_DGELU, out2=ha,
                   aux=h1.reshape(M, Hd), colsum=part, trans_b=True)
    db1 = reduce_rows(part)
    dW2 = wgrad(ha, dy)
    dW1 = wgrad(block._modulate_cuda(x, shift, scale), dh1)
    dmod = _empty((M, D), x)
    block.gemm_any(dh1, w1, dmod, M, D, Hd, EPI_F32, trans_b=True)
    dx, dshift, dscale = ln_mod_bwd(x, dmod, scale, ct2, S)
    capture.launched(fused_mlp_branch_bwd)
    return dx.reshape(N, S, D), dshift, dscale, dg, dW1, db1, dW2, db2


fused_mlp_branch_bwd.launches = 0
