"""The DiT block's fused branches: CUDA kernels on the card, plain PyTorch
on the CPU.

Counterpart of gtax/kernels/block.py. Each public wrapper computes one
whole branch of a SpatioTemporal DiT block,

    out = x + gate * Branch(modulate(LN(x), shift, scale))

with shift/scale/gate given per FRAME ((N, D), broadcast to the frame's S
token rows). The tensor's device picks the path: a CPU tensor gets the
branch's plain PyTorch version (`*_plain`, any float dtype), a CUDA tensor
gets the hand-written sm_90a kernels of gtax_torch/csrc or an exception for
a shape or dtype they do not take. There is no fallback and no switch.

On the card a branch is a few launches of shared kernels: `ln_mod` (fp32
LayerNorm + per-frame modulate -> bf16), `gemm_bf16` (tensor-core GEMM
with an fp32 or fused epilogue), and the attention kernel of the branch
(`attn_frame`, `attn_temporal_window` for the temporal branch's full window,
`attn_temporal` for its incremental step). The branch's dtype is x's: bf16
takes those kernels, fp32 (gtax's kernels at x.dtype = float32, as gtax
serves dtype="float32") their fp32 forms, which round nothing: `ln_mod`'s
fp32 modes, `gemm_f32` (fp32 FFMA on the CUDA cores, no TF32, the same
epilogues stored unrounded), `attn_frame_f32`, `attn_temporal_window_f32`
and `attn_temporal_f32`. Every other tensor of a call has x's dtype (the
biases may be either). Each wrapper counts its calls that launch kernels
in its `launches` attribute.

For training, `emit_train=True` also returns the residuals the branch
backwards consume (gtax's emit_train outputs): the post-rope q and k and the
cast v of the attention branches, the pre-GELU fc1 output h1 of the MLP, and
the pre-gate branch output y = proj + bias of both, each in the compute
dtype. On the card the spatial attention kernel stores q/k/v as it computes
them, the temporal branch's qkv GEMM stores them from its epilogue (rope
applied there, `gemm_rope_qkv`: they are also the K/V cache of emit_kv and
the attention's inputs), and the last GEMM stores y beside the gated output
(a second store of one epilogue; fc1's epilogue does the same for h1): no
extra launch, and with emit_train off nothing changes for serving. In fp32
the same stores come from the fp32 forms (`attn_frame_f32`'s q/k/v stores
and `gemm_f32`'s `_Y` / `_H` epilogues, instantiations of their own), so
fp32 training runs on the card as bf16 does. The
wrappers are forward-only (`forward_only`): with grad mode on they refuse
an input that requires grad, on the CPU as on the card, rather than return
a result with no gradient; the trainable branches of
gtax_torch.nn.branches call them inside their autograd Functions.

Rounding points (shared by kernels and plain versions, as in the TPU
kernels): LN statistics, softmax and rope in fp32; the qkv product stays
fp32 until after rope and is cast to the compute dtype after it
(`rope_qkv_plain` for the temporal branch);
attention probabilities are cast to the compute dtype before PV; the
branch output is cast once, o = cast(x32 + gate * (y + b)).
"""

from __future__ import annotations

import functools

import torch

from gtax_torch.core.rope import apply_rotary_emb as rope
from gtax_torch.kernels import build, capture

MOD_EPS = 1e-6
LN_EPS = 1e-6

# gemm_bf16 epilogues (csrc/gemm_bf16.cu)
EPI_F32 = 0
EPI_BIAS_BF16 = 1
EPI_BIAS_GELU_TANH = 2
EPI_BIAS_BF16_GELU = 3
EPI_BIAS_GATED = 4
EPI_BIAS_BF16_RESID = 5
EPI_BF16 = 6
EPI_BIAS_GATED_Y = 7
EPI_BIAS_GELU_TANH_H = 8
EPI_DGELU = 9
EPI_BIAS_GELU_ERF = 11
EPI_BIAS_GELU_ERF_H = 12

# ln_mod modes (csrc/ln_mod.cuh): over bf16 rows; + LN_F32, over fp32 rows
# (the int8 mode over fp32 rows: LN_INT8_F32)
LN_MODULATE, LN_AFFINE, LN_INT8, LN_F32, LN_INT8_F32 = 0, 1, 2, 3, 5

# the most frames of a temporal window (csrc/attn_temporal.cuh kMaxT): the
# temporal kernels' register arrays, and the window kernels' T template
MAX_WINDOW = 8


# ----------------------------------------------------------- plain parts

def ln32(x32: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm without affine over the last dim, fp32 in and out."""
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps)


def mm32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with the operands' values in fp32 and fp32 accumulation — for
    bf16 operands, the products of a bf16 tensor-core GEMM."""
    return torch.matmul(a.float(), w.float())


def gelu_tanh32(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), term for term."""
    return h * (0.5 * (1.0 + torch.tanh(
        0.7978845608028654 * (h + 0.044715 * (h * h * h)))))


def gelu_exact32(h: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=False) as jax writes it: 0.5 h erfc(-h
    sqrt(1/2)) (the MLP branches' approx_gelu=False)."""
    return 0.5 * h * torch.special.erfc(-h * 0.7071067811865476)


def gelu32(approx_gelu: bool):
    """The MLP branches' GELU: tanh (gtax's default) or exact."""
    return gelu_tanh32 if approx_gelu else gelu_exact32


def modulated32(x32, shift, scale):
    """LN(x) * (1 + scale + 1e-6) + shift in fp32, per-frame vectors."""
    return (ln32(x32) * (1.0 + scale.float()[:, None] + MOD_EPS)
            + shift.float()[:, None])


def _modulated(x32, shift, scale, dtype):
    return modulated32(x32, shift, scale).to(dtype)


def attend_frames(q, k, v, dtype, out_dtype=None):
    """Non-causal attention per frame: q/k/v (N, S, H, d) in the compute
    dtype -> (N, S, H, d) in out_dtype (default: the compute dtype). fp32
    scores and softmax, probabilities cast to the compute dtype before PV,
    fp32 PV sums."""
    d = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * (1.0 / d**0.5)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dtype)
    return torch.einsum("nhqk,nkhd->nqhd", p.float(), v.float()).to(
        out_dtype or dtype)


def valid_bits(valid, T: int) -> int:
    """Slot-validity mask as an int (bit j = slot j is a real frame); None
    means every slot is valid. `valid` is a bool sequence or tensor; a CPU
    tensor or a list keeps the host from waiting on the card."""
    if valid is None:
        return (1 << T) - 1
    flags = valid.tolist() if isinstance(valid, torch.Tensor) else list(valid)
    if len(flags) != T:
        raise ValueError(f"valid has {len(flags)} slots, window has {T}")
    return sum(1 << j for j, ok in enumerate(flags) if ok)


def temporal_bias(valid, T: int, device) -> torch.Tensor:
    """(T, T) additive mask of gtax temporal_preamble: causal, a key slot
    open when valid or on the diagonal, -1e30 where closed. Made once per
    mask and device (capture.held): the denoise step copies nothing."""
    bits = valid_bits(valid, T)

    def make(dev):
        ok = torch.tensor([bool(bits >> j & 1) for j in range(T)],
                          device=dev)
        eye = torch.eye(T, dtype=torch.bool, device=dev)
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev))
        allow = causal & (ok[None, :] | eye)
        return torch.where(allow, 0.0, -1e30).float()

    return capture.held(("temporal_bias", bits, T), device, make)


def rope_qkv_plain(qkv32, freqs, S, n_q, q_off, dtype):
    """The temporal branch's qkv product through rope and its one rounding:
    qkv32 (M, 3D) fp32 rows, frame-major (row r at window slot q_off +
    (r / S) % n_q of freqs (slots, head_dim)) -> (q, k, v), each (M, D) in
    dtype, rope in fp32 on q and k. The plain version of the qkv GEMM's
    rope epilogue (csrc/gemm_epi.cuh EPI_ROPE_QKV)."""
    M, D = qkv32.shape[0], qkv32.shape[1] // 3
    d = freqs.shape[-1]
    shape = (M // (n_q * S), n_q, S, D // d, d)
    q, k, v = (t.reshape(shape) for t in qkv32.split(D, dim=-1))
    f = freqs[q_off:q_off + n_q][None, :, None, None, :]
    return tuple(t.reshape(M, D) for t in (
        rope(f, q).to(dtype), rope(f, k).to(dtype), v.to(dtype)))


def attend_temporal(q, k, v, bias, dtype, out_dtype=None):
    """Causal attention across frames at each site: q (B, I, S, H, d)
    query frames, k/v (B, J, S, H, d) key frames in window-slot order,
    bias (I, J) additive (its -1e30 entries zero the closed pairs). Output
    in out_dtype (default: the compute dtype)."""
    d = q.shape[-1]
    s = (torch.einsum("bishd,bjshd->bshij", q.float(), k.float())
         * (1.0 / d**0.5) + bias)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dtype)
    return torch.einsum("bshij,bjshd->bishd", p.float(), v.float()).to(
        out_dtype or dtype)


# ------------------------------------------------------ plain branches

def spatial_branch_plain(x, shift, scale, gate, qkv_w, out_w, out_b,
                         rope_freqs, num_heads, emit_train=False):
    N, S, D = x.shape
    dt, H = x.dtype, num_heads
    x32 = x.float()
    qkv = mm32(_modulated(x32, shift, scale, dt), qkv_w)
    q, k, v = (t.reshape(N, S, H, D // H) for t in qkv.split(D, dim=-1))
    f = rope_freqs[:, None, :]
    qr, kr, vb = rope(f, q).to(dt), rope(f, k).to(dt), v.to(dt)
    o = attend_frames(qr, kr, vb, dt)
    y = mm32(o.reshape(N, S, D), out_w) + out_b.float()
    out = (x32 + gate.float()[:, None] * y).to(dt)
    if emit_train:
        return (out, *(t.reshape(N, S, D) for t in (qr, kr, vb)), y.to(dt))
    return out


def mlp_branch_plain(x, shift, scale, gate, w1, b1, w2, b2,
                     approx_gelu=True, emit_train=False):
    dt = x.dtype
    x32 = x.float()
    h = mm32(_modulated(x32, shift, scale, dt), w1) + b1.float()
    y = mm32(gelu32(approx_gelu)(h).to(dt), w2) + b2.float()
    out = (x32 + gate.float()[:, None] * y).to(dt)
    if emit_train:
        return out, h.to(dt), y.to(dt)
    return out


def temporal_branch_plain(x, shift, scale, gate, qkv_w, out_w, out_b,
                          rope_freqs, valid, num_heads, n_frames,
                          emit_kv=False, emit_train=False, emit_mod=False):
    N, S, D = x.shape
    dt, H, T = x.dtype, num_heads, n_frames
    x32 = x.float()
    mod = _modulated(x32, shift, scale, dt)
    qr, kr, vb = rope_qkv_plain(mm32(mod, qkv_w).reshape(N * S, 3 * D),
                                rope_freqs, S, T, 0, dt)
    shape = (N // T, T, S, H, D // H)
    o = attend_temporal(qr.reshape(shape), kr.reshape(shape),
                        vb.reshape(shape), temporal_bias(valid, T, x.device),
                        dt)
    y = mm32(o.reshape(N, S, D), out_w) + out_b.float()
    out = (x32 + gate.float()[:, None] * y).to(dt)
    if emit_train:
        res = (out, *(t.reshape(N, S, D) for t in (qr, kr, vb)), y.to(dt))
        return (*res, mod) if emit_mod else res
    if emit_kv:
        return out, kr.reshape(N, S, D), vb.reshape(N, S, D)
    return out


def temporal_step_plain(x, shift, scale, gate, qkv_w, out_w, out_b, k_ctx,
                        v_ctx, rope_freqs, valid, num_heads, n_ctx,
                        n_live=1):
    N, S, D = x.shape
    dt, H = x.dtype, num_heads
    B, T = N // n_live, n_ctx + n_live
    d = D // H
    x32 = x.float()
    qkv = mm32(_modulated(x32, shift, scale, dt), qkv_w)
    q, k, v = (t.reshape(B, n_live, S, H, d) for t in rope_qkv_plain(
        qkv.reshape(N * S, 3 * D), rope_freqs, S, n_live, n_ctx, dt))
    keys = torch.cat([k_ctx.reshape(B, n_ctx, S, H, d).to(dt), k], dim=1)
    vals = torch.cat([v_ctx.reshape(B, n_ctx, S, H, d).to(dt), v], dim=1)
    bias = temporal_bias(valid, T, x.device)[n_ctx:]
    o = attend_temporal(q, keys, vals, bias, dt)
    y = mm32(o.reshape(N, S, D), out_w) + out_b.float()
    return (x32 + gate.float()[:, None] * y).to(dt)


# --------------------------------------------------- the small-M plan

# One call's time on each path, from `python -m gtax_torch.tools.gemm_sweep
# --small` (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): a fixed part
# and a part per k-step of the busiest block, L2 flushed before the call.
SMALL_FIXED_S, SMALL_STEP_S = 12.7e-6, 0.78e-6
TILED_FIXED_S, TILED_STEP_S = 7.5e-6, 0.30e-6


def small_chunk(M, N, K, sms, tile_n, k_step, max_rows, max_splits):
    """K chunk of the bf16 GEMM's small-M path (csrc/gemm_sm90.cuh
    small_kernel), or 0 where it cannot run: up to max_rows rows, one block
    covers every row of a tile_n-column tile, and K is cut into the most
    chunks of whole k-steps (at most max_splits) whose blocks (tiles x
    chunks) still fit in one wave of the card's SMs, so that every weight
    byte is read once and the read is spread over the card."""
    if M > max_rows or N % tile_n:
        return 0
    tiles, steps = N // tile_n, -(-K // k_step)
    for c in range(1, steps + 1):
        splits = -(-steps // c)
        if splits <= max_splits and tiles * splits <= sms:
            return c * k_step
    return steps * k_step


def small_plan(M, N, K, sms, tile_n, k_step, max_rows, max_splits,
               tile_m=128, tiled_n=128):
    """K chunk of the small-M path where the cost model finds it faster
    than the tiled path (tile_m x tiled_n tiles, K walked in k-steps by
    every block, in waves of the SMs), else 0 (the tiled path). At a
    denoise step that is fc2 (K=4096 over 16 tiled blocks); qkv, the
    out-projection and fc1 stay tiled."""
    chunk = small_chunk(M, N, K, sms, tile_n, k_step, max_rows, max_splits)
    if not chunk:
        return 0
    steps = -(-K // k_step)
    tiled_blocks = -(-M // tile_m) * -(-N // tiled_n)
    tiled = TILED_FIXED_S + TILED_STEP_S * steps * -(-tiled_blocks // sms)
    small = SMALL_FIXED_S + SMALL_STEP_S * (chunk // k_step)
    return chunk if small < tiled else 0


# gemm_f32's K step (csrc/gemm_f32.cu BK: K and its chunks are multiples)
# and the most K chunks a split product takes
F32_K_STEP, F32_MAX_SPLITS = 16, 8


# gemm_f32's forward, k-major form, from F32_FWD_ROWS rows (csrc/gemm_f32.cu
# gemm_f32_fwd_kernel, FwdShape; f32_fwd_form below): five DiT frames'
# 720 rows up to training's 11,520, the VAE's 1,152-3,456, and from 432
# rows the wide products, on 128x128 tiles of
# 32-row k-steps, two blocks an SM, over A stored k-major; K of more than
# F32_FWD_SPLIT_STEPS steps, or tiles that leave an SM's slots idle, are
# split by f32_fwd_chunk (`python -m gtax_torch.tools.gemm_sweep --f32`,
# NVIDIA H100 80GB HBM3, 700 W: within 4% of the fastest chunk count at
# every product from 2,304 rows, 10-18% off it at some of 720-1,440, and
# 1.13-1.49x faster there than the 64x64 tile the serving form replaced;
# PERF.md section 6)
F32_FWD_ROWS, F32_FWD_TILE, F32_FWD_K_STEP, F32_FWD_BLOCKS = 720, 128, 32, 2
F32_FWD_SPLIT_STEPS = 32


def _cdiv(a, b):
    return -(-a // b)


def f32_fwd_chunk(M, N, K, sms):
    """K chunk of the forward from F32_FWD_ROWS rows: K where K is at most
    F32_FWD_SPLIT_STEPS k-steps and the tiles fill the F32_FWD_BLOCKS x
    sms slots; else, of 1 to F32_MAX_SPLITS chunks of whole k-steps (the
    last one short), the count with the fewest wave-steps, ceil(tiles x
    chunks / slots) waves of a chunk's steps, each chunk counted one step
    more (its partial stored and read again); the fewest on a tie. At the
    VAE decode's 3,456 rows fc2 (216 tiles of 128 steps) takes 6 chunks,
    at training's 11,520 rows 4; every K = 1,024 product there, one."""
    steps = _cdiv(K, F32_FWD_K_STEP)
    tiles = _cdiv(M, F32_FWD_TILE) * _cdiv(N, F32_FWD_TILE)
    slots = F32_FWD_BLOCKS * sms
    if steps <= F32_FWD_SPLIT_STEPS and tiles >= slots:
        return K
    best = None
    for s in range(1, F32_MAX_SPLITS + 1):
        c = _cdiv(steps, s)
        splits = _cdiv(steps, c)
        cost = _cdiv(tiles * splits, slots) * c + splits
        if best is None or cost < best[0]:
            best = (cost, splits, c)
    return K if best[1] == 1 else best[2] * F32_FWD_K_STEP


# The forward's form (f32_fwd_form): k-major from F32_FWD_ROWS rows, and
# from F32_FWD_ROWS_WIDE rows for a product of at least
# F32_FWD_WIDE_WEIGHTS weights (qkv, fc1 and fc2 at D = 1,024; the
# 1,024 x 1,024 out-projection stays on the serving form below 720 rows);
# below, the serving form (f32_form: the persistent form below 432 rows;
# `python -m gtax_torch.tools.gemm_sweep --f32
# --forms`, both forms in turns at 144, 288, 432, 576 and 719 rows,
# NVIDIA H100 80GB HBM3, 700 W: for each group the threshold of least
# summed time; at 576 rows qkv 0.1034 against 0.1437 ms, fc1 0.1397
# against 0.1647, fc2 0.1400 against 0.1706, the out-projection 0.0593
# against 0.0485; PERF.md section 6)
F32_FWD_ROWS_WIDE, F32_FWD_WIDE_WEIGHTS = 432, 3 * 2**20


def f32_fwd_form(M, N, K) -> bool:
    """Whether gemm_f32's forward runs its k-major form for an (M, K) @
    (K, N) product: the rule the C entry takes as its argument fwd_form."""
    return M >= F32_FWD_ROWS or (M >= F32_FWD_ROWS_WIDE
                                 and N * K >= F32_FWD_WIDE_WEIGHTS)


def f32_fwd_ld(dtype, M, N, K) -> int:
    """The row stride of a k-major copy of the (M, N) fp32 output of fc1
    (an (M, K) @ (K, N) product; fc2's weights are as many) where the
    k-major form runs both: M rounded up to 4, the stride fc1's GELU rows
    are stored at for fc2; 0 where it does not."""
    if dtype == torch.float32 and f32_fwd_form(M, N, K):
        return _cdiv(M, 4) * 4
    return 0


# gemm_f32's forward, serving form (csrc/gemm_f32.cu
# gemm_f32_serve_kernel, kServe*): 48-row tiles by 64 columns, four blocks
# an SM, K cut into the chunks of a
# thread-block cluster of at most F32_MAX_CLUSTER blocks that add their
# partials through distributed shared memory in chunk order; a split aims
# for F32_SERVE_FILL blocks an SM in chunks of at most F32_SERVE_SPLIT_STEPS
# k-steps (`python -m gtax_torch.tools.gemm_sweep --f32`, NVIDIA H100 80GB
# HBM3, 700 W: the fastest chunk count at each product of 144 rows, and
# within 1.3% of it at 288, when the form ran them; PERF.md section 6).
# f32_form runs it for the out-projection at 432-719 rows; the step's
# 144-288 rows went to the persistent form below
F32_SERVE_TILE, F32_SERVE_TILE_N, F32_SERVE_BLOCKS = 48, 64, 4
F32_MAX_CLUSTER, F32_SERVE_FILL, F32_SERVE_SPLIT_STEPS = 8, 2.5, 32


def f32_serve_chunk(M, N, K, sms):
    """K chunk of the forward's serving form: of the chunk counts s (whole
    k-steps dividing K, s <= F32_MAX_CLUSTER, one a block of the column
    tile's cluster) whose chunks are at most F32_SERVE_SPLIT_STEPS k-steps
    deep, the fewest whose tiles x s blocks give F32_SERVE_FILL blocks an
    SM, else the most there are. f32_form runs the form for the
    out-projection at 432-719 rows (at 576, 192 tiles: 2 chunks); at 144
    and 288 rows the plan still gives the counts it ran there before the
    persistent form (qkv 4 and 2, the out-projection 8 and 4, fc1 2, fc2
    8), which gemm_sweep.py --f32 --forms times it at."""
    steps = K // F32_K_STEP
    tiles = _cdiv(M, F32_SERVE_TILE) * _cdiv(N, F32_SERVE_TILE_N)
    counts = [s for s in range(1, F32_MAX_CLUSTER + 1) if steps % s == 0]
    for s in counts:
        if (steps // s <= F32_SERVE_SPLIT_STEPS
                and tiles * s >= F32_SERVE_FILL * sms):
            return K // s
    return K // counts[-1]


# gemm_f32's forward, persistent form (csrc/gemm_f32.cu
# gemm_f32_persist_kernel, kPersist* / GTAX_PERSIST_*): 48 x 128 tiles of
# 32-deep k-steps, four blocks an SM, one round of blocks at once walking
# the (tile, K chunk) units dealt to them in turn; a split tile's partials
# go through a workspace and are summed in chunk order. The shape was the
# fastest of twelve at the step's products (`python -m
# gtax_torch.tools.gemm_sweep --persist-shapes`, NVIDIA H100 80GB HBM3,
# 700 W: 3 x 8 to 8 x 8 outputs a thread, 48- and 72-row tiles, 128-
# and 256-column tiles, 16- and 32-deep steps, 2-4 ring stages, 2-4
# blocks an SM; PERF.md section 6). f32_persist_chunk's model, from the same sweep: a block's
# k-step takes (n + 1) / 2 times a lone block's when n blocks share its
# SM, and a split unit costs F32_PERSIST_UNIT_STEPS lone steps more (its
# partial stored, the fix-up's wait and its sums)
F32_PERSIST_TILE, F32_PERSIST_TILE_N, F32_PERSIST_K_STEP = 48, 128, 32
F32_PERSIST_BLOCKS, F32_PERSIST_MAX_SPLITS, F32_PERSIST_UNIT_STEPS = 4, 32, 3
# the forward's forms: the C entry's fwd_form (f32_form)
F32_FORM_SERVE, F32_FORM_K_MAJOR, F32_FORM_PERSIST = 0, 1, 2
# the persistent form below this many rows, where the k-major form does
# not run (`python -m gtax_torch.tools.gemm_sweep --f32 --forms`, the
# three forms in turns, NVIDIA H100 80GB HBM3, 700 W: faster than the
# serving form at each of the step's products at 144 and 288 rows, qkv
# 0.0365 against 0.0445 ms at 144; PERF.md section 6); from 432 rows the
# forms stay as they were
F32_PERSIST_ROWS = 432


def f32_form(M, N, K) -> int:
    """The form gemm_f32's forward runs an (M, K) @ (K, N) product on (the
    C entry's fwd_form): F32_FORM_K_MAJOR by f32_fwd_form, else
    F32_FORM_PERSIST below F32_PERSIST_ROWS rows, else F32_FORM_SERVE."""
    if f32_fwd_form(M, N, K):
        return F32_FORM_K_MAJOR
    if M < F32_PERSIST_ROWS:
        return F32_FORM_PERSIST
    return F32_FORM_SERVE


def f32_persist_units(M, N, K, k_chunk) -> int:
    """The persistent form's (tile, K chunk) units."""
    return (_cdiv(M, F32_PERSIST_TILE) * _cdiv(N, F32_PERSIST_TILE_N)
            * _cdiv(K, k_chunk))


def f32_persist_chunk(M, N, K, sms):
    """K chunk of the forward's persistent form: of the chunks of whole
    16-row granules (the last one short) in 1 to F32_PERSIST_MAX_SPLITS
    chunks, the one of least modeled time (the fewest chunks on a tie): a
    block's units (ceil(units / blocks), the blocks f32_persist_grid's),
    each its chunk's k-steps at (n + 1) / 2 a step, n = ceil(blocks /
    sms) sharing an SM, plus F32_PERSIST_UNIT_STEPS where K is split. At
    a denoise step's 144 rows qkv takes 7 chunks, the out-projection 16,
    fc1 4, fc2 22; at 288 qkv 3, the out-projection and fc2 11, fc1 2."""
    tiles = _cdiv(M, F32_PERSIST_TILE) * _cdiv(N, F32_PERSIST_TILE_N)
    granules = _cdiv(K, F32_K_STEP)
    best = None
    for s in range(1, F32_PERSIST_MAX_SPLITS + 1):
        chunk = _cdiv(granules, s) * F32_K_STEP
        splits = _cdiv(K, chunk)
        units = tiles * splits
        blocks = min(units, F32_PERSIST_BLOCKS * sms)
        cost = _cdiv(units, blocks) * (
            _cdiv(chunk, F32_PERSIST_K_STEP) * (_cdiv(blocks, sms) + 1)
            + (2 * F32_PERSIST_UNIT_STEPS if splits > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, chunk)
    return best[1]


def f32_persist_schedule(M, N, K, k_chunk, blocks):
    """gemm_f32_persist_kernel's schedule, as the kernel walks it: for each
    of min(blocks, units) blocks, its units in order, (row, column, k0,
    k1) = the tile's first row and column and the chunk's K range, and its
    fix-up jobs, (row, column, first row, end row, the chunks' K ranges in
    the order their partials are summed); no jobs where K is one chunk."""
    tm, tn = F32_PERSIST_TILE, F32_PERSIST_TILE_N
    splits, cols = _cdiv(K, k_chunk), _cdiv(N, tn)
    units = _cdiv(M, tm) * cols * splits
    rows = _cdiv(tm, splits)
    out = []
    for b in range(min(blocks, units)):
        mine, jobs = [], []
        for u in range(b, units, min(blocks, units)):
            t, c = divmod(u, splits)
            m0, n0 = t // cols * tm, t % cols * tn
            mine.append((m0, n0, c * k_chunk, min(K, (c + 1) * k_chunk)))
            if splits > 1:
                jobs.append((m0, n0, c * rows, min(tm, (c + 1) * rows),
                             [(z * k_chunk, min(K, (z + 1) * k_chunk))
                              for z in range(splits)]))
        out.append((mine, jobs))
    return out


def f32_persist_grid(M, N, K, k_chunk, sms) -> int:
    """The persistent form's blocks: one round of the card
    (F32_PERSIST_BLOCKS an SM), or one a unit where there are fewer."""
    return min(f32_persist_units(M, N, K, k_chunk), F32_PERSIST_BLOCKS * sms)


def f32_chunk(M, N, K, sms):
    """K chunk of an fp32 GEMM (K: one pass, no split) on the form f32_form
    picks: f32_fwd_chunk, f32_persist_chunk or f32_serve_chunk."""
    return (f32_serve_chunk, f32_fwd_chunk,
            f32_persist_chunk)[f32_form(M, N, K)](M, N, K, sms)


# gemm_f32's backward forms (csrc/gemm_f32.cu gemm_f32_bwd_kernel: A @
# W^T on transposed copies, and the weight gradient) with EPI_F32: the
# tile's rows and columns and its blocks an SM (BwdShape; the gelu' form
# runs 128 x 128 tiles in one pass)
F32_BWD_TILE, F32_BWD_TILE_N, F32_BWD_BLOCKS = 128, 256, 1


def f32_nt_chunk(M, N, K, sms):
    """K chunk of A @ W^T in fp32 (K: one pass): K where the backward
    tiles give every SM F32_BWD_BLOCKS blocks (the training step's 11,520
    rows: 720-2,880 tiles), else the fewest K chunks (whole k-steps
    dividing K, at most F32_MAX_SPLITS) that do, or the most there are."""
    tiles = _cdiv(M, F32_BWD_TILE) * _cdiv(N, F32_BWD_TILE_N)
    chunk = K
    for c in range(2, F32_MAX_SPLITS + 1):
        if tiles * (K // chunk) >= F32_BWD_BLOCKS * sms:
            break
        if K % (c * F32_K_STEP) == 0:
            chunk = K // c
    return chunk


@functools.lru_cache(maxsize=None)
def f32_plan(M, N, K, device, trans_b=False, form=None) -> int:
    """f32_chunk (f32_nt_chunk with trans_b; the plan of `form` where one
    is given) on `device`'s SMs."""
    sms = sm_count(device)
    if trans_b:
        return f32_nt_chunk(M, N, K, sms)
    if form is None:
        return f32_chunk(M, N, K, sms)
    return (f32_serve_chunk, f32_fwd_chunk, f32_persist_chunk)[form](
        M, N, K, sms)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def gemm_chunk(M, N, K, device):
    """small_plan at the library's tiles for a call on `device`."""
    c = build.gemm_consts()
    return small_plan(M, N, K, sm_count(device), c.small_n, c.k_step,
                      c.small_rows, c.small_splits, c.tile_m)


# ------------------------------------------------------- kernel launches

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(cond: bool, what) -> None:
    """Raise ValueError(what()) unless cond; `what` builds the message only
    on failure (these checks run on every launch)."""
    if not cond:
        raise ValueError(f"CUDA kernel path: {what()}")


def _desc(t):
    return f"{t.dtype} {tuple(t.shape)} on {t.device}"


def check_emit(emit_kv, emit_train):
    """The temporal branches' two extra-output modes exclude each other, as
    gtax asserts (gtax/kernels/quant.py:425)."""
    if emit_kv and emit_train:
        raise ValueError("emit_kv and emit_train are exclusive")


def forward_only(name, *args):
    """Refuse a gradient through a forward-only wrapper, on every device:
    the CUDA kernel writes its outputs through ctypes, so a result would
    carry no gradient, and gtax's Pallas kernel has none either (jax.grad
    through it fails: "Linearization failed to produce known values").
    Raises when grad mode is on and a tensor argument requires grad; the
    trainable branches of gtax_torch.nn.branches call the fused wrappers
    inside their autograd.Function, where grad mode is off."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        raise RuntimeError(
            f"{name} is forward-only: its CUDA kernel has no gradient, and "
            "gtax's Pallas kernel has none either (jax.grad through it "
            "fails). Call it under torch.no_grad(), or train through the "
            "trainable branches (gtax_torch.nn.branches) or another "
            "attention backend.")


# the compute dtypes the kernels take: bf16, and fp32 (the fp32 forms)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_rows(name, t, rows, D, dtype=torch.bfloat16):
    """(rows, D) per-frame vectors: unit column stride, any row stride."""
    _need(t.is_cuda and t.dtype == dtype and t.dim() == 2
          and t.shape[0] == rows and t.shape[1] == D and t.stride(1) == 1,
          lambda: f"{name} must be a CUDA {dtype} ({rows}, {D}) tensor with "
                  f"unit column stride (x's dtype: the kernels take bf16 or "
                  f"fp32), got {_desc(t)}")


def _check_mat(name, t, shape, dtype=torch.bfloat16):
    _need(t.is_cuda and t.dtype == dtype and t.shape == shape
          and t.is_contiguous(),
          lambda: f"{name} must be a contiguous CUDA {dtype} {shape} "
                  f"tensor, got {_desc(t)}")


def _check_bias(name, b, n):
    _need(b.is_cuda and b.dtype in (torch.bfloat16, torch.float32)
          and b.numel() == n and b.is_contiguous(),
          lambda: f"{name} must be a contiguous CUDA bf16/fp32 vector of "
                  f"{n}, got {_desc(b)}")


def launch_ln_mod(x, out, rows, D, S, mode, p0, p1, p_stride=0,
                  row_scale=None):
    """mode LN_MODULATE, LN_AFFINE or LN_INT8 (int8 out and its row scales)
    over x's dtype: for fp32 rows their fp32 modes (out fp32, or int8 from
    the fp32 modulate)."""
    if x.dtype == torch.float32:
        mode = LN_INT8_F32 if mode == LN_INT8 else mode + LN_F32
    build.launch("gtax_ln_mod", x.data_ptr(), out.data_ptr(),
                 None if row_scale is None else row_scale.data_ptr(),
                 p0.data_ptr(), p1.data_ptr(), rows, D, S, p_stride, mode,
                 _stream(x))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _k_split(a, M, N, K, k_chunk=None):
    """(k_chunk, fp32 partials or None) of a bf16 GEMM launch: gemm_chunk's
    K chunk by default; a workspace of one (M, N) partial a chunk where
    there is more than one."""
    if k_chunk is None:
        k_chunk = gemm_chunk(M, N, K, a.device)
    splits = -(-K // k_chunk) if k_chunk else 1
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=a.device)
    return k_chunk, part


def launch_gemm(a, w, out, M, N, K, epi, bias=None, resid=None, gate=None,
                S=1, out2=None, aux=None, colsum=None, trans_b=False,
                k_chunk=None):
    """out = epilogue(a @ w), or a @ w^T with trans_b (w stored (N, K));
    out2/aux/colsum: the second output, the h1 input and the per-tile
    column sums of the emit_train and gelu' epilogues. k_chunk: the
    small-M path's K chunk (0: the tiled path), gemm_chunk's by default;
    its grid (N / 64 x chunks) must fit on the card at once."""
    k_chunk, part = _k_split(a, M, N, K, k_chunk)
    build.launch(
        "gtax_gemm_bf16", a.data_ptr(), w.data_ptr(), out.data_ptr(),
        _ptr(out2), _ptr(aux), _ptr(colsum), _ptr(bias),
        int(bias is not None and bias.dtype == torch.float32), _ptr(resid),
        _ptr(gate), 0 if gate is None else gate.stride(0), M, N, K, S, epi,
        int(trans_b), k_chunk, _ptr(part), _stream(a))


# the epilogues gemm_f32 takes (csrc/gemm_f32.cu): the serving ones, the
# emit_train ones with a second output, and (with trans_b) the gelu' one
F32_EPILOGUES = (EPI_F32, EPI_BIAS_BF16, EPI_BIAS_GELU_TANH, EPI_BIAS_GELU_ERF,
                 EPI_BIAS_BF16_GELU, EPI_BIAS_GATED, EPI_BIAS_BF16_RESID,
                 EPI_BIAS_GATED_Y, EPI_BIAS_GELU_TANH_H, EPI_BIAS_GELU_ERF_H,
                 EPI_DGELU)
# the epilogues that store a second output (out2)
TWO_OUTPUTS = (EPI_BIAS_GATED_Y, EPI_BIAS_GELU_TANH_H, EPI_BIAS_GELU_ERF_H,
               EPI_DGELU)
# the rows of a gelu' column partial in gemm_f32 (a 64-row slab of either
# tile)
F32_SLAB = 64


def launch_gemm_f32(a, w, out, M, N, K, epi, bias=None, resid=None,
                    gate=None, S=1, k_chunk=None, out2=None, aux=None,
                    colsum=None, trans_b=False, lda=0, ldc=0, fwd=None,
                    blocks=None):
    """out = epilogue(a @ w), or a @ w^T with trans_b (w stored (N, K)),
    all fp32, on the CUDA cores (gemm_f32): each of F32_EPILOGUES stores
    its value before the bf16 epilogue's rounding (EPI_BIAS_BF16: acc +
    bias; EPI_BIAS_BF16_GELU: the erf GELU of it; EPI_BIAS_BF16_RESID: x +
    acc + bias); the TWO_OUTPUTS ones also store out2 (acc + bias, or
    EPI_DGELU's gelu(aux) with u = gelu'(aux) * acc in out and the 64-row
    slabs' column sums of u in colsum). trans_b takes EPI_F32 and
    EPI_DGELU, run on transposed copies of a and w in a workspace.
    k_chunk: the form's plan by default (f32_plan; EPI_DGELU: K, one
    pass); below K, the chunks' partials are added in order before the
    epilogue: on the serving form (at most F32_MAX_CLUSTER chunks) through
    a thread-block cluster's shared memory, on the persistent form through
    a workspace of its units' tiles, else through an (M, N) fp32 workspace
    a chunk. fwd: the forward's form (F32_FORM_*; False and True: the
    serving and the k-major form), f32_form's by default. The k-major form
    (gemm_f32_fwd_kernel, whatever M): a row-major `a` is copied
    transposed into the workspace first, or lda > 0 hands `a` over
    k-major, (K, lda); ldc > 0 (a GELU epilogue) stores out transposed,
    (N, ldc) (f32_fwd_ld gives both strides). The persistent form
    (gemm_f32_persist_kernel) runs on `blocks` blocks, f32_persist_grid's
    (one round of the card) by default; the bits do not depend on them."""
    _need(epi in F32_EPILOGUES and (out2 is not None) == (epi in TWO_OUTPUTS)
          and (not trans_b or epi in (EPI_F32, EPI_DGELU))
          and (trans_b or epi != EPI_DGELU),
          lambda: f"gemm_f32 has no epilogue {epi}"
                  + (" with trans_b" if trans_b else "")
                  + (" with a second output" if out2 is not None else ""))
    if epi == EPI_DGELU:
        k_chunk = K
    form = _f32_form(M, N, K, trans_b, fwd)
    k_chunk, part = _f32_split(a, M, N, K, k_chunk, trans_b, lda, form)
    flags = None
    if form == F32_FORM_PERSIST:
        if blocks is None:
            blocks = f32_persist_grid(M, N, K, k_chunk, sm_count(a.device))
        if k_chunk < K:
            flags = _f32_flags(a, M, N)
    build.launch(
        "gtax_gemm_f32", a.data_ptr(), w.data_ptr(), out.data_ptr(),
        _ptr(out2), _ptr(aux), _ptr(colsum), _ptr(bias),
        int(bias is not None and bias.dtype == torch.float32), _ptr(resid),
        _ptr(gate), 0 if gate is None else gate.stride(0), M, N, K, S, epi,
        int(trans_b), k_chunk, lda, ldc, form, blocks or 0, _ptr(flags),
        _ptr(part), _stream(a))


# the persistent form's counters: two a tile, zero between launches (the
# kernel zeroes those it used); one buffer of F32_FLAGS_WORDS, made once for
# a device and stream, or for a CUDA graph's capture (capture.owned: its
# replays share their counters with no other launch), and never replaced
F32_FLAGS_WORDS = 1 << 14


def _f32_flags(a, M, N):
    """The persistent form's zeroed counters for an (M, N) output on a's
    device and current stream, or of the capture this thread is in."""
    n = 2 * _cdiv(M, F32_PERSIST_TILE) * _cdiv(N, F32_PERSIST_TILE_N)
    _need(n <= F32_FLAGS_WORDS,
          lambda: f"gemm_f32: the persistent form at ({M}, {N}) needs {n} "
                  f"tile counters, more than its {F32_FLAGS_WORDS}")
    return capture.owned(
        ("f32_flags", _stream(a)), a.device,
        lambda dev: torch.zeros(F32_FLAGS_WORDS, dtype=torch.int32,
                                device=dev))


def gemm_any(a, w, out, M, N, K, epi, **kw):
    """launch_gemm for bf16 operands, launch_gemm_f32 for fp32 ones."""
    if a.dtype == torch.float32:
        return launch_gemm_f32(a, w, out, M, N, K, epi, **kw)
    return launch_gemm(a, w, out, M, N, K, epi, **kw)


# The fp32 frame attention's query tiles (csrc/attn_f32.cuh
# GTAX_F32_FRAME_SHAPES, index for index): (whole, rows a thread, row
# groups). Whole shapes (S <= F32_WHOLE_KEYS: a head's K and V whole in
# shared memory, one softmax pass) take 16 lanes a row, 12 row groups, and
# 24, 48 or 72 query rows (144 tokens in 6, 3 or 2 tiles); the ring shape
# (S past it: 64-key tiles through a cp.async ring) 8 lanes a row, 4 rows a
# thread, 64 query rows (576 tokens in 9). Within a kind a row's
# arithmetic, so its bits, do not depend on the shape. Kept from the tiles
# timed at the main path's calls (attn_sweep.py --f32-frame; PERF.md
# section 6): at 144 tokens 24 rows the fastest at one frame, 48 at two and
# four, 72 at eighty (16 and 18 rows, 36 rows, never the fastest, went); at
# 576 the 64-row ring beside 96 and 144 rows. The fp32 pair takes each (at
# most its 256 threads, buffers inside its GEMM ring).
F32_FRAME_SHAPES = ((True, 2, 12), (True, 4, 12), (True, 6, 12),
                    (False, 4, 16))
F32_WHOLE_KEYS = 144
# blocks of a whole shape an SM runs at once (up to 110 KB of shared
# memory each at head dim 64): the rule's slots are this many per SM
F32_FRAME_BLOCKS = 2


def f32_frame_rows(shape: int) -> int:
    """Query rows of a block of the fp32 frame attention's `shape`."""
    _, tr, rg = F32_FRAME_SHAPES[shape]
    return tr * rg


def f32_frame_shape(S: int, heads: int, n_frames: int, slots: int) -> int:
    """The query tile of an fp32 frame attention call: among the shapes of
    S's kind, the largest tile whose units
    ((query tile, head, frame)) fill one round of `slots` (the blocks the
    card runs at once: F32_FRAME_BLOCKS an SM, or the pair's cooperative
    grid, which takes its units one after another) to two thirds and no
    further (fewer rows a thread leave shared memory the limit, so a tile
    is cut only to fill the card); where none does, the tile of the fewest
    rounds, the most units among them. One frame of 144 tokens at 16 heads
    on 132 SMs: 24-row tiles, 96 units."""
    whole = S <= F32_WHOLE_KEYS
    kind = [i for i, sh in enumerate(F32_FRAME_SHAPES) if sh[0] == whole]

    def units(i):
        return _cdiv(S, f32_frame_rows(i)) * heads * n_frames

    fill = [i for i in kind if 2 * slots <= 3 * units(i) <= 3 * slots]
    if fill:
        return max(fill, key=f32_frame_rows)
    return min(kind, key=lambda i: (_cdiv(units(i), slots), -units(i)))


def f32_frame_slots(device) -> int:
    """The fp32 frame attention's blocks at once on `device`'s card (the
    rule's slots for a launch of its own)."""
    return F32_FRAME_BLOCKS * sm_count(device)


def launch_attn_frame_f32(qkv, freqs, out, n_frames, S, D, num_heads, rot,
                          qkv_out=None, shape=None):
    """The fp32 frame attention: qkv (n_frames * S, 3D) fp32 rows, rope on
    the first rot dims of each head's q and k, into out (n_frames * S, D)
    fp32; nothing rounded. Two launches: a rope pass (each position's
    angles reduced once, q and k roped into a workspace) and the attention
    over the roped rows. qkv_out: an optional (q, k, v) triple of fp32
    outputs (the emit_train residuals: the roped q, k and the v), which the
    rope pass fills in place of the workspace. shape: the query tile
    (F32_FRAME_SHAPES), f32_frame_shape's on the card by default."""
    q, k, v = qkv_out or (None, None, None)
    ws = None
    if q is None:
        ws = torch.empty((n_frames * S, 2 * D), dtype=torch.float32,
                         device=qkv.device)
    if shape is None:
        shape = f32_frame_shape(S, num_heads, n_frames,
                                f32_frame_slots(qkv.device))
    build.launch("gtax_attn_frame_f32", qkv.data_ptr(), freqs.data_ptr(),
                 out.data_ptr(), _ptr(q), _ptr(k), _ptr(v), _ptr(ws),
                 n_frames, S, D, num_heads, rot, shape, _stream(qkv))


def launch_attn_frame(qkv, freqs, out, n_frames, S, D, num_heads, rot,
                      qkv_out=None):
    """qkv and out are fp32 or bf16, as allocated; qkv_out an optional
    (q, k, v) triple of bf16 outputs (the emit_train residuals)."""
    q, k, v = qkv_out or (None, None, None)
    build.launch("gtax_attn_frame", qkv.data_ptr(),
                 int(qkv.dtype == torch.float32), freqs.data_ptr(),
                 out.data_ptr(), int(out.dtype == torch.float32), _ptr(q),
                 _ptr(k), _ptr(v), n_frames, S, D, num_heads, rot,
                 _stream(qkv))


def launch_gemm_rope_qkv(mod, qkv_w, q, k, v, freqs, S, n_q, q_off, hd):
    """q, k, v (M, D) bf16 = the thirds of mod (M, D) @ qkv_w (D, 3D),
    rope on q and k at each row's window slot (q_off + (r / S) % n_q of
    freqs), rounded once: the EPI_F32 product's mainloop and K chunk with
    the rope epilogue."""
    M, D = mod.shape
    k_chunk, part = _k_split(mod, M, 3 * D, D)
    build.launch("gtax_gemm_rope_qkv", mod.data_ptr(), qkv_w.data_ptr(),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), freqs.data_ptr(),
                 M, D, S, n_q, q_off, hd, k_chunk, _ptr(part), _stream(mod))


def launch_attn_window(q, k, v, out, B, T, S, D, num_heads, bits):
    """The full-window temporal attention over post-rope q, k, v
    (B * T * S, D) rows into out (the same shape), all bf16 or all fp32
    (attn_temporal_window_f32)."""
    name = ("gtax_attn_temporal_window_f32" if q.dtype == torch.float32
            else "gtax_attn_temporal_window")
    build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, T, S, D, num_heads, bits, _stream(q))


def _f32_form(M, N, K, trans_b=False, fwd=None) -> int:
    """The C entry's fwd_form of a launch: fwd as given (a bool: the
    serving or the k-major form), else f32_form's; 0 with trans_b."""
    if trans_b:
        return F32_FORM_SERVE
    return f32_form(M, N, K) if fwd is None else int(fwd)


def _f32_split(a, M, N, K, k_chunk=None, trans_b=False, lda=0, fwd=None):
    """(k_chunk, fp32 workspace or None) of an fp32 GEMM launch: the plan's
    K chunk of the form (fwd, as _f32_form reads it) by default; where
    there is more than one, one (M, N) partial a chunk (the forward's
    k-major form, or trans_b) or one tile a unit (the persistent form,
    f32_persist_units x its tile), after the transposed copies of a, its
    rows padded to a multiple of 4 (K M4; the k-major form unless lda
    hands a over k-major), and (trans_b) of w (K N)."""
    form = _f32_form(M, N, K, trans_b, fwd)
    if k_chunk is None:
        k_chunk = f32_plan(M, N, K, a.device, trans_b,
                           None if trans_b else form)
    fwd = form == F32_FORM_K_MAJOR
    # on the serving form a split's partials stay in the cluster
    split = k_chunk < K and (trans_b or fwd)
    n = _cdiv(K, k_chunk) * M * N if split else 0
    if form == F32_FORM_PERSIST and k_chunk < K:
        n = (f32_persist_units(M, N, K, k_chunk) * F32_PERSIST_TILE
             * F32_PERSIST_TILE_N)
    if trans_b:
        n += K * (_cdiv(M, 4) * 4 + N)
    elif fwd and not lda:
        n += K * _cdiv(M, 4) * 4
    part = None
    if n:
        part = torch.empty(n, dtype=torch.float32, device=a.device)
    return k_chunk, part


def launch_gemm_f32_rope_qkv(mod, qkv_w, q, k, v, freqs, S, n_q, q_off, hd,
                             k_chunk=None, fwd=None):
    """launch_gemm_rope_qkv in fp32 (gemm_f32's rope epilogue): q, k, v
    fp32, nothing rounded; the serving or the k-major form (f32_fwd_form's
    by default; the rope product has no persistent form) and the K split
    as launch_gemm_f32's (the k-major form after mod's transposed copy)."""
    M, D = mod.shape
    fwd = f32_fwd_form(M, 3 * D, D) if fwd is None else bool(fwd)
    k_chunk, part = _f32_split(mod, M, 3 * D, D, k_chunk, fwd=fwd)
    build.launch("gtax_gemm_f32_rope_qkv", mod.data_ptr(), qkv_w.data_ptr(),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), freqs.data_ptr(),
                 M, D, S, n_q, q_off, hd, k_chunk, int(fwd), _ptr(part),
                 _stream(mod))


def launch_attn_temporal_f32(qkv, freqs, out, B, n_q, q_off, S, D,
                             num_heads, bits, k_ctx=None, v_ctx=None,
                             kv_out=None, q_out=None):
    """The fp32 form of launch_attn_temporal: qkv fp32 rows (rope on load),
    the fp32 context cache (the step), out fp32, kv_out an optional (K, V)
    pair of fp32 outputs (the full window's emit_kv), q_out (with kv_out)
    the roped Q; nothing rounded."""
    k_out, v_out = kv_out or (None, None)
    build.launch("gtax_attn_temporal_f32", qkv.data_ptr(), freqs.data_ptr(),
                 _ptr(k_ctx), _ptr(v_ctx), out.data_ptr(), _ptr(q_out),
                 _ptr(k_out), _ptr(v_out), B, n_q, q_off, S, D, num_heads,
                 bits, _stream(qkv))


def launch_attn_step_f32(qkv, freqs, out, B, n_q, q_off, S, D, num_heads,
                         bits, k_ctx, v_ctx):
    """#4's fp32 step attention (attn_step_f32: four dims a lane, each
    angle's factors formed once for a slot's q and k): the live frames'
    fp32 qkv rows, rope on load, over the fp32 cache; out fp32, nothing
    rounded."""
    build.launch("gtax_attn_step_f32", qkv.data_ptr(), freqs.data_ptr(),
                 k_ctx.data_ptr(), v_ctx.data_ptr(), out.data_ptr(), B, n_q,
                 q_off, S, D, num_heads, bits, _stream(qkv))


def launch_attn_temporal(qkv, freqs, out, B, n_q, q_off, S, D, num_heads,
                         bits, k_ctx=None, v_ctx=None, kv_out=None,
                         q_out=None):
    """qkv fp32; out fp32 or bf16, as allocated; kv_out an optional (K, V)
    pair of bf16 outputs; q_out (with kv_out) the roped Q."""
    build.launch(
        "gtax_attn_temporal", qkv.data_ptr(), freqs.data_ptr(),
        _ptr(k_ctx), _ptr(v_ctx), out.data_ptr(),
        int(out.dtype == torch.float32), _ptr(q_out),
        None if kv_out is None else kv_out[0].data_ptr(),
        None if kv_out is None else kv_out[1].data_ptr(),
        B, n_q, q_off, S, D, num_heads, bits, _stream(qkv))


def _check_branch(x, shift, scale, gate, dtypes=KERNEL_DTYPES):
    """x (N, S, D) contiguous in one of `dtypes` (the backwards: bf16),
    shift/scale/gate in x's dtype; returns (N, S, D)."""
    _need(x.is_cuda and x.dtype in dtypes and x.dim() == 3
          and x.is_contiguous(),
          lambda: f"x must be a contiguous CUDA (N, S, D) tensor of "
                  f"{' or '.join(map(str, dtypes))}, got {_desc(x)}")
    N, S, D = x.shape
    _need(D % 64 == 0, lambda: f"D={D} must be a multiple of 64")
    for name, t in (("shift", shift), ("scale", scale), ("gate", gate)):
        _check_rows(name, t, N, D, x.dtype)
    return N, S, D


def _modulate_cuda(x, shift, scale):
    """The modulated rows (N * S, D) in x's dtype (ln_mod)."""
    N, S, D = x.shape
    _need(shift.stride(0) == scale.stride(0),
          lambda: "shift and scale must share a row stride")
    mod = torch.empty((N * S, D), dtype=x.dtype, device=x.device)
    launch_ln_mod(x, mod, N * S, D, S, LN_MODULATE, shift, scale,
                  shift.stride(0))
    return mod


def _check_heads(D, num_heads, head_dims):
    """The attention kernels are compiled for these head dims."""
    _need(D % num_heads == 0 and D // num_heads in head_dims,
          lambda: f"head dim of D={D} over {num_heads} heads must be one of "
                  f"{head_dims}")
    return D // num_heads


def _check_hidden(Hd):
    _need(Hd % 64 == 0, lambda: f"MLP width {Hd} must be a multiple of 64")


def _check_freqs(freqs, rows, cols):
    _check_mat("rope_freqs", freqs, (rows, cols), torch.float32)


def _check_attn_weights(qkv_w, out_w, out_b, D, dtype=torch.bfloat16):
    _check_mat("qkv_w", qkv_w, (D, 3 * D), dtype)
    _check_mat("out_w", out_w, (D, D), dtype)
    _check_bias("out_b", out_b, D)


# ------------------------------------------------------------- wrappers

def fused_spatial_branch(x, shift, scale, gate, qkv_w, out_w, out_b,
                         rope_freqs, num_heads, emit_train=False):
    """x: (N, S, D) per-frame token tiles; shift/scale/gate: (N, D);
    qkv_w: (D, 3D); out_w: (D, D); out_b: (D,); rope_freqs: (S, head_dim)
    pixel-axial table. Returns x + gate * SpatialAttention(modulate(LN(x))),
    or with emit_train (out, q, k, v, y), all (N, S, D).

    Replaces gtax/kernels/block.py fused_spatial_branch (pallas_call at
    :846, body _kernel :214, core _spatial_attention_core :137). On the
    card: ln_mod -> gemm (fp32 qkv) -> attn_frame (full-d rope on load) ->
    gemm (+bias, gated residual): 4 launches, in fp32 the fp32 forms
    (gemm_f32, attn_frame_f32; with emit_train their residual stores).
    Bound: the 8 MB of qkv/out weights at the
    serving row counts (bytes; fp32: operations); see PERF.md for the
    measured time against that bound."""
    forward_only("fused_spatial_branch", x, shift, scale, gate, qkv_w, out_w,
                 out_b)
    if x.device.type == "cpu":
        return spatial_branch_plain(x, shift, scale, gate, qkv_w, out_w,
                                    out_b, rope_freqs, num_heads, emit_train)
    N, S, D = _check_branch(x, shift, scale, gate)
    _check_attn_weights(qkv_w, out_w, out_b, D, x.dtype)
    d = _check_heads(D, num_heads, (32, 64))
    _check_freqs(rope_freqs, S, d)
    mod = _modulate_cuda(x, shift, scale)
    qkv = torch.empty((N * S, 3 * D), dtype=torch.float32, device=x.device)
    gemm_any(mod, qkv_w, qkv, N * S, 3 * D, D, EPI_F32)
    att = torch.empty((N * S, D), dtype=x.dtype, device=x.device)
    res = tuple(torch.empty_like(x) for _ in range(4)) if emit_train else None
    if x.dtype == torch.float32:
        launch_attn_frame_f32(qkv, rope_freqs, att, N, S, D, num_heads, d,
                              qkv_out=res and res[:3])
    else:
        launch_attn_frame(qkv, rope_freqs, att, N, S, D, num_heads, d,
                          qkv_out=res and res[:3])
    out = torch.empty_like(x)
    gemm_any(att, out_w, out, N * S, D, D,
             EPI_BIAS_GATED_Y if emit_train else EPI_BIAS_GATED, bias=out_b,
             resid=x, gate=gate, S=S, out2=res and res[3])
    capture.launched(fused_spatial_branch)
    return (out, *res) if emit_train else out


fused_spatial_branch.launches = 0


def fused_mlp_branch(x, shift, scale, gate, w1, b1, w2, b2,
                     approx_gelu=True, emit_train=False):
    """x: (N, S, D); shift/scale/gate: (N, D); w1: (D, H); w2: (H, D).
    Returns x + gate * (fc2(gelu(fc1(modulate(LN(x))))) ), the tanh GELU
    (approx_gelu, gtax's default and the DiT's) or the exact one, or with
    emit_train (out, h1 (N, S, H), y (N, S, D)).

    Replaces gtax/kernels/block.py fused_mlp_branch (pallas_call at :779,
    body _mlp_kernel :715). On the card: ln_mod -> gemm (+b1, GELU, bf16)
    -> gemm (+b2, gated residual): 3 launches, in fp32 on gemm_f32. Bound:
    the 16 MB of fc1/fc2 weights at serving row counts (bytes; fp32:
    operations); tensor-core rate at prefill and VAE-size row counts."""
    forward_only("fused_mlp_branch", x, shift, scale, gate, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return mlp_branch_plain(x, shift, scale, gate, w1, b1, w2, b2,
                                approx_gelu, emit_train)
    N, S, D = _check_branch(x, shift, scale, gate)
    Hd = w1.shape[-1]
    _check_hidden(Hd)
    _check_mat("w1", w1, (D, Hd), x.dtype)
    _check_mat("w2", w2, (Hd, D), x.dtype)
    _check_bias("b1", b1, Hd)
    _check_bias("b2", b2, D)
    mod = _modulate_cuda(x, shift, scale)
    # fp32 on the k-major form: fc1 stores the GELU rows k-major, as
    # fc2's form reads them
    ld = f32_fwd_ld(x.dtype, N * S, Hd, D)
    h = torch.empty((Hd, ld) if ld else (N * S, Hd), dtype=x.dtype,
                    device=x.device)
    h1 = (torch.empty((N * S, Hd), dtype=x.dtype, device=x.device)
          if emit_train else None)
    if approx_gelu:
        epi = EPI_BIAS_GELU_TANH_H if emit_train else EPI_BIAS_GELU_TANH
    else:
        epi = EPI_BIAS_GELU_ERF_H if emit_train else EPI_BIAS_GELU_ERF
    gemm_any(mod, w1, h, N * S, Hd, D, epi, bias=b1, out2=h1,
             **({"ldc": ld} if ld else {}))
    out = torch.empty_like(x)
    y = torch.empty_like(x) if emit_train else None
    gemm_any(h, w2, out, N * S, D, Hd,
             EPI_BIAS_GATED_Y if emit_train else EPI_BIAS_GATED, bias=b2,
             resid=x, gate=gate, S=S, out2=y, **({"lda": ld} if ld else {}))
    capture.launched(fused_mlp_branch)
    return (out, h1.reshape(N, S, Hd), y) if emit_train else out


fused_mlp_branch.launches = 0


def check_window(T) -> None:
    """The temporal kernels take windows of 1 .. MAX_WINDOW frames: their
    register arrays, and the window kernels' instantiations of T."""
    _need(1 <= T <= MAX_WINDOW,
          lambda: f"window of {T} frames: the kernels take 1 to "
                  f"{MAX_WINDOW}")


def check_temporal(D, num_heads, T, rope_freqs):
    """The temporal attention kernels' limits; returns the head dim."""
    d = _check_heads(D, num_heads, (32, 64, 128))
    check_window(T)
    _check_freqs(rope_freqs, T, d)
    return d


def _temporal_window_cuda(x, shift, scale, gate, qkv_w, out_w, out_b,
                          rope_freqs, num_heads, T, bits, emit_kv,
                          emit_train, emit_mod):
    """The full window: ln_mod -> gemm_rope_qkv (q, k, v bf16, also the
    emitted K/V and residuals) -> attn_temporal_window -> gemm (gated
    residual, y with emit_train)."""
    N, S, D = x.shape
    d = check_temporal(D, num_heads, T, rope_freqs)
    _check_attn_weights(qkv_w, out_w, out_b, D, x.dtype)
    mod = _modulate_cuda(x, shift, scale)
    q, k, v, att = (torch.empty_like(x) for _ in range(4))
    if x.dtype == torch.float32:
        launch_gemm_f32_rope_qkv(mod, qkv_w, q, k, v, rope_freqs, S, T, 0, d)
    else:
        launch_gemm_rope_qkv(mod, qkv_w, q, k, v, rope_freqs, S, T, 0, d)
    launch_attn_window(q, k, v, att, N // T, T, S, D, num_heads, bits)
    out = torch.empty_like(x)
    y = torch.empty_like(x) if emit_train else None
    gemm_any(att, out_w, out, N * S, D, D,
             EPI_BIAS_GATED_Y if emit_train else EPI_BIAS_GATED, bias=out_b,
             resid=x, gate=gate, S=S, out2=y)
    if emit_train:  # (out, q, k, v, y), as gtax returns them
        res = (out, q, k, v, y)
        return (*res, mod.reshape(N, S, D)) if emit_mod else res
    return (out, k, v) if emit_kv else out


def _temporal_step_cuda(x, shift, scale, gate, qkv_w, out_w, out_b,
                        rope_freqs, num_heads, B, n_q, q_off, bits, k_ctx,
                        v_ctx):
    """The incremental step: ln_mod -> gemm (fp32 qkv) -> attn_temporal
    (rope on load, step mode over the cache; in fp32 attn_step_f32) ->
    gemm (gated residual). In fp32 the last three launch as programmatic
    dependents, each loading what does not depend on the launch before it
    (weights, the cache) before waiting for that launch's end."""
    N, S, D = x.shape
    check_temporal(D, num_heads, q_off + n_q, rope_freqs)
    _check_attn_weights(qkv_w, out_w, out_b, D, x.dtype)
    mod = _modulate_cuda(x, shift, scale)
    qkv = torch.empty((N * S, 3 * D), dtype=torch.float32, device=x.device)
    gemm_any(mod, qkv_w, qkv, N * S, 3 * D, D, EPI_F32)
    att = torch.empty((N * S, D), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        launch_attn_step_f32(qkv, rope_freqs, att, B, n_q, q_off, S, D,
                             num_heads, bits, k_ctx, v_ctx)
    else:
        launch_attn_temporal(qkv, rope_freqs, att, B, n_q, q_off, S, D,
                             num_heads, bits, k_ctx, v_ctx)
    out = torch.empty_like(x)
    gemm_any(att, out_w, out, N * S, D, D, EPI_BIAS_GATED, bias=out_b,
             resid=x, gate=gate, S=S)
    return out


def fused_temporal_branch(x, shift, scale, gate, qkv_w, out_w, out_b,
                          rope_freqs, valid, num_heads, n_frames,
                          emit_kv=False, emit_train=False, emit_mod=False):
    """x: (N = B*T, S, D) frame-major token tiles; shift/scale/gate:
    (N, D); rope_freqs: (T, head_dim) temporal table; valid: (T,) bools or
    None. Returns x + gate * TemporalCausalAttention(modulate(LN(x))), and
    with emit_kv also the post-rope K and cast V rows (N, S, D) — the
    context cache fused_temporal_step reads — or with emit_train
    (out, q, k, v, y) (not both). emit_mod (with emit_train; the trainable
    branch's own keyword) appends the modulated rows mod (N, S, D) the qkv
    product read, which fused_temporal_branch_bwd takes instead of forming
    them again.

    Replaces gtax/kernels/block.py fused_temporal_branch (pallas_call at
    :687, body _temporal_kernel :253, core _temporal_attention_core :297,
    mask temporal_preamble :615). On the card: ln_mod -> gemm_rope_qkv
    (rope and the bf16 rounding in the qkv product's epilogue, which stores
    q, k, v: the emitted K/V and residuals) -> attn_temporal_window (16-byte
    lanes, T a template parameter) -> gemm (gated residual): 4 launches.
    Bound: weight bytes at the prefill's rows, operations at training's."""
    forward_only("fused_temporal_branch", x, shift, scale, gate, qkv_w, out_w,
                 out_b)
    check_emit(emit_kv, emit_train)
    if emit_mod and not emit_train:
        raise ValueError("emit_mod comes with emit_train")
    if x.device.type == "cpu":
        return temporal_branch_plain(x, shift, scale, gate, qkv_w, out_w,
                                     out_b, rope_freqs, valid, num_heads,
                                     n_frames, emit_kv, emit_train, emit_mod)
    N, S, D = _check_branch(x, shift, scale, gate)
    _need(N % n_frames == 0,
          lambda: f"N={N} is not a multiple of T={n_frames}")
    out = _temporal_window_cuda(x, shift, scale, gate, qkv_w, out_w, out_b,
                                rope_freqs, num_heads, n_frames,
                                valid_bits(valid, n_frames), emit_kv,
                                emit_train, emit_mod)
    capture.launched(fused_temporal_branch)
    return out


fused_temporal_branch.launches = 0


def fused_temporal_step(x, shift, scale, gate, qkv_w, out_w, out_b, k_ctx,
                        v_ctx, rope_freqs, valid, num_heads, n_ctx,
                        n_live=1):
    """Incremental temporal branch: x (B*n_live, S, D) = the live frames'
    tokens at window slots n_ctx..n_ctx+n_live-1; k_ctx/v_ctx
    (B*n_ctx*S, D) post-rope cache (fused_temporal_branch emit_kv);
    rope_freqs (T, head_dim), T = n_ctx + n_live; valid (T,) or None.
    Returns x + gate * CausalAttention_liveslots(modulate(LN(x))).

    Replaces gtax/kernels/block.py fused_temporal_step (pallas_call at
    :518/:548, body _temporal_step_kernel :463, core _temporal_step_core
    :364). On the card: ln_mod -> gemm (fp32 qkv) -> attn_temporal (rope
    on load, step mode over the cache) -> gemm (gated residual): 4
    launches. Bound:
    weight bytes; the context cache adds ~1.2 MB per batch element."""
    forward_only("fused_temporal_step", x, shift, scale, gate, qkv_w, out_w,
                 out_b, k_ctx, v_ctx)
    if x.device.type == "cpu":
        return temporal_step_plain(x, shift, scale, gate, qkv_w, out_w,
                                   out_b, k_ctx, v_ctx, rope_freqs, valid,
                                   num_heads, n_ctx, n_live)
    N, S, D = _check_branch(x, shift, scale, gate)
    _need(N % n_live == 0,
          lambda: f"N={N} is not a multiple of n_live={n_live}")
    B = N // n_live
    _need(n_ctx >= 1, lambda: "the step needs at least one context frame")
    for name, t in (("k_ctx", k_ctx), ("v_ctx", v_ctx)):
        _check_mat(name, t, (B * n_ctx * S, D), x.dtype)
    out = _temporal_step_cuda(x, shift, scale, gate, qkv_w, out_w, out_b,
                              rope_freqs, num_heads, B, n_live, n_ctx,
                              valid_bits(valid, n_ctx + n_live), k_ctx,
                              v_ctx)
    capture.launched(fused_temporal_step)
    return out


fused_temporal_step.launches = 0
