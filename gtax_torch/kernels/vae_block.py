"""The ViT-VAE block: CUDA kernels on the card, plain PyTorch on the CPU.

Counterpart of gtax/kernels/vae_block.py. One call runs one encoder or
decoder AttentionBlock over all N frames: LN1(affine) -> qkv + bias ->
partial pixel rope -> per-frame attention -> out + bias -> +x -> LN2 ->
fc1 + bias -> erf-GELU -> fc2 + bias -> +x.

Rounding points (as in the TPU kernel): LN and softmax in fp32; qkv + bias
is cast to the compute dtype BEFORE the partial rope, which runs in fp32 on
the first `rot` dims of each head; each head's attention output is cast;
both residual adds happen in the compute dtype; fc1 + bias is cast before
the GELU and after it. The TPU kernel approximated erf (A-S 7.1.26, abs err
<= 1.5e-7); the card uses erff and the plain version torch.erf. In fp32
(x fp32, the GEMM weights fp32) every cast is the identity and the card
runs the fp32 forms: ln_mod's fp32 affine mode, gemm_f32 (fp32 FFMA, no
TF32) and attn_frame_f32.
"""

from __future__ import annotations

import torch

from gtax_torch.core.rope import apply_rotary_emb
from gtax_torch.kernels import block as _blk
from gtax_torch.kernels import capture
from gtax_torch.kernels.block import (
    EPI_BIAS_BF16,
    EPI_BIAS_BF16_GELU,
    EPI_BIAS_BF16_RESID,
    LN_AFFINE,
    attend_frames,
    gemm_any,
    ln32,
    mm32,
)


def gelu_erf32(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476))


def vae_block_plain(x, ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_w,
                    ln2_b, w1, b1, w2, b2, rope_freqs, num_heads):
    N, S, D = x.shape
    dt, H = x.dtype, num_heads
    h = (ln32(x.float()) * ln1_w.float() + ln1_b.float()).to(dt)
    qkv = (mm32(h, qkv_w) + qkv_b.float()).to(dt)
    q, k, v = (t.reshape(N, S, H, D // H) for t in qkv.split(D, dim=-1))
    f = rope_freqs[:, None, :]  # (S, 1, rot): the first rot dims of a head
    o = attend_frames(apply_rotary_emb(f, q), apply_rotary_emb(f, k), v, dt)
    y = (mm32(o.reshape(N, S, D), out_w) + out_b.float()).to(dt)
    xm = x + y
    h2 = (ln32(xm.float()) * ln2_w.float() + ln2_b.float()).to(dt)
    hh = (mm32(h2, w1) + b1.float()).to(dt)
    hh = gelu_erf32(hh.float()).to(dt)
    y2 = (mm32(hh, w2) + b2.float()).to(dt)
    return xm + y2


def fused_vae_block(x, ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b, ln2_w,
                    ln2_b, w1, b1, w2, b2, rope_freqs, num_heads):
    """x: (N, S, D) tokens of N frames; rope_freqs: (S, rot) partial pixel
    table (rot = head_dim // 2); GEMM weights in the compute dtype, LN
    parameters and biases fp32. Returns the block output, (N, S, D).

    Replaces gtax/kernels/vae_block.py fused_vae_block (pallas_call at
    :150, body _vae_block_kernel :56). On the card: ln_mod (affine) ->
    gemm (+bias, bf16) -> attn_frame (bf16 qkv, partial rope on load,
    tensor-core QK^T and PV) -> gemm (+bias, bf16, +x) -> ln_mod -> gemm
    (+bias, bf16, erf-GELU) -> gemm (+bias, bf16, +x): 7 launches, the
    GEMMs on the Hopper kernel (csrc/gemm_sm90.cuh); in fp32 the same 7 on
    the fp32 forms (gemm_f32, attn_frame_f32 walking the keys in tiles).
    Bound: tensor-core rate at the serving frame counts (a 576-row frame
    is past the bf16 ridge for its 25 MB of weights; fp32: the CUDA
    cores' rate); PERF.md has the time of each launch."""
    _blk.forward_only("fused_vae_block", x, ln1_w, ln1_b, qkv_w, qkv_b,
                      out_w, out_b, ln2_w, ln2_b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return vae_block_plain(x, ln1_w, ln1_b, qkv_w, qkv_b, out_w, out_b,
                               ln2_w, ln2_b, w1, b1, w2, b2, rope_freqs,
                               num_heads)
    _blk._need(x.is_cuda and x.dtype in _blk.KERNEL_DTYPES and x.dim() == 3
               and x.is_contiguous(),
               lambda: f"x must be a contiguous CUDA bf16 or fp32 (N, S, D) "
                       f"tensor, got {_blk._desc(x)}")
    N, S, D = x.shape
    Hd = w1.shape[-1]
    rot = rope_freqs.shape[-1]
    _blk._need(D % 64 == 0, lambda: f"D={D} must be a multiple of 64")
    hd = _blk._check_heads(D, num_heads, (32, 64))
    _blk._need(rot % 2 == 0 and rot <= hd,
               lambda: f"rope table of {rot} dims for head dim {hd}")
    _blk._check_hidden(Hd)
    for name, t in (("ln1_w", ln1_w), ("ln1_b", ln1_b), ("ln2_w", ln2_w),
                    ("ln2_b", ln2_b)):
        _blk._check_mat(name, t, (D,), torch.float32)
    dt = x.dtype
    _blk._check_mat("qkv_w", qkv_w, (D, 3 * D), dt)
    _blk._check_mat("out_w", out_w, (D, D), dt)
    _blk._check_mat("w1", w1, (D, Hd), dt)
    _blk._check_mat("w2", w2, (Hd, D), dt)
    for name, t, n in (("qkv_b", qkv_b, 3 * D), ("out_b", out_b, D),
                       ("b1", b1, Hd), ("b2", b2, D)):
        _blk._check_bias(name, t, n)
    _blk._check_freqs(rope_freqs, S, rot)
    M, dev = N * S, x.device
    h = torch.empty((M, D), dtype=dt, device=dev)
    _blk.launch_ln_mod(x, h, M, D, S, LN_AFFINE, ln1_w, ln1_b)
    qkv = torch.empty((M, 3 * D), dtype=dt, device=dev)
    gemm_any(h, qkv_w, qkv, M, 3 * D, D, EPI_BIAS_BF16, bias=qkv_b)
    att = torch.empty((M, D), dtype=dt, device=dev)
    if dt == torch.float32:
        _blk.launch_attn_frame_f32(qkv, rope_freqs, att, N, S, D, num_heads,
                                   rot)
    else:
        _blk.launch_attn_frame(qkv, rope_freqs, att, N, S, D, num_heads, rot)
    xm = torch.empty_like(x)
    gemm_any(att, out_w, xm, M, D, D, EPI_BIAS_BF16_RESID, bias=out_b,
             resid=x)
    _blk.launch_ln_mod(xm, h, M, D, S, LN_AFFINE, ln2_w, ln2_b)
    # fp32 on the k-major form: fc1 stores the GELU rows k-major, as
    # fc2's form reads them
    ld = _blk.f32_fwd_ld(dt, M, Hd, D)
    hh = torch.empty((Hd, ld) if ld else (M, Hd), dtype=dt, device=dev)
    gemm_any(h, w1, hh, M, Hd, D, EPI_BIAS_BF16_GELU, bias=b1,
             **({"ldc": ld} if ld else {}))
    out = torch.empty_like(x)
    gemm_any(hh, w2, out, M, D, Hd, EPI_BIAS_BF16_RESID, bias=b2, resid=xm,
             **({"lda": ld} if ld else {}))
    capture.launched(fused_vae_block)
    return out


fused_vae_block.launches = 0
