"""DiT branch functions for training: the plain full-branch forwards and
the trainable fused branches (counterpart of gtax/nn/branches.py).

The fused branch wrappers of gtax_torch.kernels.block are forward-only:
their CUDA kernels have no autograd. Each trainable branch is a
torch.autograd.Function in place of gtax's jax.custom_vjp:

- with no gradient needed (serving, evaluation) the branch is the plain
  fused wrapper call: no residuals, nothing extra launched;
- when a gradient is needed, the forward runs the wrapper with
  emit_train=True, which also returns the branch's internal residuals
  (post-rope q/k and cast v plus the pre-gate y for attention; the
  pre-GELU h1 and y for the MLP);
- the backward is the whole-branch backward of gtax_torch.kernels.backward
  over those residuals: the CUDA kernels for CUDA tensors, their plain
  versions for CPU tensors (gtax's GTAX_XLA_BWD switch has no counterpart:
  the device picks the path).

Gradients come back in the dtypes of the inputs they belong to (gtax casts
the fp32 kernel gradients the same way); the rope frequency tables get
none: they are frozen, and the DiT detaches them before the call.

int8-forward training (gtax's trainable_*_branch(quant=True),
gtax/nn/branches.py:215-240, :310-330, :448-460): given `qw`, the int8
weights and scales of the branch's compute-dtype weights (`int8_weights`),
the forward is the W8A8 wrapper of gtax_torch.kernels.quant, with
emit_train when a gradient is needed, and the backward is the unchanged
bf16 whole-branch backward over the int8 forward's residuals, with the
compute-dtype weights: a straight-through estimator over the
quantization. The temporal backward then forms the modulated rows again
(mod=None), as gtax's does: the int8 forward has no bf16 mod rows.

The `xla_*` functions are the plain full-branch forwards (the kernels'
plain versions of gtax_torch.kernels.block, whose rounding points they
share); under autograd they are the reference path that the trainable
branches' gradients are held against.
"""

from __future__ import annotations

import torch

from gtax_torch.kernels import backward, block, quant


def xla_spatial_branch(x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs,
                       num_heads, dtype):
    """x: (N, S, D) per-frame token tiles; shift/scale/g: (N, D);
    rope_freqs: (S, head_dim). Returns x + g * SpatialAttn(modulate(LN(x)))
    in `dtype`."""
    return block.spatial_branch_plain(
        *(t.to(dtype) for t in (x, shift, scale, g, qkv_w, out_w)), out_b,
        rope_freqs, num_heads)


def xla_temporal_branch(x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs,
                        valid, num_heads, n_frames, dtype):
    """x: (N = B*T, S, D) frame-major tiles; rope_freqs: (T, head_dim);
    valid: (T,) bools or None. Causal attention over T at each site."""
    return block.temporal_branch_plain(
        *(t.to(dtype) for t in (x, shift, scale, g, qkv_w, out_w)), out_b,
        rope_freqs, valid, num_heads, n_frames)


def xla_mlp_branch(x, shift, scale, g, w1, b1, w2, b2, dtype):
    """x + g * MLP(modulate(LN(x))) with tanh-GELU."""
    return block.mlp_branch_plain(
        *(t.to(dtype) for t in (x, shift, scale, g, w1)), b1, w2.to(dtype),
        b2)


def int8_weights(*weights):
    """The int8 forward's weights: for each compute-dtype kernel its
    symmetric per-column int8 values and fp32 scales (quant.quantize_weight;
    column-major on the card), flattened in order, without gradient (gtax
    quantizes the bf16 weights inside the wrapper, branches.py:222-226)."""
    with torch.no_grad():
        return tuple(t for w in weights for t in quant.quantize_weight(w))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _as(grads, like):
    return tuple(gr.to(t.dtype) for gr, t in zip(grads, like))


def _spatial_forward(x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs,
                     num_heads, qw, emit_train=False):
    if qw is None:
        return block.fused_spatial_branch(
            x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs, num_heads,
            emit_train=emit_train)
    return quant.fused_spatial_branch_q(x, shift, scale, g, *qw, out_b,
                                        rope_freqs, num_heads,
                                        emit_train=emit_train)


def _temporal_forward(x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs,
                      valid, num_heads, n_frames, qw, emit_train=False):
    """The temporal wrapper; with emit_train also the residuals and the
    modulated rows (None for the int8 forward)."""
    if qw is not None:
        out = quant.fused_temporal_branch_q(
            x, shift, scale, g, *qw, out_b, rope_freqs, valid, num_heads,
            n_frames, emit_train=emit_train)
        return (*out, None) if emit_train else out
    return block.fused_temporal_branch(
        x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs, valid,
        num_heads, n_frames, emit_train=emit_train, emit_mod=emit_train)


def _mlp_forward(x, shift, scale, g, w1, b1, w2, b2, qw, emit_train=False):
    if qw is None:
        return block.fused_mlp_branch(x, shift, scale, g, w1, b1, w2, b2,
                                      emit_train=emit_train)
    w1_q, w1_s, w2_q, w2_s = qw
    return quant.fused_mlp_branch_q(x, shift, scale, g, w1_q, w1_s, b1, w2_q,
                                    w2_s, b2, emit_train=emit_train)


class SpatialBranch(torch.autograd.Function):
    """fused_spatial_branch (or, given qw, fused_spatial_branch_q) with its
    backward (gtax trainable_spatial_branch)."""

    @staticmethod
    def forward(ctx, x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs,
                num_heads, rope_cs, qw):
        out, *res = _spatial_forward(x, shift, scale, g, qkv_w, out_w, out_b,
                                     rope_freqs, num_heads, qw, True)
        ctx.save_for_backward(x, shift, scale, g, qkv_w, out_w, out_b,
                              rope_freqs, *res)
        ctx.num_heads, ctx.rope_cs = num_heads, rope_cs
        return out

    @staticmethod
    def backward(ctx, ct):
        x, shift, scale, g, qkv_w, out_w, out_b, freqs, *res = (
            ctx.saved_tensors)
        dx, *grads = backward.fused_spatial_branch_bwd(
            x, shift, scale, g, qkv_w, out_w, freqs, *res,
            ct.to(x.dtype).contiguous(), ctx.num_heads, ctx.rope_cs)
        return (dx, *_as(grads, (shift, scale, g, qkv_w, out_w, out_b)),
                None, None, None, None)


class TemporalBranch(torch.autograd.Function):
    """fused_temporal_branch (or, given qw, fused_temporal_branch_q) with
    its backward (gtax trainable_temporal_branch); `valid` is a (T,) bool
    sequence or None. The bf16 forward also keeps the modulated rows its
    qkv product read (emit_mod), so the backward's weight gradient does not
    form them again."""

    @staticmethod
    def forward(ctx, x, shift, scale, g, qkv_w, out_w, out_b, rope_freqs,
                valid, num_heads, n_frames, qw):
        out, *res = _temporal_forward(x, shift, scale, g, qkv_w, out_w,
                                      out_b, rope_freqs, valid, num_heads,
                                      n_frames, qw, True)
        ctx.save_for_backward(x, shift, scale, g, qkv_w, out_w, out_b,
                              rope_freqs, *res)
        ctx.valid, ctx.num_heads, ctx.n_frames = valid, num_heads, n_frames
        return out

    @staticmethod
    def backward(ctx, ct):
        x, shift, scale, g, qkv_w, out_w, out_b, freqs, *res, mod = (
            ctx.saved_tensors)
        dx, *grads = backward.fused_temporal_branch_bwd(
            x, shift, scale, g, qkv_w, out_w, freqs, ctx.valid, *res,
            ct.to(x.dtype).contiguous(), ctx.num_heads, ctx.n_frames,
            mod=mod)
        return (dx, *_as(grads, (shift, scale, g, qkv_w, out_w, out_b)),
                None, None, None, None, None)


class MLPBranch(torch.autograd.Function):
    """fused_mlp_branch (or, given qw, fused_mlp_branch_q) with its
    backward (gtax trainable_mlp_branch)."""

    @staticmethod
    def forward(ctx, x, shift, scale, g, w1, b1, w2, b2, qw):
        out, h1, y = _mlp_forward(x, shift, scale, g, w1, b1, w2, b2, qw,
                                  True)
        ctx.save_for_backward(x, shift, scale, g, w1, b1, w2, b2, h1, y)
        return out

    @staticmethod
    def backward(ctx, ct):
        x, shift, scale, g, w1, b1, w2, b2, h1, y = ctx.saved_tensors
        dx, *grads = backward.fused_mlp_branch_bwd(
            x, shift, scale, g, w1, w2, h1, y, ct.to(x.dtype).contiguous())
        return (dx, *_as(grads, (shift, scale, g, w1, b1, w2, b2)), None)


def trainable_spatial_branch(x, shift, scale, g, qkv_w, out_w, out_b,
                             rope_freqs, num_heads, rope_cs=None, qw=None):
    """The spatial-attention branch, differentiable when a gradient is
    needed; the plain wrapper call otherwise. rope_cs: the backward's cos
    and sin of rope_freqs (backward.rope_tables), where the caller formed
    them once for its blocks; qw: int8_weights(qkv_w, out_w) for the int8
    forward, or None."""
    if _needs_grad(x, shift, scale, g, qkv_w, out_w, out_b):
        return SpatialBranch.apply(x, shift, scale, g, qkv_w, out_w, out_b,
                                   rope_freqs, num_heads, rope_cs, qw)
    return _spatial_forward(x, shift, scale, g, qkv_w, out_w, out_b,
                            rope_freqs, num_heads, qw)


def trainable_temporal_branch(x, shift, scale, g, qkv_w, out_w, out_b,
                              rope_freqs, valid, num_heads, n_frames,
                              qw=None):
    """The causal temporal-attention branch, as trainable_spatial_branch."""
    if _needs_grad(x, shift, scale, g, qkv_w, out_w, out_b):
        return TemporalBranch.apply(x, shift, scale, g, qkv_w, out_w, out_b,
                                    rope_freqs, valid, num_heads, n_frames,
                                    qw)
    return _temporal_forward(x, shift, scale, g, qkv_w, out_w, out_b,
                             rope_freqs, valid, num_heads, n_frames, qw)


def trainable_mlp_branch(x, shift, scale, g, w1, b1, w2, b2, qw=None):
    """The MLP branch, as trainable_spatial_branch; qw: int8_weights(w1,
    w2) for the int8 forward, or None."""
    if _needs_grad(x, shift, scale, g, w1, b1, w2, b2):
        return MLPBranch.apply(x, shift, scale, g, w1, b1, w2, b2, qw)
    return _mlp_forward(x, shift, scale, g, w1, b1, w2, b2, qw)
