"""Axial attention for the spatiotemporal DiT and the ViT VAE: the
unfused attention of the `xla`, `pallas` and `fused_mlp` backends
(counterpart of gtax/nn/attention.py:63-316).

The attention backend is an explicit argument of every function here,
never a process-wide setting: two callers with different backends cannot
touch each other (gtax needs `backend_scope` for that, :47-60). Under
`pallas` the attention core runs on the kernels of
gtax_torch.kernels.attention (`fused_sdpa`, `fused_mha_token_major`), which
return None for a mask with batch dimensions; under every other backend,
and for such masks, it is the plain path below, gtax's XLA path: products
of compute-dtype operands summed in fp32 (torch.matmul / einsum, as gtax
leaves them to XLA), an fp32 softmax as e / sum(e) with -1e30 at masked
logits, the probabilities cast to the compute dtype before PV.

Layouts are gtax's: q/k/v stay token-major with heads trailing, (..., S,
h, d), and rope is applied to the (H, W) or T grid before the tokens are
flattened.
"""

from __future__ import annotations

import torch

from gtax_torch.core import rope
from gtax_torch.kernels import attention as kattn
from gtax_torch.kernels import capture
from gtax_torch.nn.layers import linear

BACKENDS = ("xla", "pallas", "fused", "fused_mlp", "fused_all")
# backends whose DiT attention / MLP branches are the fused kernels
FUSED_ATTENTION = ("fused", "fused_all")
FUSED_MLP = ("fused_mlp", "fused_all")


def check_backend(name: str) -> str:
    if name not in BACKENDS:
        raise ValueError(f"attention backend {name!r}: one of {BACKENDS}")
    return name


def _softmax(logits):
    """jax.nn.softmax: exp(x - max) / sum, in fp32."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _causal(S, mask, device):
    c = torch.tril(torch.ones(S, S, dtype=torch.bool, device=device))
    return c if mask is None else mask.to(device) & c


def sdpa(q, k, v, mask=None, causal=False, backend="xla"):
    """Scaled dot-product attention over the second-to-last axis.
    q/k/v: (..., S, d); mask: broadcastable to (..., S, S), True = attend.
    Scale d^-1/2, softmax in fp32, products summed in fp32."""
    if backend == "pallas":
        out = kattn.fused_sdpa(q, k, v, mask=mask, causal=causal)
        if out is not None:
            return out
    d, S = q.shape[-1], q.shape[-2]
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * (
        1.0 / d**0.5)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool)
    if causal:
        mask = _causal(S, mask, q.device)
    if mask is not None:
        logits = torch.where(mask.to(q.device), logits, -1e30)
    probs = _softmax(logits).to(q.dtype)
    out = torch.einsum("...qk,...kd->...qd", probs.float(), v.float())
    return out.to(q.dtype)


def _sdpa_heads_last(q, k, v, mask=None, causal=False):
    """Attention with layout (..., S, h, d), heads trailing."""
    d, S = q.shape[-1], q.shape[-3]
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * (
        1.0 / d**0.5)
    if causal:
        mask = _causal(S, mask, q.device)
    if mask is not None:
        logits = torch.where(mask.to(q.device), logits, -1e30)
    probs = _softmax(logits).to(q.dtype)
    out = torch.einsum("...hqk,...khd->...qhd", probs.float(), v.float())
    return out.to(q.dtype)


def _qkv_heads(params, x, num_heads, compute_dtype):
    """(q, k, v, heads): qkv's three column blocks, each (..., heads *
    d) with d = D // num_heads. Under tensor parallelism the kernel holds
    this rank's heads of each (mesh.shard_params), so heads =
    num_heads / model there."""
    d = x.shape[-1] // num_heads
    qkv = linear(params["qkv"], x, compute_dtype)
    width = qkv.shape[-1] // 3
    return (*qkv.split(width, dim=-1), width // d)


def spatial_axial_attention(params, x, rope_freqs, num_heads: int,
                            compute_dtype=torch.bfloat16, backend="xla",
                            reduce=None):
    """Full attention over each frame's H x W token grid. x: (B, T, H, W,
    D); rope_freqs: (H, W, rot) pixel-axial table applied to q and k; qkv
    without bias, the output projection with it. reduce: the output
    projection's sum over the model ranks (nn.layers.linear), for params
    cut by mesh.shard_params."""
    B, T, H, W, D = x.shape
    d = D // num_heads
    q, k, v, heads = _qkv_heads(params, x, num_heads, compute_dtype)
    q, k, v = (t.reshape(B, T, H, W, heads, d) for t in (q, k, v))
    rf = rope_freqs[:, :, None, :]
    q, k = rope.apply_rotary_emb(rf, q), rope.apply_rotary_emb(rf, k)
    hw, width = H * W, heads * d
    out = None
    if backend == "pallas":
        out = kattn.fused_mha_token_major(
            q.reshape(B, T, hw, width), k.reshape(B, T, hw, width),
            v.reshape(B, T, hw, width), heads)
    if out is None:
        out = _sdpa_heads_last(*(t.reshape(B, T, hw, heads, d)
                                 for t in (q, k, v)))
    return linear(params["out"], out.reshape(B, T, H, W, width),
                  compute_dtype, reduce)


def temporal_axial_attention(params, x, rope_freqs, num_heads: int,
                             valid=None, compute_dtype=torch.bfloat16,
                             backend="xla", reduce=None):
    """Causal attention over T at each spatial site. x: (B, T, H, W, D);
    rope_freqs: (T, rot) over the window slots; valid: optional (T,) or
    (B, T) bools, False for padding slots, whose keys are masked (the
    diagonal stays open, so a padded query never softmaxes over nothing).
    Under `pallas` a (T,) mask takes the token-major kernel over (B, S, T,
    D), transposed there and back by torch; a (B, T) mask the plain path.
    reduce: as spatial_axial_attention's."""
    B, T, H, W, D = x.shape
    d = D // num_heads
    S = H * W
    q, k, v, heads = _qkv_heads(params, x, num_heads, compute_dtype)
    q, k, v = (t.reshape(B, T, S, heads, d) for t in (q, k, v))
    width = heads * d
    rf = rope_freqs[:, None, None, :]
    q, k = rope.apply_rotary_emb(rf, q), rope.apply_rotary_emb(rf, k)

    mask = torch.tril(torch.ones(T, T, dtype=torch.bool))
    if valid is not None:
        ok = torch.as_tensor(valid, dtype=torch.bool).cpu()
        mask = mask & (ok[..., None, :] | torch.eye(T, dtype=torch.bool))

    if backend == "pallas" and mask.dim() == 2:
        qt, kt, vt = (t.reshape(B, T, S, width).transpose(1, 2)
                      for t in (q, k, v))
        out = kattn.fused_mha_token_major(qt, kt, vt, heads, mask=mask)
        if out is not None:
            out = out.transpose(1, 2).reshape(B, T, H, W, width)
            return linear(params["out"], out, compute_dtype, reduce)

    if mask.dim() == 3:
        mask = mask[:, None, None].to(x.device)  # (B, 1, 1, T, T)
    else:  # on the device once per mask: the step copies nothing
        mask = capture.held(("temporal_mask", tuple(mask.flatten().tolist())),
                            x.device, mask.to)
    logits = torch.einsum("bqshd,bkshd->bshqk", q.float(), k.float()) * (
        1.0 / d**0.5)
    logits = torch.where(mask, logits, -1e30)
    probs = _softmax(logits).to(q.dtype)
    out = torch.einsum("bshqk,bkshd->bqshd", probs.float(), v.float())
    out = out.to(q.dtype).reshape(B, T, H, W, width)
    return linear(params["out"], out, compute_dtype, reduce)


def vae_frame_attention(params, x, rope_freqs, num_heads: int, grid_hw,
                        compute_dtype=torch.bfloat16, backend="xla"):
    """Per-frame ViT self-attention with partial pixel-axial rope. x: (N,
    S, D), S = H * W; rope_freqs: (H, W, rot), rot = head_dim // 2: only
    the first rot dims of each head rotate. qkv and the output projection
    both carry biases."""
    N, S, D = x.shape
    H, W = grid_hw
    d = D // num_heads
    qkv = linear(params["qkv"], x, compute_dtype)
    q, k, v = qkv.split(D, dim=-1)
    q, k = (t.reshape(N, H, W, num_heads, d) for t in (q, k))
    rf = rope_freqs[:, :, None, :]
    q, k = rope.apply_rotary_emb(rf, q), rope.apply_rotary_emb(rf, k)
    out = None
    if backend == "pallas":
        out = kattn.fused_mha_token_major(
            q.reshape(N, S, D), k.reshape(N, S, D), v, num_heads)
    if out is None:
        out = _sdpa_heads_last(q.reshape(N, S, num_heads, d),
                               k.reshape(N, S, num_heads, d),
                               v.reshape(N, S, num_heads, d))
        out = out.reshape(N, S, D)
    return linear(params["out"], out, compute_dtype)
