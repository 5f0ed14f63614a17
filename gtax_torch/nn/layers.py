"""Primitive layers as functions over parameter dicts (counterpart of
gtax/nn/layers.py, bf16, fp32 and int8 paths).

Conventions, as in gtax: parameters are float32 masters (or pre-cast for
serving); activations flow in a compute dtype; GEMMs take compute-dtype
operands and accumulate in fp32; normalisation, softmax, rope and sinusoid
math run in fp32; Linear kernels are stored (in, out).

These products run outside the fused kernels (patch embed, embedders,
adaLN heads, final layer, the VAE's patch/quant/predictor layers), where
gtax left them to XLA; here they go to torch.matmul on fp32 views of the
compute-dtype operands, which keeps the fp32 accumulation exact on the
card (platform.strict_matmul). The int8 adaLN heads of the W8A8 serving
mode take the same route: gtax leaves them to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gtax_torch.kernels import quant


def linear(params, x, compute_dtype=torch.bfloat16, reduce=None):
    """y = x @ kernel + bias, cast to the compute dtype.

    W8A8 params (gtax_torch.models.dit.quantize_for_inference) carry an int8
    "kernel_q" with per-column fp32 "scale": x is quantized per row from
    fp32, the int8 product is exact (quant.mm_int) and dequantized as
    (acc * s_row) * s_col, as gtax/nn/layers.py linear does.

    reduce: for a kernel cut on its input rows over the model ranks
    (tensor parallelism), the sum of the ranks' fp32 partial products
    (mesh.Axis.reduce_sum), taken before the bias, which every rank holds
    whole and adds once."""
    if "kernel_q" in params:
        y = quant.qdot(x.float(), params["kernel_q"], params["scale"])
    else:
        kernel = params["kernel"].to(compute_dtype)
        y = torch.matmul(x.to(compute_dtype).float(), kernel.float())
    if reduce is not None:
        y = reduce(y)
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(compute_dtype)


def layer_norm(x, eps=1e-6, weight=None, bias=None, compute_dtype=None):
    """LayerNorm over the last dim in float32 (no affine when weight/bias
    are None); output in compute_dtype (default x.dtype)."""
    out_dtype = compute_dtype if compute_dtype is not None else x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def gelu_tanh(x):
    """GELU, tanh approximation (DiT MLPs)."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """Exact (erf) GELU (VAE MLPs)."""
    return F.gelu(x)


def mlp(params, x, act=gelu_tanh, compute_dtype=torch.bfloat16,
        reduce=None):
    """fc1 -> act -> fc2; reduce: fc2's sum over the model ranks
    (linear)."""
    h = act(linear(params["fc1"], x, compute_dtype))
    return linear(params["fc2"], h, compute_dtype, reduce)


def patchify_embed(params, x, patch_size: int, compute_dtype=torch.bfloat16):
    """Patch embedding as a reshaped GEMM: x (B, C, H, W) ->
    (B, H/p, W/p, D), patch features flattened in (C, ph, pw) order."""
    B, C, H, W = x.shape
    p = patch_size
    gh, gw = H // p, W // p
    x = x.reshape(B, C, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    return linear(params, x.reshape(B, gh, gw, C * p * p), compute_dtype)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep features, COS first, float32: (...,) ->
    (..., dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def timestep_embedder(params, t, freq_dim: int = 256,
                      compute_dtype=torch.bfloat16):
    """Sinusoid -> Linear -> SiLU -> Linear."""
    h = linear(params["fc1"], timestep_embedding(t, freq_dim), compute_dtype)
    h = F.silu(h.float()).to(compute_dtype)
    return linear(params["fc2"], h, compute_dtype)


def _per_frame(v, x):
    """Reshape (..., D) per-frame vectors to broadcast over x's token
    axes."""
    extra = x.dim() - v.dim()
    return v.reshape(v.shape[:-1] + (1,) * extra + v.shape[-1:])


def modulate(x, shift, scale):
    """adaLN FiLM: x * (1 + scale + 1e-6) + shift (the +1e-6 is the
    reference's, kept for parity), shift/scale broadcast over tokens."""
    return x * (1.0 + _per_frame(scale, x) + 1e-6) + _per_frame(shift, x)


def gate(x, g):
    """Gated residual branch: x * g, g broadcast over token axes."""
    return x * _per_frame(g, x)


def adaln(params, c, n_chunks: int, compute_dtype=torch.bfloat16):
    """SiLU -> Linear -> split into n_chunks along the feature dim."""
    h = F.silu(c.float()).to(compute_dtype)
    return linear(params, h, compute_dtype).chunk(n_chunks, dim=-1)
