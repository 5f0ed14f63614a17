"""Sinusoidal position embeddings and the learned-position fallback
(counterpart of gtax/nn/embeddings.py, the same seven functions).

The reference's attention layers use them when built WITHOUT rotary
embeddings (the diffusers `Timesteps`, `Positions2d` and
`TimestepEmbedding` modules); every shipped config passes rotary, so no
model path calls them, as in gtax. The sinusoid math runs in fp32 at
gtax's points; the MLP is Linear -> SiLU -> Linear with (in, out) kernels
(gtax_torch.nn.layers.linear). gtax's weight exporter writes no params of
this MLP, so the weight bridge (gtax_torch.io.safetensors_port) has no
entry for them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gtax_torch.nn.layers import linear


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False,
                           downscale_freq_shift: float = 1.0,
                           scale: float = 1.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """DDPM sinusoid, sin first, then optionally flipped to cos first.
    timesteps: (...,) -> (..., embedding_dim) float32; an odd dim gets a
    zero column last."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    emb = timesteps.float()[..., None] * freqs * scale
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def timesteps_embedding(positions: torch.Tensor,
                        num_channels: int) -> torch.Tensor:
    """The `Timesteps` module: cos first (flip_sin_to_cos), shift 0."""
    return get_timestep_embedding(positions, num_channels,
                                  flip_sin_to_cos=True,
                                  downscale_freq_shift=0.0)


def positions_2d_embedding(grid_h: torch.Tensor, grid_w: torch.Tensor,
                           num_channels: int) -> torch.Tensor:
    """The `Positions2d` module: half the channels an H sinusoid, half a W
    one, concatenated. grid_h (H,), grid_w (W,) -> (H, W, num_channels)."""
    hh, ww = torch.meshgrid(grid_h, grid_w, indexing="ij")
    return torch.cat([timesteps_embedding(hh, num_channels // 2),
                      timesteps_embedding(ww, num_channels // 2)], dim=-1)


def timestep_embedding_mlp_init(generator: torch.Generator, in_channels: int,
                                time_embed_dim: int,
                                out_dim: int | None = None, device="cpu"):
    """Params of the diffusers `TimestepEmbedding` MLP, Linear(in, hidden)
    -> SiLU -> Linear(hidden, out): kernels uniform in +-1/sqrt(fan_in),
    zero biases, as gtax draws them (from `generator`: not JAX's
    numbers)."""
    out_dim = out_dim or time_embed_dim

    def lin(din, dout):
        bound = 1.0 / din**0.5
        w = torch.rand((din, dout), generator=generator, device=device)
        return {"kernel": w * (2 * bound) - bound,
                "bias": torch.zeros((dout,), device=device)}

    return {"fc1": lin(in_channels, time_embed_dim),
            "fc2": lin(time_embed_dim, out_dim)}


def timestep_embedding_mlp(params, x: torch.Tensor,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """fc1 -> SiLU (in fp32) -> fc2."""
    h = linear(params["fc1"], x, compute_dtype)
    h = F.silu(h.float()).to(compute_dtype)
    return linear(params["fc2"], h, compute_dtype)


def temporal_pos_emb_fallback(params, T: int, dim: int,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """The learned temporal position embedding of a temporal attention
    without rotary: the MLP over timesteps_embedding(arange(T)). (T,
    dim)."""
    device = params["fc1"]["kernel"].device
    sin = timesteps_embedding(torch.arange(T, device=device), dim)
    return timestep_embedding_mlp(params, sin, compute_dtype)


def spatial_pos_emb_fallback(params, H: int, W: int, dim: int,
                             compute_dtype=torch.float32) -> torch.Tensor:
    """The learned 2-D position embedding of a spatial attention without
    rotary: the MLP over positions_2d_embedding. (H, W, dim)."""
    device = params["fc1"]["kernel"].device
    sin = positions_2d_embedding(torch.arange(H, device=device),
                                 torch.arange(W, device=device), dim)
    return timestep_embedding_mlp(params, sin, compute_dtype)
