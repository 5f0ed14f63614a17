"""ViT autoencoder mapping 360x640 RGB frames to 16-channel 18x32 latent
tokens (counterpart of gtax/models/vae.py).

Encoder and decoder blocks are per-block lists. With fused=True every
block is one call of gtax_torch.kernels.vae_block.fused_vae_block (CUDA
kernels on the card, the plain version on the CPU), which serving takes
under the fused backends; by default (fused=False, as gtax's) a block is
unfused, h + attention(LN1(h)) then h + mlp(LN2(h)), with the attention of
gtax_torch.nn.attention under the caller's backend (the `pallas` kernels,
else the plain path) and the layers of gtax_torch.nn.layers. The partial
pixel-axial rope table is computed from its closed form.

Parameter dict (float32 masters, Linear kernels (in, out)):
  patch_embed {kernel,bias}
  encoder / decoder: list of {norm1{weight,bias}, attn{qkv{kernel,bias},
      out{kernel,bias}}, norm2{weight,bias}, mlp{fc1{kernel,bias},
      fc2{kernel,bias}}}
  enc_norm / dec_norm {weight,bias}
  quant {kernel,bias} (enc_dim -> 2*latent_dim; mean | logvar)
  post_quant {kernel,bias}   predictor {kernel,bias}
"""

from __future__ import annotations

import dataclasses

import torch

from gtax_torch.core import rope
from gtax_torch.kernels.vae_block import fused_vae_block
from gtax_torch.nn import attention as attn
from gtax_torch.nn.layers import (
    gelu_exact,
    layer_norm,
    linear,
    mlp,
    patchify_embed,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_dim: int = 16
    input_height: int = 360
    input_width: int = 640
    patch_size: int = 20
    enc_dim: int = 1024
    enc_depth: int = 6
    enc_heads: int = 16
    dec_dim: int = 1024
    dec_depth: int = 12
    dec_heads: int = 16
    mlp_ratio: float = 4.0

    @property
    def seq_h(self) -> int:
        return self.input_height // self.patch_size

    @property
    def seq_w(self) -> int:
        return self.input_width // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.seq_h * self.seq_w

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size**2


def vae_init(cfg: VAEConfig, generator: torch.Generator, device="cpu"):
    """Xavier-uniform linears, zero biases, unit LayerNorms (reference
    init). Random numbers come from `generator`."""

    def lin(din, dout):
        limit = (6.0 / (din + dout)) ** 0.5
        w = torch.rand((din, dout), generator=generator, device=device)
        return {"kernel": w * (2 * limit) - limit,
                "bias": torch.zeros((dout,), device=device)}

    def ln(dim):
        return {"weight": torch.ones((dim,), device=device),
                "bias": torch.zeros((dim,), device=device)}

    def blocks(depth, dim):
        hid = int(dim * cfg.mlp_ratio)
        return [{"norm1": ln(dim),
                 "attn": {"qkv": lin(dim, 3 * dim), "out": lin(dim, dim)},
                 "norm2": ln(dim),
                 "mlp": {"fc1": lin(dim, hid), "fc2": lin(hid, dim)}}
                for _ in range(depth)]

    return {
        "patch_embed": lin(cfg.patch_dim, cfg.enc_dim),
        "encoder": blocks(cfg.enc_depth, cfg.enc_dim),
        "enc_norm": ln(cfg.enc_dim),
        "quant": lin(cfg.enc_dim, 2 * cfg.latent_dim),
        "post_quant": lin(cfg.latent_dim, cfg.dec_dim),
        "decoder": blocks(cfg.dec_depth, cfg.dec_dim),
        "dec_norm": ln(cfg.dec_dim),
        "predictor": lin(cfg.dec_dim, cfg.patch_dim),
    }


def cast_params_for_inference(params, dtype=torch.bfloat16):
    """Pre-cast the GEMM kernels to the compute dtype once; LayerNorm
    parameters and biases stay as they are (fp32), as the fused block
    takes them. Numerically the same as gtax's cast at each call."""

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(dtype) if key == "kernel" else node

    return walk(params)


def _rope_table(cfg: VAEConfig, dim: int, num_heads: int, device):
    """Pixel-axial rope over the token grid rotating the first
    head_dim // 2 dims of each head: (seq_len, head_dim // 2) fp32."""
    head_dim = dim // num_heads
    freqs = rope.pixel_freqs(head_dim // 4,
                             max_freq=float(cfg.seq_h * cfg.seq_w))
    table = rope.axial_freqs(freqs, (cfg.seq_h, cfg.seq_w), pixel=True)
    return table.reshape(cfg.seq_len, -1).contiguous().to(device)


def _run_blocks(blocks, h, rope_freqs, num_heads, cfg: VAEConfig,
                compute_dtype, fused=False, backend="xla"):
    """The ViT blocks over (N, seq_len, dim) tokens; rope_freqs (seq_len,
    rot). fused: one fused_vae_block call per block; else gtax's unfused
    body (gtax/models/vae.py _run_blocks), attention under `backend`."""
    if fused:
        for bp in blocks:
            h = fused_vae_block(
                h, bp["norm1"]["weight"], bp["norm1"]["bias"],
                bp["attn"]["qkv"]["kernel"].to(compute_dtype),
                bp["attn"]["qkv"]["bias"],
                bp["attn"]["out"]["kernel"].to(compute_dtype),
                bp["attn"]["out"]["bias"],
                bp["norm2"]["weight"], bp["norm2"]["bias"],
                bp["mlp"]["fc1"]["kernel"].to(compute_dtype),
                bp["mlp"]["fc1"]["bias"],
                bp["mlp"]["fc2"]["kernel"].to(compute_dtype),
                bp["mlp"]["fc2"]["bias"], rope_freqs, num_heads)
        return h
    grid_hw = (cfg.seq_h, cfg.seq_w)
    table = rope_freqs.reshape(*grid_hw, -1)
    for bp in blocks:
        n1, n2 = bp["norm1"], bp["norm2"]
        h = h + attn.vae_frame_attention(
            bp["attn"], layer_norm(h, weight=n1["weight"], bias=n1["bias"]),
            table, num_heads, grid_hw, compute_dtype, backend=backend)
        h = h + mlp(bp["mlp"],
                    layer_norm(h, weight=n2["weight"], bias=n2["bias"]),
                    gelu_exact, compute_dtype)
    return h


def vae_encode(params, cfg: VAEConfig, x, compute_dtype=torch.bfloat16,
               fused=False, backend="xla"):
    """pixels (N, 3, H, W) in [-1, 1] -> (mean, logvar), each
    (N, seq_len, latent_dim) float32; logvar clamped to [-30, 20]. fused:
    the fused block kernels (serving's fused backends); backend: the
    attention backend of the unfused blocks."""
    h = patchify_embed(params["patch_embed"], x, cfg.patch_size,
                       compute_dtype)
    h = h.reshape(h.shape[0], cfg.seq_len, cfg.enc_dim).contiguous()
    table = _rope_table(cfg, cfg.enc_dim, cfg.enc_heads, x.device)
    h = _run_blocks(params["encoder"], h, table, cfg.enc_heads, cfg,
                    compute_dtype, fused, backend)
    h = layer_norm(h, weight=params["enc_norm"]["weight"],
                   bias=params["enc_norm"]["bias"])
    moments = linear(params["quant"], h, compute_dtype).float()
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """Encoder posterior: logvar pre-clamped by vae_encode; mode() is the
    mean; a deterministic posterior has zero std."""

    mean: torch.Tensor
    logvar: torch.Tensor
    deterministic: bool = False

    @property
    def std(self):
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self):
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator):
        return self.mean + self.std * torch.randn(
            self.mean.shape, generator=generator, device=self.mean.device,
            dtype=self.mean.dtype)

    def mode(self):
        return self.mean


def vae_posterior(params, cfg: VAEConfig, x, compute_dtype=torch.bfloat16,
                  deterministic: bool = False) -> DiagonalGaussian:
    mean, logvar = vae_encode(params, cfg, x, compute_dtype)
    return DiagonalGaussian(mean=mean, logvar=logvar,
                            deterministic=deterministic)


def vae_decode(params, cfg: VAEConfig, z, compute_dtype=torch.bfloat16,
               fused=False, backend="xla"):
    """latents (N, seq_len, latent_dim) -> pixels (N, 3, H, W), float32;
    fused and backend as vae_encode's."""
    h = linear(params["post_quant"], z, compute_dtype).contiguous()
    table = _rope_table(cfg, cfg.dec_dim, cfg.dec_heads, z.device)
    h = _run_blocks(params["decoder"], h, table, cfg.dec_heads, cfg,
                    compute_dtype, fused, backend)
    h = layer_norm(h, weight=params["dec_norm"]["weight"],
                   bias=params["dec_norm"]["bias"])
    h = linear(params["predictor"], h, compute_dtype).float()
    N, p = h.shape[0], cfg.patch_size
    h = h.reshape(N, cfg.seq_h, cfg.seq_w, 3, p, p).permute(0, 3, 1, 4, 2, 5)
    return h.reshape(N, 3, cfg.input_height, cfg.input_width)


def ViT_L_20_Shallow_Encoder(latent_dim: int = 16) -> VAEConfig:
    """Flagship VAE config."""
    return VAEConfig(latent_dim=latent_dim, patch_size=20, enc_dim=1024,
                     enc_depth=6, enc_heads=16, dec_dim=1024, dec_depth=12,
                     dec_heads=16, input_height=360, input_width=640)


def VAE_debug() -> VAEConfig:
    """Tiny preset (pairs with 'DiT-debug': 48x64 frames, 8-channel 6x8
    latents); head_dim 32 keeps the partial rope exercised."""
    return VAEConfig(latent_dim=8, input_height=48, input_width=64,
                     patch_size=8, enc_dim=64, enc_depth=1, enc_heads=2,
                     dec_dim=64, dec_depth=1, dec_heads=2)


VAE_MODELS = {
    "vit-l-20-shallow-encoder": ViT_L_20_Shallow_Encoder,
    "vae-debug": VAE_debug,
}
