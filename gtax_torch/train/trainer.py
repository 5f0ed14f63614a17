"""Frozen-VAE frame encoding and decoding (the serving slice of
gtax/train/trainer.py; the trainer itself is a later slice and extends
this module)."""

from __future__ import annotations

import torch

from gtax_torch.core.constants import LATENT_SCALE
from gtax_torch.models.vae import vae_decode, vae_encode


def as_float_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 channel-last (..., H, W, 3) pixels -> float (..., 3, H, W) in
    [0, 1] on the tensor's device; float inputs pass through unchanged."""
    if video.dtype != torch.uint8:
        return video
    n = video.dim()
    return video.permute(*range(n - 3), n - 1, n - 3, n - 2).float() / 255.0


def encode_frames(vae_params, vae_cfg, frames, compute_dtype):
    """frames (B, T, 3, H, W) in [0, 1] (or uint8 (B, T, H, W, 3)) ->
    latents (B, T, C, h, w) float32."""
    frames = as_float_video(frames)
    B, T = frames.shape[:2]
    flat = frames.reshape(B * T, *frames.shape[2:])
    mean, _ = vae_encode(vae_params, vae_cfg, flat * 2.0 - 1.0, compute_dtype)
    lat = (mean * LATENT_SCALE).reshape(B, T, vae_cfg.seq_h, vae_cfg.seq_w,
                                        vae_cfg.latent_dim)
    return lat.permute(0, 1, 4, 2, 3).float()


def decode_frames(vae_params, vae_cfg, latents, compute_dtype):
    """latents (B, T, C, h, w) -> uint8 video (B, T, H, W, 3)."""
    B, T, C, h, w = latents.shape
    flat = latents.permute(0, 1, 3, 4, 2).reshape(B * T, h * w, C)
    pix = vae_decode(vae_params, vae_cfg, flat / LATENT_SCALE, compute_dtype)
    pix = ((pix + 1.0) / 2.0).reshape(B, T, 3, vae_cfg.input_height,
                                       vae_cfg.input_width)
    pix = torch.clamp(pix * 255.0, 0, 255).to(torch.uint8)
    return pix.permute(0, 1, 3, 4, 2)
