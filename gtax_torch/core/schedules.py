"""Diffusion beta schedules (counterpart of gtax/core/schedules.py).

Schedule math runs in float64 numpy on the host, exactly as gtax does, and
is returned as float32 tensors on the CPU; callers move what they need.
"""

from __future__ import annotations

import numpy as np
import torch


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _sigmoid_abar(timesteps, start, end, tau):
    t = np.linspace(0.0, float(timesteps), timesteps + 1,
                    dtype=np.float64) / timesteps
    v_start = _sigmoid(start / tau)
    v_end = _sigmoid(end / tau)
    abar = (-_sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start)
    return abar / abar[0]


def _betas(abar):
    return _f32(np.clip(1.0 - (abar[1:] / abar[:-1]), 0.0, 0.999))


def sigmoid_beta_schedule(timesteps: int, start: float = -3.0,
                          end: float = 3.0, tau: float = 1.0,
                          clamp_min: float = 1e-4) -> torch.Tensor:
    """Sigmoid alpha-bar schedule rescaled into [clamp_min, 1]; betas
    clipped to [0, 0.999]. float32 (timesteps,)."""
    abar = _sigmoid_abar(timesteps, start, end, tau)
    return _betas(abar * (1.0 - clamp_min) + clamp_min)


def sigmoid_beta_schedule_clamped(timesteps: int, start: float = -3.0,
                                  end: float = 3.0, tau: float = 1.0,
                                  clamp_min: float = 1e-4) -> torch.Tensor:
    """Variant that clamps alphas_cumprod instead of rescaling."""
    abar = _sigmoid_abar(timesteps, start, end, tau)
    return _betas(np.clip(abar, clamp_min, None))


def sigmoid_beta_schedule_og(timesteps: int, start: float = -3.0,
                             end: float = 3.0,
                             tau: float = 1.0) -> torch.Tensor:
    """Original (unclamped) sigmoid schedule."""
    return _betas(_sigmoid_abar(timesteps, start, end, tau))


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> torch.Tensor:
    """Modified power-8 cosine schedule."""
    x = np.linspace(0.0, float(timesteps), timesteps + 1, dtype=np.float64)
    abar = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 8
    abar = abar / abar[0]
    min_value = 0.001
    return _betas(abar * (1.0 - min_value) + min_value)


def linear_beta_schedule(timesteps: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> torch.Tensor:
    """Linear schedule; like the reference, the passed bounds are replaced
    by (1e-4, 0.01)."""
    del beta_start, beta_end
    return _f32(np.linspace(1e-4, 0.01, timesteps, dtype=np.float64))


def alphas_cumprod_from_betas(betas: torch.Tensor) -> torch.Tensor:
    """alpha-bar_t = prod_{s<=t} (1 - beta_s), float32."""
    return torch.cumprod(1.0 - betas.float(), dim=0)


def ddim_noise_range(num_steps: int,
                     max_noise_level: int = 1000) -> torch.Tensor:
    """linspace(0, max-1, num_steps+1) cast to int: int32 (num_steps+1,)."""
    grid = np.linspace(0.0, float(max_noise_level - 1), num_steps + 1)
    return torch.from_numpy(grid.astype(np.int64).astype(np.int32))


def make_diffusion_constants(ddim_noise_steps: int,
                             max_noise_level: int = 1000,
                             clamp_min: float = 1e-6):
    """(betas, alphas_cumprod, noise_range, stabilization_level) as the
    trainer builds them: clamp_min=1e-6, stabilization = noise_range[1]."""
    betas = sigmoid_beta_schedule(max_noise_level, clamp_min=clamp_min)
    abar = alphas_cumprod_from_betas(betas)
    noise_range = ddim_noise_range(ddim_noise_steps, max_noise_level)
    return betas, abar, noise_range, int(noise_range[1])
