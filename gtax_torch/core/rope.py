"""Rotary position embeddings, lang and pixel-axial flavours (counterpart of
gtax/core/rope.py).

- lang freqs: 1/theta^(2i/dim); pixel freqs: linspace(1, max_freq/2,
  dim//2) * pi;
- axial tables over pixel axes positioned at linspace(-1, 1, axis_len);
- each frequency repeated twice along the last axis ([f0, f0, f1, f1, ...])
  and rotation over INTERLEAVED pairs: out[2i] = -x[2i+1],
  out[2i+1] = x[2i] (not the split-halves convention);
- rotation math in float32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lang_freqs(dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE inverse frequencies, (dim//2,) float32."""
    exponents = np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim
    return torch.from_numpy((1.0 / (theta**exponents)).astype(np.float32))


def pixel_freqs(dim: int, max_freq: float) -> torch.Tensor:
    """linspace(1, max_freq/2, dim//2) * pi, float32."""
    f = np.linspace(1.0, max_freq / 2.0, dim // 2, dtype=np.float64) * math.pi
    return torch.from_numpy(f.astype(np.float32))


def seq_freqs(positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Outer product of positions and freqs, each frequency repeated twice:
    (..., n) -> (..., 2n) as [f0, f0, f1, f1, ...]."""
    f = positions.float()[..., None] * freqs.float()
    return torch.repeat_interleave(f, 2, dim=-1)


def axial_freqs(freqs: torch.Tensor, dims: tuple[int, ...],
                pixel: bool) -> torch.Tensor:
    """N-dimensional axial table, (*dims, len(dims) * 2 * |freqs|). Pixel
    flavour places the last two axes at linspace(-1, 1, d); other axes use
    arange(d)."""
    n = len(dims)
    per_axis = []
    for ind, d in enumerate(dims):
        if pixel and ind >= n - 2:
            pos = torch.linspace(-1.0, 1.0, d, dtype=torch.float32,
                                 device=freqs.device)
        else:
            pos = torch.arange(d, dtype=torch.float32, device=freqs.device)
        sf = seq_freqs(pos, freqs)
        shape = [1] * n + [sf.shape[-1]]
        shape[ind] = d
        per_axis.append(sf.reshape(shape).expand(*dims, sf.shape[-1]))
    return torch.cat(per_axis, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[x0, x1, x2, x3, ...] -> [-x1, x0, -x3, x2, ...]."""
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack((-x2[..., 1], x2[..., 0]), dim=-1).flatten(-2)


def apply_rotary_emb(freqs: torch.Tensor, t: torch.Tensor,
                     start_index: int = 0) -> torch.Tensor:
    """Rotate t[..., start:start+rot_dim] by `freqs` in float32; the rest of
    the feature dim passes through; the result has t's dtype."""
    rot_dim = freqs.shape[-1]
    end_index = start_index + rot_dim
    if rot_dim > t.shape[-1]:
        raise ValueError(f"feature dim {t.shape[-1]} too small to rotate "
                         f"{rot_dim} positions")
    t32 = t.float()
    f32 = freqs.float()
    mid = t32[..., start_index:end_index]
    mid = mid * torch.cos(f32) + rotate_half(mid) * torch.sin(f32)
    return torch.cat([t32[..., :start_index], mid, t32[..., end_index:]],
                     dim=-1).to(t.dtype)


def temporal_rope_freqs(positions: torch.Tensor,
                        freqs: torch.Tensor) -> torch.Tensor:
    """1-D temporal table at integer positions, (T, 2 * |freqs|)."""
    return seq_freqs(positions, freqs)
