"""Quality metrics, PSNR and SSIM (counterpart of gtax/utils/metrics.py),
over uint8-range frames as numpy arrays (or CPU tensors)."""

from __future__ import annotations

import numpy as np


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two images or videos."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def per_frame_psnr(video_a, video_b, max_val: float = 255.0) -> list[float]:
    """PSNR per frame of two (T, H, W, C) videos."""
    if np.shape(video_a) != np.shape(video_b):
        raise ValueError(f"shapes differ: {np.shape(video_a)} vs "
                         f"{np.shape(video_b)}")
    return [psnr(fa, fb, max_val) for fa, fb in zip(video_a, video_b)]


def ssim(a, b, max_val: float = 255.0, win: int = 8) -> float:
    """Structural similarity of two (H, W, C) images (Wang et al. 2004) over
    non-overlapping uniform win x win tiles, the tiles' SSIM averaged."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    H, W = a.shape[:2]
    h, w = H - H % win, W - W % win

    def tiles(x):  # (h/win, w/win, win * win * C)
        x = x[:h, :w].reshape(h // win, win, w // win, win, -1)
        return x.transpose(0, 2, 1, 3, 4).reshape(h // win, w // win, -1)

    ta, tb = tiles(a), tiles(b)
    mu_a, mu_b = ta.mean(-1), tb.mean(-1)
    var_a, var_b = ta.var(-1), tb.var(-1)
    cov = (ta * tb).mean(-1) - mu_a * mu_b
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def per_frame_ssim(video_a, video_b, max_val: float = 255.0) -> list[float]:
    """SSIM per frame of two (T, H, W, C) videos."""
    if np.shape(video_a) != np.shape(video_b):
        raise ValueError(f"shapes differ: {np.shape(video_a)} vs "
                         f"{np.shape(video_b)}")
    return [ssim(fa, fb, max_val) for fa, fb in zip(video_a, video_b)]
