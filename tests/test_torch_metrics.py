"""gtax_torch.utils.metrics (PSNR, SSIM) against gtax.utils.metrics on
seeded uint8 frames: the same float64 arithmetic, so the same values to the
last bit."""

import numpy as np
import pytest
import torch

from gtax.utils import metrics as jmetrics
from gtax_torch.utils import metrics


def _frames(seed, shape=(3, 36, 52, 3)):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    noise = rng.integers(-12, 13, shape)
    return a, np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_matches_gtax(seed):
    a, b = _frames(seed)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.psnr(a, b, max_val=1.0) == jmetrics.psnr(a, b, 1.0)
    assert metrics.per_frame_psnr(a, b) == jmetrics.per_frame_psnr(a, b)
    assert metrics.psnr(a, a) == float("inf")


@pytest.mark.parametrize("win", [8, 5])
def test_ssim_matches_gtax(win):
    """Frame sides that are not multiples of the window drop the ragged
    edge, as gtax's do."""
    a, b = _frames(2)
    assert metrics.ssim(a[0], b[0], win=win) == jmetrics.ssim(a[0], b[0],
                                                              win=win)
    assert metrics.per_frame_ssim(a, b) == jmetrics.per_frame_ssim(a, b)
    assert metrics.ssim(a[0], a[0]) == pytest.approx(1.0)


def test_metrics_take_cpu_tensors_and_check_shapes():
    a, b = _frames(3)
    assert metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)) == \
        jmetrics.psnr(a, b)
    assert metrics.ssim(torch.from_numpy(a[1]), torch.from_numpy(b[1])) == \
        jmetrics.ssim(a[1], b[1])
    with pytest.raises(ValueError, match="shapes differ"):
        metrics.per_frame_psnr(a, b[:2])
    with pytest.raises(ValueError, match="shapes differ"):
        metrics.ssim(a[0], b[0, :8])
