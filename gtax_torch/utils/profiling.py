"""Step timing, profiler traces, FLOP accounting and MFU (counterpart of
gtax/utils/profiling.py).

StepTimer is gtax's wall-clock timer with warmup discard; `trace` records
a torch.profiler window (the card's kernels too, when CUDA is in use) and
writes it as a Chrome trace when the window closes, however it closes.
dit_forward_flops is gtax's analytic count of one DiT forward (matmuls
only, 2*M*N*K each); MFUCounter divides a step's model FLOPs by its wall
time and the device's dense bf16 peak. The peak table names the card the
port runs on; a device it does not know raises rather than guessing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("gtax_torch.profiling")


class StepTimer:
    """Wall-clock timing with warmup discard and simple stats."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._seen = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")


@contextlib.contextmanager
def trace(profile_dir: str | None, name: str = "trace.json"):
    """A torch.profiler window (CPU, and CUDA once CUDA is initialised)
    written to <profile_dir>/<name> as a Chrome trace when the block exits,
    normally or by an exception; a no-op when profile_dir is None."""
    if profile_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(profile_dir, name)
        prof.export_chrome_trace(path)
        logger.info("wrote profiler trace to %s", path)


def dit_forward_flops(cfg, batch: int, frames: int) -> float:
    """Analytic FLOPs of one DiT forward: patchify and final GEMMs, the
    conditioning path, per block the qkv/out/MLP/adaLN GEMMs of both halves
    and the spatial (S x S per frame) and temporal (T x T per site)
    attention products."""
    D = cfg.hidden_size
    S = cfg.grid_h * cfg.grid_w
    tokens = batch * frames * S
    f = 0.0
    pin = cfg.in_channels * cfg.patch_size**2
    f += 2.0 * tokens * pin * D
    f += 2.0 * tokens * D * (cfg.patch_size**2 * cfg.in_channels)
    f += 2.0 * batch * frames * (256 * D + D * D)
    per_block = 0.0
    per_block += 2.0 * (2.0 * tokens * D * 3 * D + 2.0 * tokens * D * D)
    per_block += 2.0 * (2.0 * 2.0 * tokens * D * cfg.mlp_hidden)
    per_block += 2.0 * (2.0 * batch * frames * D * 6 * D)
    hd = cfg.head_dim
    per_block += 2.0 * 2.0 * batch * frames * cfg.num_heads * S * S * hd
    per_block += 2.0 * 2.0 * batch * S * cfg.num_heads * frames * frames * hd
    f += cfg.depth * per_block
    return f


class MFUCounter:
    """Model-FLOPs utilisation against the device's dense bf16 peak."""

    # dense bf16 tensor-core peak, FLOP/s (NVIDIA data sheets, SXM parts at
    # their full power limit)
    PEAKS = {"h100": 989e12, "h200": 989e12}

    @classmethod
    def peak_for_kind(cls, kind: str) -> float:
        kind = kind.lower()
        for key, peak in cls.PEAKS.items():
            if key in kind:
                return peak
        raise ValueError(f"no bf16 peak known for device {kind!r}")

    def __init__(self, flops_per_step: float, peak: float):
        self.flops_per_step = flops_per_step
        self.peak = peak

    def mfu(self, step_seconds: float) -> float:
        return self.flops_per_step / (step_seconds * self.peak)


def bf16_differences(got, ref) -> tuple[float, float]:
    """How far a kernel's bf16 output is from its plain version's: the
    share of elements whose bf16 values differ, and the largest difference
    over the plain output's largest magnitude (the rounding-point figures
    of PERF.md and the card tests)."""
    a, b = got.float(), ref.float()
    share = (a != b).float().mean().item()
    top = b.abs().max().item()
    return share, (a - b).abs().max().item() / max(top, 1e-30)
