"""Device rule of the port (the torch side of gtax/utils/platform.py).

Entry points run on the card: with no device given they take `cuda`, and
raise when there is none. The CPU is used only when the caller asks for it
(`device="cpu"`, as the tests do); nothing moves there silently.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def strict_matmul() -> None:
    """Make torch's own GEMMs on the card exact fp32 / fp32-accumulated:
    no TF32 and no reduced-precision bf16 reductions. The port's plain
    versions and the GEMMs outside its kernels rely on it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda, or raise if there is no card; inside an initialized
    process group, the rank's card (cuda:LOCAL_RANK, else the current one,
    which initialize_distributed set). Otherwise the device asked for. A
    cuda device also sets strict_matmul()."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run its plain PyTorch versions instead")
        device = "cuda"
        if dist.is_available() and dist.is_initialized():
            card = os.environ.get("LOCAL_RANK") or torch.cuda.current_device()
            device = f"cuda:{card}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        strict_matmul()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
