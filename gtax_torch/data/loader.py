"""Batching with torch-DataLoader epoch semantics, and the host-to-device
copy (counterpart of gtax/data/loader.py).

Only the `dummy` backend is ported; `webdataset` and `hfdataset` raise
NotImplementedError (ROADMAP.md). The loader assembles numpy batches in
the calling thread (gtax's decode thread pool serves the JPEG backends,
which are not ported); a batch reaches the card as one non-blocking copy
from pinned memory per array (to_device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass
class Batch:
    video: object                  # (B, T, 3, H, W) float32 pixels
    actions: Optional[object]      # (B, T, A) float32 or None


def make_dataset(dataset_type: str, split: str, return_actions: bool, **kw):
    """The dataset backend named by the config (only `dummy` is ported)."""
    if dataset_type == "dummy":
        from gtax_torch.data.dummy import DummyDataset

        return DummyDataset(split=split, return_actions=return_actions, **kw)
    if dataset_type in ("hfdataset", "webdataset"):
        raise NotImplementedError(
            f"dataset_type={dataset_type!r} is not ported yet (only "
            "'dummy'); see ROADMAP.md")
    raise ValueError(f"Invalid dataset type: {dataset_type}. "
                     "Must be 'webdataset', 'hfdataset' or 'dummy'.")


class DataLoader:
    """Map-style batching with torch-DataLoader epoch semantics: one pass
    over the dataset per __iter__, shuffled with a per-epoch seed (seed +
    epoch), the last partial batch dropped. gtax's multi-process striding
    comes with the parallel slice."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.epoch = 0  # bumped after each __iter__

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        self.epoch += 1
        vids, acts = [], []
        for i in order:
            sample = self.dataset[int(i)]
            vids.append(np.asarray(sample["video"], np.float32))
            if "actions" in sample:
                acts.append(np.asarray(sample["actions"], np.float32))
            if len(vids) == self.batch_size:
                yield Batch(np.stack(vids), np.stack(acts) if acts else None)
                vids, acts = [], []


def to_device(a, device) -> torch.Tensor:
    """A host array to `device`: on a card, one non-blocking copy from
    pinned memory (the caching host allocator keeps the pinned buffer alive
    until the copy is done)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
