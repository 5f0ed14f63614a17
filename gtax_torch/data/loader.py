"""Batching with torch-DataLoader epoch semantics, and the host-to-device
copy (counterpart of gtax/data/loader.py).

The DataLoader is gtax's threaded batch assembler: a producer thread
stacks numpy batches into a bounded queue; map-style datasets are decoded
by a thread pool in a fixed order (JPEG decode and resize release the GIL);
iterable streams are read in stream order, so their cursor advances with
consumption. A batch reaches the card as one non-blocking copy from pinned
memory per array (to_device); uint8 clips stay uint8 until they are there.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass
class Batch:
    video: object                  # (B, T, 3, H, W) float32 pixels, or
    #                                (B, T, H, W, 3) uint8 pixels, or
    #                                (B, T, C, h, w) latents (is_latents)
    actions: Optional[object]      # (B, T, A) float32 or None
    is_latents: bool = False


def make_dataset(dataset_type: str, split: str, return_actions: bool, **kw):
    """The dataset backend named by the config."""
    if dataset_type == "dummy":
        from gtax_torch.data.dummy import DummyDataset

        return DummyDataset(split=split, return_actions=return_actions, **kw)
    if dataset_type == "hfdataset":
        from gtax_torch.data.hf import HFDataset

        return HFDataset(split=split, return_actions=return_actions, **kw)
    if dataset_type == "webdataset":
        from gtax_torch.data.webtar import WebTarDataset

        return WebTarDataset(split=split, return_actions=return_actions,
                             **kw)
    raise ValueError(f"Invalid dataset type: {dataset_type}. "
                     "Must be 'webdataset', 'hfdataset' or 'dummy'.")


class DataLoader:
    """Threaded batch assembler with bounded prefetch.

    Map-style datasets: one pass per __iter__, shuffled with seed + epoch
    (set_epoch pins the epoch; each pass advances it), rank r of `world`
    taking a stride of one permutation padded by wrapping, so every rank
    yields ceil(n / world) samples (DistributedSampler). Iterable datasets
    yield what their stream yields. The last partial batch is dropped
    unless drop_last=False. An error in the producer is raised in the
    consumer; a consumer that leaves early stops the producer."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = True, seed: int = 0,
                 shuffle: bool | None = None, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.seed = seed
        self.rank = rank
        self.world = max(1, world)
        self.is_iterable = not hasattr(dataset, "__getitem__")
        self.shuffle = (shuffle if shuffle is not None
                        else not self.is_iterable)
        self.epoch = 0

    def __len__(self):
        """Batches a rank yields an epoch (map-style)."""
        per_rank = -(-len(self.dataset) // self.world)
        return (per_rank // self.batch_size if self.drop_last
                else -(-per_rank // self.batch_size))

    def set_epoch(self, epoch: int) -> None:
        """Pin the next pass's shuffle epoch: a resumed run replays the
        interrupted epoch's permutation before skipping its batches."""
        self.epoch = int(epoch)

    def _epoch_order(self) -> np.ndarray:
        """This rank's sample indices for the next pass (advances epoch)."""
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        self.epoch += 1
        if self.world > 1:
            total = -(-n // self.world) * self.world
            if total > n:
                order = np.concatenate([order, order[:total - n]])
        return order[self.rank::self.world]

    def _sample_iter(self) -> Iterator[dict]:
        """One pass of samples in order; map-style datasets decode on a
        thread pool (num_workers > 1), read in submission order."""
        if self.is_iterable:
            yield from iter(self.dataset)
            return
        order = self._epoch_order()
        if self.num_workers <= 1:
            for i in order:
                yield self.dataset[int(i)]
            return
        with ThreadPoolExecutor(self.num_workers) as ex:
            futs: collections.deque = collections.deque()
            for i in order:
                futs.append(ex.submit(self.dataset.__getitem__, int(i)))
                if len(futs) > 2 * self.num_workers:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

    def _batches(self) -> Iterator[Batch]:
        vids, acts, is_latents = [], [], False
        for sample in self._sample_iter():
            is_latents = "latents" in sample
            if "video_u8" in sample:
                vids.append(np.asarray(sample["video_u8"], np.uint8))
            else:
                vids.append(np.asarray(
                    sample["latents" if is_latents else "video"],
                    np.float32))
            if "actions" in sample:
                acts.append(np.asarray(sample["actions"], np.float32))
            if len(vids) == self.batch_size:
                yield Batch(np.stack(vids),
                            np.stack(acts) if acts else None, is_latents)
                vids, acts = [], []
        if vids and not self.drop_last:
            yield Batch(np.stack(vids), np.stack(acts) if acts else None,
                        is_latents)

    def __iter__(self) -> Iterator[Batch]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever on a consumer that has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            batches = self._batches()
            try:
                for batch in batches:
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # raised in the consumer
                put(e)
            finally:
                batches.close()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a producer between its checks
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def to_device(a, device) -> torch.Tensor:
    """A host array to `device`: on a card, one non-blocking copy from
    pinned memory (the caching host allocator keeps the pinned buffer alive
    until the copy is done)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
