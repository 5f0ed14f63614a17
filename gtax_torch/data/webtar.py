"""Streaming tar-shard dataset (counterpart of gtax/data/webtar.py, gtax's
replacement for the reference's webdataset pipeline).

- Streams .tar shards in order: local paths, or HTTPS URLs (the
  HuggingFace hub's shards with a bearer token and retries).
- Groups tar members into samples by the basename up to the first dot and
  decodes .jpg (PIL), .cls (int) and .json.
- Shuffles the shard order per epoch and the samples through a buffer;
  deals shards round-robin over (process, worker) slots; `resampled`
  streams epoch after epoch.
- `decode_workers` > 0 decodes on a thread pool ahead of the stream,
  in stream order; `pixel_u8` yields uint8 channel-last clips (the float
  cast happens on the device).
- `cursor` = [epoch, shard position in this worker's list, samples
  consumed in that shard] is the producer's position: the trainer saves it
  and restores it on resume. Samples that were decoded ahead, prefetched or
  held in the shuffle buffer when it was saved are not replayed.

Two of gtax's faults are not replicated: a RuntimeError from the decode
pool other than its shutdown is raised to the consumer (gtax ended the
stream quietly), and a dataset built with no JPEG decoder importable
raises ImportError at once (gtax's shard loop caught each sample's
failure, and a resampled stream looped forever).
"""

from __future__ import annotations

import collections
import io
import json
import random
import tarfile
import time
import urllib.request
from typing import Iterator

import numpy as np

from gtax_torch.data.actions import actions_to_one_hot
from gtax_torch.data.common import (ClipTransform, decode_strip_clip_u8,
                                    split_len)

HF_DATASET_PATTERNS = {
    "train": "**/train/*.tar",
    "validation": "dev/00000.tar",
    "test": "**/test/**/*.tar",
}


def hf_shard_urls(split: str, repo: str = "Iker/GTAV-Driving-Dataset"):
    """The split's shard URLs on the HuggingFace hub (needs the network and
    huggingface_hub, imported here)."""
    from huggingface_hub import HfFileSystem, hf_hub_url

    fs = HfFileSystem()
    pattern = f"hf://datasets/{repo}/{HF_DATASET_PATTERNS[split]}"
    files = [fs.resolve_path(p) for p in fs.glob(pattern)]
    if not files:
        raise ValueError(f"No shards for split '{split}' ({pattern})")
    return [hf_hub_url(f.repo_id, f.path_in_repo, repo_type="dataset")
            for f in files]


def _open_shard(source: str, token: str | None, retries: int = 3):
    """Open a local path or URL as a streaming file object."""
    if "://" not in source:
        return open(source, "rb")
    last_err = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(source)
            if token:
                req.add_header("Authorization", f"Bearer {token}")
            return urllib.request.urlopen(req)
        except OSError as e:  # retry with backoff, as curl --retry 3
            last_err = e
            time.sleep(1.0 * (attempt + 1))
    raise last_err


def iter_tar_samples(fileobj) -> Iterator[dict]:
    """Group sequential tar members into samples keyed by
    basename-before-dot."""
    tar = tarfile.open(fileobj=fileobj, mode="r|*")
    current_key, current = None, {}
    for member in tar:
        if not member.isfile():
            continue
        name = member.name.split("/")[-1]
        if "." not in name:
            continue
        key, ext = name.split(".", 1)
        if key != current_key:
            if current:
                yield current
            current_key, current = key, {"__key__": key}
        current[ext.lower()] = tar.extractfile(member).read()
    if current:
        yield current


def decode_sample(raw: dict) -> dict:
    out = {"__key__": raw.get("__key__", "")}
    if "jpg" in raw or "jpeg" in raw:
        from PIL import Image

        img = Image.open(io.BytesIO(raw.get("jpg", raw.get("jpeg"))))
        out["jpg"] = np.asarray(img.convert("RGB"))  # (H, W, 3) uint8
    if "cls" in raw:
        out["cls"] = int(raw["cls"].decode().strip() or 0)
    if "json" in raw:
        out["json"] = json.loads(raw["json"].decode())
    return out


def _check_decoder(pixel_u8: bool) -> None:
    """Raise ImportError unless a JPEG decoder of the path is importable:
    PIL for decode_sample, cv2 or PIL for the pixel_u8 path."""
    names = ("cv2", "PIL") if pixel_u8 else ("PIL",)
    for name in names:
        try:
            __import__(name)
            return
        except ImportError:
            continue
    raise ImportError(
        f"WebTarDataset(pixel_u8={pixel_u8}) needs a JPEG decoder: "
        f"{' or '.join(names)} (opencv-python / pillow)")


class _PoolError(RuntimeError):
    """The decode pool refused work for a reason other than its shutdown:
    not a fault of the shard, so the shard loop lets it through."""


class WebTarDataset:
    """Iterable clip dataset over tar shards: yields {"video": (5, 3, H, W)
    float32} or, with pixel_u8, {"video_u8": (5, H, W, 3) uint8}, plus
    {"actions": (5, 25) float32} when return_actions."""

    def __init__(self, split: str = "train", return_actions: bool = False,
                 shards: list[str] | None = None, token: str | None = None,
                 shuffle_shards: bool = True, shuffle_buffer: int = 1000,
                 resampled: bool = True, seed: int = 0,
                 worker_index: int = 0, num_workers: int = 1,
                 transform: ClipTransform | None = None,
                 size: int | None = None, decode_workers: int = 0,
                 pixel_u8: bool = False):
        _check_decoder(pixel_u8)
        self.split = split
        self.return_actions = return_actions
        self._custom_shards = shards is not None
        self._size = size
        if shards is None:
            shards = hf_shard_urls(split)
            if token is None:
                from huggingface_hub import get_token

                token = get_token()
        self.shards = list(shards)
        if not self.shards:
            raise ValueError("WebTarDataset needs at least one shard")
        self.token = token
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = shuffle_buffer
        self.resampled = resampled
        self.seed = seed
        self.worker_index = worker_index
        self.num_workers = num_workers
        self.transform = transform or ClipTransform()
        self.decode_workers = decode_workers
        self.pixel_u8 = pixel_u8
        self.cursor = [0, 0, 0]

    def __len__(self):
        """Nominal samples an epoch (the schedule's steps_per_epoch): size=
        if given; for custom shards without it ~1000 a shard (counting
        would stream every tar); else the registry size of the split."""
        if self._size is not None:
            return self._size
        if self._custom_shards:
            est = len(self.shards) * 1000
            print(f"[gtax_torch.data] WebTarDataset: custom shards without "
                  f"size=; estimating len as {est} (pass size= for a "
                  f"correct LR schedule)")
            self._size = est
            return est
        try:
            return split_len(self.split)
        except KeyError:
            return 0

    def _worker_shards(self, epoch: int) -> list[str]:
        shards = list(self.shards)
        if self.shuffle_shards:
            random.Random(self.seed + epoch).shuffle(shards)
        mine = shards[self.worker_index::self.num_workers]
        if not mine:
            # fewer shards than slots: wrap around rather than spin on an
            # empty list (a worker that never yields stalls its consumer)
            mine = [shards[self.worker_index % len(shards)]]
        return mine

    def _make_item_raw(self, raw: dict):
        """Raw tar-member bytes -> sample item (None: skipped)."""
        if self.pixel_u8:
            jpg = raw.get("jpg", raw.get("jpeg"))
            if jpg is None:
                return None
            tf = self.transform
            item = {"video_u8": decode_strip_clip_u8(
                jpg, n_frames=tf.n_frames, target_h=tf.target_h,
                target_w=tf.target_w)}
        else:
            sample = decode_sample(raw)
            if "jpg" not in sample:
                return None
            item = {"video": self.transform(sample["jpg"])}
        if not self.return_actions:
            return item
        if self.pixel_u8:
            js = json.loads(raw["json"].decode()) if "json" in raw else {}
        else:
            js = sample.get("json", {})
        actions = js.get("actions_int")
        if actions is None:
            return None
        item["actions"] = actions_to_one_hot(actions)
        return item

    def _decoded_items(self, raw_iter, pool):
        """_make_item_raw over a raw-sample stream, in stream order; with a
        pool, up to 2 * decode_workers decodes run ahead on threads."""
        if pool is None:
            for raw in raw_iter:
                yield self._make_item_raw(raw)
            return
        futs: collections.deque = collections.deque()
        for raw in raw_iter:
            try:
                futs.append(pool.submit(self._make_item_raw, raw))
            except RuntimeError as e:
                if "shutdown" in str(e):  # the pool or interpreter is
                    return                # closing: end the stream
                raise _PoolError(str(e)) from e
            if len(futs) > 2 * self.decode_workers:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()

    def __iter__(self):
        rng = random.Random(self.seed + 17 * self.worker_index)
        buffer: list = []
        epoch, start_shard, start_sample = self.cursor
        pool = None
        if self.decode_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(
                self.decode_workers,
                thread_name_prefix="gtax-torch-webtar-decode")
        try:
            while True:
                shards = self._worker_shards(epoch)
                for si in range(start_shard, len(shards)):
                    self.cursor = [epoch, si, 0]
                    skip, start_sample = start_sample, 0
                    try:
                        raw_iter = iter_tar_samples(
                            _open_shard(shards[si], self.token))
                        while skip > 0:
                            if next(raw_iter, None) is None:
                                break
                            skip -= 1
                            self.cursor[2] += 1
                        for item in self._decoded_items(raw_iter, pool):
                            self.cursor[2] += 1
                            if item is None:
                                continue
                            if self.shuffle_buffer > 1:
                                buffer.append(item)
                                if len(buffer) >= self.shuffle_buffer:
                                    yield buffer.pop(
                                        rng.randrange(len(buffer)))
                            else:
                                yield item
                    except _PoolError:
                        raise
                    except Exception as e:
                        # a bad shard or sample is skipped (webdataset's
                        # warn_and_continue)
                        print(f"[gtax_torch.data] shard {shards[si]} "
                              f"failed: {e!r}; skipping")
                        continue
                start_shard = 0
                while buffer:
                    yield buffer.pop(rng.randrange(len(buffer)))
                epoch += 1
                self.cursor = [epoch, 0, 0]
                if not self.resampled:
                    return
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
