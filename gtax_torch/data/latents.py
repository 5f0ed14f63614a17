"""Precomputed-latent training (counterpart of gtax/data/latents.py):
encode each clip through the frozen VAE once, cache the latents, and feed
them straight into the diffusion loss, so the frozen encode leaves the
training step.

Latents are stored as the trainer's encode produces them (encode_frames:
the unfused VAE, posterior mean * LATENT_SCALE, float32), so with the same
VAE params, compute dtype, attention backend and batches, cached training
gives the same losses as encoding on the fly.

    ds = make_dataset("webdataset", "train", True, shards=[...])
    lat = LatentCacheDataset.build(ds, vae_params, vae_cfg, "cache/train")
    # later runs: LatentCacheDataset("cache/train")

The cache is two npy files (memory-mapped on read) and meta.json:
    latents.npy  (N, T, C, h, w) float32 (or float16 via dtype=)
    actions.npy  (N, T, A) float32           [only when the clips carry them]
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np
import torch


class LatentCacheDataset:
    """Map-style dataset over a latent cache directory."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.latents = np.load(os.path.join(cache_dir, "latents.npy"),
                               mmap_mode="r")
        # the meta decides, not file presence: a rebuild without actions
        # must not serve an older build's actions.npy
        self.actions = (
            np.load(os.path.join(cache_dir, "actions.npy"), mmap_mode="r")
            if self.meta.get("has_actions") else None)
        self.cache_dir = cache_dir

    def __len__(self):
        # meta n, not the file's leading dim: a stream that ended early
        # leaves the preallocated memmap longer than the sample count
        return self.meta["n"]

    def __getitem__(self, i):
        item = {"latents": np.asarray(self.latents[i], np.float32)}
        if self.actions is not None:
            item["actions"] = np.asarray(self.actions[i], np.float32)
        return item

    @classmethod
    def build(cls, dataset, vae_params, vae_cfg, cache_dir: str,
              encode_batch: int = 32, compute_dtype=torch.float32,
              dtype=np.float32, progress_every: int = 50,
              max_samples: int | None = None, backend: str = "xla"):
        """Encode a clip dataset into a latent cache.

        Samples are {"video": (T, 3, H, W) float32 in [0, 1]} or
        {"video_u8": (T, H, W, 3) uint8}, with "actions": (T, A) when the
        clips carry them. Map-style datasets are read by index; iterable
        streams (the tar streamer) are consumed in stream order for up to
        min(len(dataset), max_samples) clips. Encodes on the device of
        vae_params with encode_frames' defaults (unfused, the attention of
        `backend`: pass the trainer's, with encode_batch = its batch, for
        the same latents it encodes)."""
        from gtax_torch.train.trainer import encode_frames

        os.makedirs(cache_dir, exist_ok=True)
        n = len(dataset)
        if max_samples is not None:
            n = min(n, max_samples)
        if n <= 0:
            raise ValueError("dataset reports zero length; pass max_samples")
        if hasattr(dataset, "__getitem__"):
            sample_iter = (dataset[i] for i in range(n))
        else:
            sample_iter = itertools.islice(iter(dataset), n)
        device = vae_params["patch_embed"]["kernel"].device
        lat_path = os.path.join(cache_dir, "latents.npy")
        act_path = os.path.join(cache_dir, "actions.npy")
        for stale in (lat_path, act_path,
                      os.path.join(cache_dir, "meta.json")):
            if os.path.exists(stale):  # a rebuild mixes with no old file
                os.remove(stale)
        lat_out = act_out = None
        done = 0
        while done < n:
            samples = list(itertools.islice(sample_iter, encode_batch))
            if not samples:  # the stream ended early
                break
            hi = done + len(samples)
            if "video_u8" in samples[0]:
                video = np.stack([np.asarray(s["video_u8"])
                                  for s in samples])
            else:
                video = np.stack([np.asarray(s["video"], np.float32)
                                  for s in samples])
            with torch.no_grad():
                lat = encode_frames(vae_params, vae_cfg,
                                    torch.from_numpy(video).to(device),
                                    compute_dtype, backend=backend)
            lat = lat.cpu().numpy().astype(dtype)
            if lat_out is None:
                lat_out = np.lib.format.open_memmap(
                    lat_path, mode="w+", dtype=dtype,
                    shape=(n,) + lat.shape[1:])
                if "actions" in samples[0]:
                    a0 = np.asarray(samples[0]["actions"], np.float32)
                    act_out = np.lib.format.open_memmap(
                        act_path, mode="w+", dtype=np.float32,
                        shape=(n,) + a0.shape)
            lat_out[done:hi] = lat
            if act_out is not None:
                act_out[done:hi] = np.stack(
                    [np.asarray(s["actions"], np.float32) for s in samples])
            done = hi
            if progress_every and (done // encode_batch) % progress_every == 0:
                print(f"[gtax_torch.data] latent cache: {done}/{n}")
        if lat_out is None:
            raise ValueError("dataset yielded no samples")
        lat_out.flush()
        if act_out is not None:
            act_out.flush()
        with open(os.path.join(cache_dir, "meta.json"), "w") as f:
            json.dump({"n": done, "latent_shape": list(lat_out.shape[1:]),
                       "dtype": np.dtype(dtype).name,
                       "latent_dim": vae_cfg.latent_dim,
                       "has_actions": act_out is not None}, f)
        return cls(cache_dir)
