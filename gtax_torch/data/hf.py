"""HuggingFace-datasets map-style backend (counterpart of gtax/data/hf.py):
load_dataset("Iker/GTAV-Driving-Dataset"); a row carries a 270x2400 strip
under "jpg" and its actions under json.actions_int. It needs the network
and the `datasets` package, imported when the dataset is built, so the
other backends run without either."""

from __future__ import annotations

import numpy as np

from gtax_torch.data.actions import actions_to_one_hot
from gtax_torch.data.common import ClipTransform


class HFDataset:
    def __init__(self, split: str = "train", return_actions: bool = False,
                 repo: str = "Iker/GTAV-Driving-Dataset",
                 transform: ClipTransform | None = None):
        from datasets import load_dataset

        self.dataset = load_dataset(repo, split=split)
        self.return_actions = return_actions
        self.transform = transform or ClipTransform()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        sample = self.dataset[idx]
        img = sample["jpg"]
        if not isinstance(img, np.ndarray):
            img = np.asarray(img)  # PIL -> uint8 HWC
        item = {"video": self.transform(img)}
        if self.return_actions:
            item["actions"] = actions_to_one_hot(
                sample["json"]["actions_int"])
        return item

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
