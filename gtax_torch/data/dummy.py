"""Synthetic smoke-test dataset (copy of gtax/data/dummy.py, the
reference's integration-test data): constant blue->red gradient clips of 5
frames at 360x640; with actions enabled, a binary action on the last frame
picks a red (0) or green (1) last frame, a causality probe for action
conditioning. The action is drawn from (seed, index), so a sample is the
same on every access. len = 10M train / 10 val unless `size` is given."""

from __future__ import annotations

import numpy as np

from gtax_torch.core.constants import ACTION_DIM, FRAME_HEIGHT, FRAME_WIDTH
from gtax_torch.data.actions import actions_to_one_hot


class DummyDataset:
    def __init__(self, split: str = "train", return_actions: bool = False,
                 height: int = FRAME_HEIGHT, width: int = FRAME_WIDTH,
                 seed: int = 0, size: int | None = None):
        self.split = split
        self.return_actions = return_actions
        self.size = size
        self.seed = seed
        blue = np.array([0.0, 0.0, 1.0], np.float32)
        red = np.array([1.0, 0.0, 0.0], np.float32)
        green = np.array([0.0, 1.0, 0.0], np.float32)
        frames = [np.broadcast_to(((1 - t) * blue + t * red)[:, None, None],
                                  (3, height, width))
                  for t in np.linspace(0.0, 1.0, 5)]
        self.seq_blue_red = np.stack(frames).astype(np.float32)
        self.seq_blue_green = self.seq_blue_red.copy()
        self.seq_blue_green[-1] = np.broadcast_to(green[:, None, None],
                                                  (3, height, width))

    def __len__(self):
        if self.size is not None:
            return self.size
        return 10_000_000 if self.split == "train" else 10

    def __getitem__(self, index):
        if not self.return_actions:
            return {"video": self.seq_blue_red}
        last_action = int(
            np.random.default_rng((self.seed, index)).integers(0, 2))
        actions = np.full((5,), -1, np.int64)
        actions[-1] = last_action
        video = self.seq_blue_red if last_action == 0 else self.seq_blue_green
        return {"video": video,
                "actions": actions_to_one_hot(actions, ACTION_DIM)}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
