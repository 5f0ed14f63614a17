"""Keyboard-action encoding (copy of gtax/data/actions.py): 25-way one-hot
per frame; -1 encodes "no action"; index 3 is "W" / forward."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from gtax_torch.core.constants import ACTION_DIM, ACTION_FORWARD_INDEX


def actions_to_one_hot(actions: Sequence[int],
                       dim: int = ACTION_DIM) -> np.ndarray:
    """(T,) ints in [-1, dim) -> (T, dim) float32 one-hot; -1 -> zeros."""
    actions = np.asarray(actions, dtype=np.int64)
    out = np.zeros((len(actions), dim), dtype=np.float32)
    mask = actions >= 0
    out[np.arange(len(actions))[mask], actions[mask]] = 1.0
    return out


def forward_actions(batch: int, frames: int,
                    dim: int = ACTION_DIM) -> np.ndarray:
    """All-frames "drive straight" (W pressed) actions."""
    out = np.zeros((batch, frames, dim), dtype=np.float32)
    out[:, :, ACTION_FORWARD_INDEX] = 1.0
    return out
