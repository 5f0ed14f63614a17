"""Host-side clip preprocessing (copy of gtax/data/common.py): each
dataset sample is a 270x2400 JPEG strip of 5 consecutive 270x480 frames,
split along the width and bilinearly resized to 360x640. The decode and
resize take cv2 when it imports, else PIL, as gtax does."""

from __future__ import annotations

import numpy as np

from gtax_torch.core.constants import FRAME_HEIGHT, FRAME_WIDTH

_SPLIT_N = 5

_SPLITS = {"train": 1270669, "validation": 4040, "test": 4588}


def split_len(split: str) -> int:
    """The GTA V dataset's split sizes."""
    return _SPLITS[split]


def _resize_frame(frame: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of an HWC uint8/float frame."""
    try:
        import cv2

        return cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
    except Exception:
        from PIL import Image

        img = Image.fromarray(
            frame if frame.dtype == np.uint8
            else (frame * 255).astype(np.uint8))
        out = np.asarray(img.resize((w, h), Image.BILINEAR))
        return out if frame.dtype == np.uint8 else (
            out.astype(np.float32) / 255.0)


def decode_strip_clip_u8(jpg_bytes: bytes, n_frames: int = _SPLIT_N,
                         target_h: int = FRAME_HEIGHT,
                         target_w: int = FRAME_WIDTH) -> np.ndarray:
    """JPEG strip bytes -> (N, target_h, target_w, 3) uint8 RGB clip:
    decode, split and resize on the host; the float cast and the CHW
    transpose happen on the device (trainer.as_float_video)."""
    try:
        import cv2

        bgr = cv2.imdecode(np.frombuffer(jpg_bytes, np.uint8),
                           cv2.IMREAD_COLOR)
        strip = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    except Exception:
        import io

        from PIL import Image

        strip = np.asarray(Image.open(io.BytesIO(jpg_bytes)).convert("RGB"))
    h, total_w, _ = strip.shape
    w = total_w // n_frames
    frames = strip.reshape(h, n_frames, w, 3).transpose(1, 0, 2, 3)
    out = np.empty((n_frames, target_h, target_w, 3), dtype=np.uint8)
    for i in range(n_frames):
        out[i] = _resize_frame(np.ascontiguousarray(frames[i]), target_h,
                               target_w)
    return out


class ClipTransform:
    """strip (H, N*W, 3) uint8 -> clip (N, 3, target_h, target_w) float32
    in [0, 1]."""

    def __init__(self, n_frames: int = _SPLIT_N,
                 target_h: int = FRAME_HEIGHT, target_w: int = FRAME_WIDTH):
        self.n_frames = n_frames
        self.target_h = target_h
        self.target_w = target_w

    def __call__(self, strip: np.ndarray) -> np.ndarray:
        h, total_w, c = strip.shape
        if c != 3 or strip.dtype != np.uint8:
            raise ValueError(f"ClipTransform takes (H, W, 3) uint8 strips, "
                             f"got {strip.shape} {strip.dtype}")
        w = total_w // self.n_frames
        frames = strip.reshape(h, self.n_frames, w, 3).transpose(1, 0, 2, 3)
        out = np.empty((self.n_frames, self.target_h, self.target_w, 3),
                       dtype=np.uint8)
        for i in range(self.n_frames):
            out[i] = _resize_frame(frames[i], self.target_h, self.target_w)
        return (out.astype(np.float32) / 255.0).transpose(0, 3, 1, 2)
