"""Host-side video and image IO (counterpart of gtax/io/video.py): OpenCV
with an imageio fallback for mp4 writing, PIL for prompt images."""

from __future__ import annotations

import io as _io

import numpy as np


def write_video(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """frames: (T, H, W, 3) uint8 RGB."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    if frames.dtype != np.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")
    try:
        import cv2

        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (w, h))
        try:
            if not writer.isOpened():
                raise RuntimeError("cv2.VideoWriter failed to open")
            for frame in frames:
                writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        finally:
            writer.release()
    except Exception as cv2_err:
        try:
            import imageio

            imageio.mimwrite(path, list(frames), fps=fps)
        except Exception as io_err:
            raise RuntimeError(
                f"write_video failed: cv2: {cv2_err!r}; imageio: {io_err!r}"
            ) from io_err


def read_video(path: str) -> np.ndarray:
    """Read a video into (T, H, W, 3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)


def read_image(path: str, size_hw: tuple[int, int] | None = None):
    """Read an image as float32 (3, H, W) in [0, 1], optionally resized
    (bilinear)."""
    with open(path, "rb") as f:
        return read_image_bytes(f.read(), size_hw)


def read_image_bytes(data: bytes, size_hw: tuple[int, int] | None = None):
    """read_image over in-memory encoded bytes."""
    from PIL import Image

    img = Image.open(_io.BytesIO(data)).convert("RGB")
    if size_hw is not None:
        img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return (np.asarray(img, dtype=np.float32) / 255.0).transpose(2, 0, 1)
