"""Frame-sequence output — headless "present" for camera paths.

The reference presents frames to a swapchain (Swapchain.cpp); headless
rendering writes camera-path flythroughs to MP4 (imageio/ffmpeg when
available), animated GIF (PIL fallback), or a PNG sequence directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


class VideoWriter:
    """Collects uint8 rgba frames; `save` picks a backend by extension."""

    def __init__(self):
        self.frames: list[np.ndarray] = []

    def add(self, frame_u8: np.ndarray) -> None:
        arr = np.asarray(frame_u8)
        if arr.dtype != np.uint8:
            raise TypeError("frames must be uint8")
        self.frames.append(arr[..., :3].copy())

    def save(self, path: str, fps: int = 30) -> str:
        if not self.frames:
            raise ValueError("no frames to save")
        path = str(path)
        ext = Path(path).suffix.lower()
        if ext in (".mp4", ".mkv", ".webm"):
            try:
                import imageio.v3 as iio

                iio.imwrite(path, np.stack(self.frames), fps=fps)
                return path
            except Exception:
                path = str(Path(path).with_suffix(".gif"))
                ext = ".gif"
        if ext == ".gif":
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(
                path,
                save_all=True,
                append_images=imgs[1:],
                duration=max(1000 // fps, 20),
                loop=0,
            )
            return path
        # directory -> PNG sequence
        os.makedirs(path, exist_ok=True)
        from PIL import Image

        for i, f in enumerate(self.frames):
            Image.fromarray(f).save(os.path.join(path, f"frame_{i:05d}.png"))
        return path
