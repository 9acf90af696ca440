"""Synthetic videos, the benchmark's own inputs.

``synthetic_video`` is a frozen copy of the port's
``data/synthetic.py:synthetic_video`` (itself the JAX package's), giving
uint8 frames as JPEG decoding gives them: a coloured square per object
drifts over a textured background, with its exact ground-truth mask.  No
dataset or checkpoint is in the repository.
"""

from __future__ import annotations

import numpy as np


def synthetic_video(t: int, h: int, w: int, rng: np.random.Generator,
                    num_objects: int = 1, size: int | None = None):
    """-> (frames [T, H, W, 3] uint8, masks [K, T, H, W] uint8 one-hot)."""
    size = size or max(4, min(h, w) // 4)
    base = (rng.uniform(0.2, 0.6, size=(h, w, 3)) * 255).astype(np.uint8)
    frames = np.repeat(base[None], t, axis=0)
    masks = np.zeros((num_objects, t, h, w), dtype=np.uint8)
    for k in range(num_objects):
        color = (rng.uniform(0.7, 1.0, size=3) * 255).astype(np.uint8)
        y0 = rng.integers(0, max(1, h - size - t))
        x0 = rng.integers(0, max(1, w - size - t))
        dy = int(rng.integers(0, 2))
        for ti in range(t):
            y = int(np.clip(y0 + dy * ti, 0, h - size))
            x = int(np.clip(x0 + ti, 0, w - size))
            frames[ti, y:y + size, x:x + size] = color
            masks[k, ti, y:y + size, x:x + size] = 1
    return frames, masks


def video_pool(lengths, h: int, w: int, rng: np.random.Generator):
    """One video a length, in the order given: [(name, frames, masks)]."""
    return [(f"synthetic-{i:02d}-t{t}", *synthetic_video(t, h, w, rng))
            for i, t in enumerate(lengths)]
