"""Synthetic videos with exact ground-truth masks, for tests and benchmarks
(a copy of ``eva_vos_tpu/data/synthetic.py:synthetic_video``, numpy only).

A coloured square per object drifts over a textured background, so
propagation can be exercised without any dataset or checkpoint.
"""

from __future__ import annotations

import numpy as np


def synthetic_video(t: int = 8, h: int = 64, w: int = 64, num_objects: int = 1,
                    size: int | None = None, seed: int = 0):
    """Moving-square video.

    Returns (images [T, H, W, 3] float32 in [0,1],
             masks [K, T, H, W] uint8 one-hot per object).
    """
    rng = np.random.default_rng(seed)
    size = size or max(4, min(h, w) // 4)

    base = rng.uniform(0.2, 0.6, size=(h, w, 3)).astype(np.float32)
    images = np.repeat(base[None], t, axis=0).copy()
    masks = np.zeros((num_objects, t, h, w), dtype=np.uint8)

    for k in range(num_objects):
        color = rng.uniform(0.7, 1.0, size=3).astype(np.float32)
        y0 = rng.integers(0, max(1, h - size - t))
        x0 = rng.integers(0, max(1, w - size - t))
        dy = 1 if (k + seed) % 2 == 0 else 0
        dx = 1
        for ti in range(t):
            y = int(np.clip(y0 + dy * ti, 0, h - size))
            x = int(np.clip(x0 + dx * ti, 0, w - size))
            images[ti, y:y + size, x:x + size] = color
            masks[k, ti, y:y + size, x:x + size] = 1
    return images, masks
