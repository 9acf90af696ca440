"""Mask utilities: one-hot encoding and boxes from masks (a copy of
``eva_vos_tpu/ops/masks.py``).

Parity targets: ``datasets/helpers.py:all_to_onehot`` and
``torchvision.ops.masks_to_boxes`` as used by ``robots/bbox_robot.py``.
These run on the host on numpy: they sit on the data and robot path, not
the compute path.
"""

from __future__ import annotations

import numpy as np


def all_to_onehot(masks: np.ndarray, labels) -> np.ndarray:
    """masks [T, H, W] (or [H, W]) of palette ids -> [len(labels), T, H, W] uint8."""
    masks = np.asarray(masks)
    if masks.ndim == 2:
        masks = masks[None]
    out = np.zeros((len(labels), *masks.shape), dtype=np.uint8)
    for k, l in enumerate(labels):
        out[k] = (masks == l).astype(np.uint8)
    return out


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """masks [N, H, W] bool/int -> boxes [N, 4] float32 (x1, y1, x2, y2).

    Matches torchvision semantics: coordinates are inclusive pixel indices.
    """
    masks = np.asarray(masks)
    if masks.ndim == 2:
        masks = masks[None]
    n = masks.shape[0]
    boxes = np.zeros((n, 4), dtype=np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys) == 0:
            continue
        boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes
