"""ImageNet normalisation (counterpart of ``eva_vos_tpu/ops/normalize.py``).

Images are channel-last (``[..., H, W, 3]``).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def im_normalize(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] float image in [0, 1] -> ImageNet-normalised."""
    # constants are rounded to float32 first, as the JAX package stores them
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(img)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(img)
    return (img - mean) / std
