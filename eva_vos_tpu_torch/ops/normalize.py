"""ImageNet normalisation (counterpart of ``eva_vos_tpu/ops/normalize.py``).

Images are channel-last (``[..., H, W, 3]``).
"""

from __future__ import annotations

import numpy as np
import torch

# float32, as the JAX package stores them: host code that normalises numpy
# images with them rounds as it does there
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def im_normalize(img: torch.Tensor) -> torch.Tensor:
    """[..., 3] float image in [0, 1] -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN).to(img)
    std = torch.as_tensor(IMAGENET_STD).to(img)
    return (img - mean) / std
