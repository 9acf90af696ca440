"""Resize helpers, channel-last (counterpart of ``eva_vos_tpu/ops/resize.py``).

``jax.image.resize(method="bilinear")`` samples at half-pixel centres, which
is ``F.interpolate(mode="bilinear", align_corners=False)``.  The pipeline only
upsamples with it, where neither side antialiases.  ``area_downsample`` is an
average pool over exact integer factors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C] bilinear, half-pixel."""
    *lead, h, w, c = x.shape
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(nchw, size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., 2H, 2W, C] bilinear."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, (2 * h, 2 * w))


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool [..., H, W] by an integer factor (torch ``mode='area'``)."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // factor, factor, w // factor, factor)
    return x.mean(dim=(-3, -1))
