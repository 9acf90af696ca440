"""Resize helpers (counterpart of ``eva_vos_tpu/ops/resize.py``).

``jax.image.resize`` samples at half-pixel centres and, on an axis that
shrinks, widens its kernel by the scale (an antialiasing filter):

* bilinear is ``F.interpolate(mode="bilinear", align_corners=False)``, with
  ``antialias=True`` only when an output axis is smaller than its input
  (the engine's upsampling keeps the plain kernel);
* bicubic is ``mode="bicubic", antialias=True`` (torch's antialiased cubic
  takes the same Keys coefficient, -0.5, as JAX; its plain one -0.75);
* nearest is ``mode="nearest-exact"`` (``"nearest"`` floors the source
  coordinate instead of rounding the half-pixel centre).

The antialiased kernels take float32 and float64 only, so other float dtypes
are resized in float32 and cast back.  ``area_downsample`` is an average pool
over exact integer factors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, out_hw, h_axis: int, w_axis: int,
            **kw) -> torch.Tensor:
    """``F.interpolate`` over axes ``h_axis`` and ``w_axis`` of ``x``; every
    other axis is a batch or channel axis.  Channel-last ``[..., H, W, C]``
    goes to the kernel as an NCHW view of the same memory."""
    nd = x.ndim
    h_axis, w_axis = h_axis % nd, w_axis % nd
    if nd == 2:
        x = x[..., None]
    at = (x.ndim - 3, x.ndim - 2)
    cl = torch.movedim(x, (h_axis, w_axis), at)        # [..., H, W, C]
    *lead, h, w, c = cl.shape
    dtype = cl.dtype
    if kw.get("antialias") and dtype not in (torch.float32, torch.float64):
        cl = cl.float()
    y = F.interpolate(cl.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=tuple(out_hw), **kw)
    y = y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, c).to(dtype)
    y = torch.movedim(y, at, (h_axis, w_axis))
    return y[..., 0] if nd == 2 else y


def resize_bilinear(x: torch.Tensor, out_hw, h_axis: int = -3,
                    w_axis: int = -2) -> torch.Tensor:
    """Bilinear, half-pixel; antialiased on an axis that shrinks."""
    shrinks = (out_hw[0] < x.shape[h_axis]) or (out_hw[1] < x.shape[w_axis])
    return _resize(x, out_hw, h_axis, w_axis, mode="bilinear",
                   align_corners=False, antialias=shrinks)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., 2H, 2W, C] bilinear."""
    h, w = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, (2 * h, 2 * w))


def resize_nearest(x: torch.Tensor, out_hw, h_axis: int = -2,
                   w_axis: int = -1) -> torch.Tensor:
    """Nearest neighbour at the half-pixel centres."""
    return _resize(x, out_hw, h_axis, w_axis, mode="nearest-exact")


def resize_bicubic(x: torch.Tensor, out_hw, h_axis: int = -3,
                   w_axis: int = -2) -> torch.Tensor:
    """Bicubic (Keys, a = -0.5), antialiased, in the input's dtype."""
    return _resize(x, out_hw, h_axis, w_axis, mode="bicubic",
                   align_corners=False, antialias=True)


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool [..., H, W] by an integer factor (torch ``mode='area'``)."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // factor, factor, w // factor, factor)
    return x.mean(dim=(-3, -1))
