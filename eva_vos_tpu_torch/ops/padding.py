"""Pad-to-multiple helpers (counterpart of ``eva_vos_tpu/ops/padding.py``).

Frames and masks are symmetrically zero-padded until H and W are multiples of
16; the pad tuple is ordered ``(lw, uw, lh, uh)`` and the low side gets
``floor(extra / 2)``, as in the reference's ``tensor_util.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Pad = tuple[int, int, int, int]  # (left_w, right_w, top_h, bottom_h)


def compute_pad(h: int, w: int, d: int = 16) -> Pad:
    """Padding that brings (h, w) to multiples of ``d``, split low/high."""
    new_h = h if h % d == 0 else h + d - h % d
    new_w = w if w % d == 0 else w + d - w % d
    lh = (new_h - h) // 2
    uh = (new_h - h) - lh
    lw = (new_w - w) // 2
    uw = (new_w - w) - lw
    return (lw, uw, lh, uh)


def pad_hw(x: torch.Tensor, pad: Pad, h_axis: int = -2,
           w_axis: int = -1) -> torch.Tensor:
    """Zero-pad the H and W axes of ``x`` with a precomputed pad tuple."""
    lw, uw, lh, uh = pad
    widths = [0] * (2 * x.ndim)
    # F.pad lists (low, high) pairs from the LAST axis backwards
    for axis, (lo, hi) in ((h_axis % x.ndim, (lh, uh)),
                           (w_axis % x.ndim, (lw, uw))):
        slot = 2 * (x.ndim - 1 - axis)
        widths[slot], widths[slot + 1] = lo, hi
    return F.pad(x, widths)


def pad_divide_by(x: torch.Tensor, d: int = 16, h_axis: int = -2,
                  w_axis: int = -1):
    """Pad ``x`` so its H/W axes are multiples of ``d``; returns (padded, pad)."""
    h = x.shape[h_axis % x.ndim]
    w = x.shape[w_axis % x.ndim]
    pad = compute_pad(h, w, d)
    return pad_hw(x, pad, h_axis, w_axis), pad


def unpad_hw(x: torch.Tensor, pad: Pad, h_axis: int = -2,
             w_axis: int = -1) -> torch.Tensor:
    """Strip padding applied by :func:`pad_hw`."""
    lw, uw, lh, uh = pad
    h_axis %= x.ndim
    w_axis %= x.ndim
    idx = [slice(None)] * x.ndim
    if lh + uh > 0:
        idx[h_axis] = slice(lh, x.shape[h_axis] - uh)
    if lw + uw > 0:
        idx[w_axis] = slice(lw, x.shape[w_axis] - uw)
    return x[tuple(idx)]
