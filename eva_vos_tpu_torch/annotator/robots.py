"""Simulated user interactions: clicks and bounding boxes (counterpart of
``eva_vos_tpu/annotator/robots.py``).

Behavior parity targets: ``robots/click_robot.py`` and
``robots/bbox_robot.py``.  These run on the host (connected-component
labeling over error masks): the native C++ union-find (``native``) unless
``EVAVOS_NATIVE=0``, read at each call, then scipy.ndimage's
8-connectivity labeling, which the reference gets from skimage; the two
give identical clicks.  A native library that does not build raises.  All
inputs and outputs are numpy; click coordinates are (x, y) pairs, labels
1=positive, 0=negative.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage

from .. import native
from ..ops.masks import masks_to_boxes

_EIGHT_CONN = np.ones((3, 3), dtype=int)


def _use_native() -> bool:
    return os.environ.get("EVAVOS_NATIVE", "1") != "0"


def _largest_component_click(mask: np.ndarray):
    """Center click (x, y) and size of the largest 8-connected component,
    or (None, 0) when empty.  Native C++ union-find (one fused pass) or
    scipy.ndimage: identical outputs."""
    if _use_native():
        out = native.largest_component_center(mask)
        if out is None:
            return None, 0
        cx, cy, size = out
        return (cx, cy), size
    labels, num = ndimage.label(mask, structure=_EIGHT_CONN)
    if num == 0:
        return None, 0
    sizes = np.bincount(labels.ravel())[1:]
    biggest = int(np.argmax(sizes)) + 1
    ys, xs = np.nonzero(labels == biggest)
    return (int(np.mean(xs)), int(np.mean(ys))), int(sizes.max())


def _snap_to_mask(click_xy, mask: np.ndarray):
    """If the click falls outside ``mask``, move it to the nearest
    in-mask pixel (reference ``click_robot.py:51-55``)."""
    x, y = click_xy
    if mask[y, x]:
        return x, y
    if _use_native():
        out = native.nearest_true(mask, x, y)
        if out is not None:
            return out
    ys, xs = np.nonzero(mask)
    d = (xs - x) ** 2 + (ys - y) ** 2
    i = int(np.argmin(d))
    return int(xs[i]), int(ys[i])


class ClickRobot:
    """Clicks the center of the largest error region.

    ``interact(pred, gt)`` considers the largest false-positive component
    (negative click) and the largest false-negative component (positive
    click, snapped into the gt mask) and keeps whichever error region is
    bigger.  When the prediction is perfect it falls back to the middle
    click.  With ``iou < 0.1`` and a winning negative click, the positive
    click is appended too (the prediction is probably on the wrong object).
    """

    def interact(self, pred_mask, gt_mask, iou: float | None = None):
        pred = np.asarray(pred_mask).squeeze().astype(bool)
        gt = np.asarray(gt_mask).squeeze().astype(bool)

        candidates = []  # (size, click_xy, label)

        fp_click, fp_size = _largest_component_click(pred & ~gt)
        if fp_click is not None:
            candidates.append((fp_size, fp_click, 0))

        fn_click = None
        raw_fn, fn_size = _largest_component_click(~pred & gt)
        if raw_fn is not None:
            fn_click = _snap_to_mask(raw_fn, gt)
            candidates.append((fn_size, fn_click, 1))

        if not candidates:
            return self.middle_click(gt_mask)

        # np.argmax over [fp_size?, fn_size?] in insertion order — first max
        # wins, matching the reference's argmax over components_len.
        best = max(range(len(candidates)), key=lambda i: (candidates[i][0], -i))
        size, click, label = candidates[best]

        clicks = [list(click)]
        labels = [label]
        if iou is not None and iou < 0.1 and label == 0 and fn_click is not None:
            clicks.append(list(fn_click))
            labels = [0, 1]
        return np.array(clicks), np.array(labels)

    def middle_click(self, gt_mask):
        """Median pixel of the object, snapped into the mask."""
        gt = np.asarray(gt_mask).squeeze().astype(bool)
        ys, xs = np.nonzero(gt)
        my = int(np.median(ys))
        mx = int(np.median(xs))
        if not gt[my, mx]:
            d = (xs - mx) ** 2 + (ys - my) ** 2
            i = int(np.argmin(d))
            mx, my = int(xs[i]), int(ys[i])
        return np.array([[mx, my]]), np.array([1])

    def three_pos_clicks(self, gt_mask):
        """First / middle / last nonzero pixels, (x, y) order."""
        gt = np.asarray(gt_mask).squeeze().astype(bool)
        ys, xs = np.nonzero(gt)
        n = len(ys)
        idxs = [0, n // 2, n - 1]
        coords = np.stack([xs[idxs], ys[idxs]], axis=1)
        return coords, np.ones((3,))

    def three_refinement_clicks(self, pred_mask, gt_mask):
        """Centers of the three largest error components (either polarity)."""
        pred = np.asarray(pred_mask).squeeze().astype(bool)
        gt = np.asarray(gt_mask).squeeze().astype(bool)

        clicks, labels, sizes = [], [], []
        for err, lab in ((pred & ~gt, 0), (~pred & gt, 1)):
            comp_labels, num = ndimage.label(err, structure=_EIGHT_CONN)
            if num == 0:
                continue
            comp_sizes = np.bincount(comp_labels.ravel())[1:]
            for ci in np.argsort(-comp_sizes):
                comp = comp_labels == ci + 1
                ys, xs = np.nonzero(comp)
                clicks.append((int(np.mean(xs)), int(np.mean(ys))))
                labels.append(lab)
                sizes.append(int(comp_sizes[ci]))

        order = np.argsort(-np.asarray(sizes))[:3]
        return np.asarray(clicks)[order], np.asarray(labels)[order]


class BboxRobot:
    """Tight bounding box around the ground-truth mask."""

    def interact(self, gt_mask):
        gt = np.asarray(gt_mask)
        gt = gt.squeeze()
        if gt.ndim == 2:
            gt = gt[None]
        return masks_to_boxes(gt)
