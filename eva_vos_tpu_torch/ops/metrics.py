"""Segmentation quality metrics: smoothed IoU, boundary F-measure, J&F
(counterpart of ``eva_vos_tpu/ops/metrics.py``; the reference's
``interactions/metrics.py``, itself a port of the davisinteractive boundary
measure).

Two forms of each measure:

* host functions on numpy (``compute_iou``, ``get_j_and_f``, ...), the
  per-frame loop of the reference; the disk dilation is
  ``scipy.ndimage.binary_dilation``;
* ``quality_batch`` / ``j_and_f_batch``: every frame of a video at once on
  the masks' device.  Only integer counts are computed there (intersections,
  unions, boundary pixels and their matches, as int32), and the float64
  divisions happen on the host with the host loop's branches, so the results
  are bit-equal to it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SMOOTH = 1e-6


# ---------------------------------------------------------------------------
# IoU (Jaccard)
# ---------------------------------------------------------------------------

def compute_iou(outputs, labels) -> float:
    """Smoothed IoU over a [B, H, W] batch, averaged (reference ``compute_iou``)."""
    outputs = np.asarray(outputs, dtype=bool)
    labels = np.asarray(labels, dtype=bool)
    assert outputs.ndim == labels.ndim == 3
    inter = np.logical_and(outputs, labels).sum(axis=(1, 2)).astype(np.float64)
    union = np.logical_or(outputs, labels).sum(axis=(1, 2)).astype(np.float64)
    iou = (inter + SMOOTH) / (union + SMOOTH)
    return float(iou.mean())


def binary_jaccard(pred, gt) -> float:
    """Unsmoothed binary Jaccard index (torchmetrics ``JaccardIndex`` binary
    semantics: 0.0 when the union is empty)."""
    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    inter = np.logical_and(pred, gt).sum()
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 0.0
    return float(inter / union)


def compute_multi_class_iou_idx(seg, gt, smooth: float = 1e-6) -> float:
    """seg [H, W] predicted object ids (0 = bg); gt [K, H, W] one-hot.

    Mean smoothed IoU over the K object classes (reference
    ``tensor_util.py:41-50``).
    """
    seg = np.asarray(seg)
    gt = np.asarray(gt)
    k = gt.shape[0]
    total = 0.0
    for ki in range(k):
        pred = seg == (ki + 1)
        g = gt[ki] > 0.5
        inter = np.logical_and(pred, g).sum()
        union = np.logical_or(pred, g).sum()
        total += (inter + smooth) / (union + smooth)
    return float((total + smooth) / (k + smooth))


def compute_multi_class_iou_both_idx(seg, gt, smooth: float = 1e-6) -> float:
    """Both inputs are [H, W] object-id maps (reference
    ``tensor_util.py:52-59``)."""
    seg = np.asarray(seg)
    gt = np.asarray(gt)
    k = int(gt.max())
    total = 0.0
    for ki in range(1, k + 1):
        inter = np.logical_and(seg == ki, gt == ki).sum()
        union = np.logical_or(seg == ki, gt == ki).sum()
        total += (inter + smooth) / (union + smooth)
    return float((total + smooth) / (k + smooth))


def torch_iou(pred: torch.Tensor, gt: torch.Tensor,
              smooth: float = SMOOTH) -> torch.Tensor:
    """Smoothed IoU over the last two axes, on the tensors' device (the JAX
    package's ``jnp_iou``)."""
    pred = pred.bool()
    gt = gt.bool()
    inter = (pred & gt).sum(dim=(-2, -1)).float()
    union = (pred | gt).sum(dim=(-2, -1)).float()
    return (inter + smooth) / (union + smooth)


# ---------------------------------------------------------------------------
# Boundary F-measure
# ---------------------------------------------------------------------------

def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide binary boundary map, boundary pixels offset by half a
    pixel towards the origin (David Martin's convention, as used by DAVIS)."""
    seg = np.asarray(seg, dtype=bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def disk(radius: int) -> np.ndarray:
    """Flat disk structuring element (skimage.morphology.disk semantics)."""
    radius = int(radius)
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x ** 2 + y ** 2 <= radius ** 2).astype(np.uint8)


def _dilate(binary: np.ndarray, selem: np.ndarray) -> np.ndarray:
    """Binary dilation with zeros beyond the border (``cv2.dilate``'s
    default border, which the JAX package takes where cv2 is installed)."""
    from scipy import ndimage

    return ndimage.binary_dilation(
        binary, structure=selem.astype(bool)).astype(np.uint8)


def f_measure(true_mask, pred_mask, bound_th: float = 0.008) -> float:
    """Boundary F-measure between two 2D masks (davisinteractive semantics)."""
    true_mask = np.asarray(true_mask, dtype=bool)
    pred_mask = np.asarray(pred_mask, dtype=bool)
    assert true_mask.shape == pred_mask.shape

    bound_pix = bound_th if bound_th >= 1 else np.ceil(bound_th * np.linalg.norm(true_mask.shape))

    fg_boundary = seg2bmap(pred_mask)
    gt_boundary = seg2bmap(true_mask)

    selem = disk(bound_pix)
    fg_dil = _dilate(fg_boundary, selem)
    gt_dil = _dilate(gt_boundary, selem)

    gt_match = gt_boundary * fg_dil
    fg_match = fg_boundary * gt_dil

    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()

    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = float(fg_match.sum()) / float(n_fg)
        recall = float(gt_match.sum()) / float(n_gt)

    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def get_j_and_f(gt_mask, pred_mask) -> float:
    """0.5 * Jaccard + 0.5 * boundary-F for [1, H, W] (or [H, W]) masks."""
    gt = np.asarray(gt_mask, dtype=bool)
    pred = np.asarray(pred_mask, dtype=bool)
    if gt.ndim == 3:
        gt2, pred2 = gt.squeeze(0), pred.squeeze(0)
    else:
        gt2, pred2 = gt, pred
    j = binary_jaccard(pred, gt)
    f = f_measure(gt2, pred2)
    return 0.5 * j + 0.5 * f


# ---------------------------------------------------------------------------
# Every frame at once on the device (exact): integer counts on the device,
# float64 assembly on the host.  The host loop runs seg2bmap and a dilation
# per frame; here one set of shifted XORs gives every frame's boundary map
# and one convolution with the disk dilates them all.
# ---------------------------------------------------------------------------

def _seg2bmap(seg: torch.Tensor) -> torch.Tensor:
    """Batched seg2bmap: seg [T, H, W] bool -> boundary maps [T, H, W]."""
    e = torch.zeros_like(seg)
    s = torch.zeros_like(seg)
    se = torch.zeros_like(seg)
    e[:, :, :-1] = seg[:, :, 1:]
    s[:, :-1, :] = seg[:, 1:, :]
    se[:, :-1, :-1] = seg[:, 1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[:, -1, :] = seg[:, -1, :] ^ e[:, -1, :]
    b[:, :, -1] = seg[:, :, -1] ^ s[:, :, -1]
    b[:, -1, -1] = False
    return b


def _dilate_batch(b: torch.Tensor, selem: np.ndarray) -> torch.Tensor:
    """Zero-padded binary dilation of [T, H, W] bool by a [k, k] 0/1
    structuring element: one convolution of the 0/1 maps with it, > 0.5.
    Its true sums are integers of at most k * k; the half-way threshold
    keeps the result exact whatever algorithm the convolution takes (an
    FFT or Winograd one leaves residues of ~1e-7 where the sum is 0) and
    with TF32 on."""
    k = selem.shape[0]
    kern = torch.as_tensor(selem, dtype=torch.float32,
                           device=b.device)[None, None]     # [1, 1, k, k]
    y = F.conv2d(b.float()[:, None], kern, padding=k // 2)
    return y[:, 0] > 0.5


def _jf_counts(gt: torch.Tensor, pred: torch.Tensor,
               bound_pix: int) -> torch.Tensor:
    """Batched integer counts for J and boundary-F.

    gt/pred [T, H, W] bool -> [T, 6] int32:
    (inter, union, n_fg, n_gt, fg_match, gt_match).
    """
    inter = (gt & pred).sum(dim=(1, 2), dtype=torch.int32)
    union = (gt | pred).sum(dim=(1, 2), dtype=torch.int32)
    fg_b = _seg2bmap(pred)
    gt_b = _seg2bmap(gt)
    selem = disk(bound_pix)
    fg_dil = _dilate_batch(fg_b, selem)
    gt_dil = _dilate_batch(gt_b, selem)
    n_fg = fg_b.sum(dim=(1, 2), dtype=torch.int32)
    n_gt = gt_b.sum(dim=(1, 2), dtype=torch.int32)
    fg_match = (fg_b & gt_dil).sum(dim=(1, 2), dtype=torch.int32)
    gt_match = (gt_b & fg_dil).sum(dim=(1, 2), dtype=torch.int32)
    return torch.stack([inter, union, n_fg, n_gt, fg_match, gt_match], dim=1)


def _iou_counts(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    inter = (gt & pred).sum(dim=(1, 2), dtype=torch.int32)
    union = (gt | pred).sum(dim=(1, 2), dtype=torch.int32)
    return torch.stack([inter, union], dim=1)


def _as_bool_tensor(x, device) -> torch.Tensor:
    """bool tensor; a tensor stays on its device (sessions keep their gt
    stack there), anything else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.bool()
    return torch.as_tensor(np.asarray(x, dtype=bool), device=device)


def quality_batch(gt_masks, pred_masks, metric: str, device="cuda"):
    """Batched per-frame quality, bit-equal to the host loop:
    metric 'j' -> ``compute_iou(pred[None], gt[None])`` per frame (smoothed
    IoU); 'j_and_f' -> ``get_j_and_f``.  Counts on the device (the inputs'
    own when they are tensors), float64 on the host.
    """
    if metric == "j_and_f":
        return j_and_f_batch(gt_masks, pred_masks, device=device)
    gt = _as_bool_tensor(gt_masks, device)
    pred = _as_bool_tensor(pred_masks, device)
    counts = _iou_counts(gt, pred).cpu().numpy().astype(np.float64)
    return (counts[:, 0] + SMOOTH) / (counts[:, 1] + SMOOTH)


def j_and_f_batch(gt_masks, pred_masks, bound_th: float = 0.008,
                  device="cuda"):
    """Batched exact J&F: gt/pred [T, H, W] (bool-like) -> [T] floats equal
    to ``get_j_and_f(gt[t][None], pred[t][None])`` for every t."""
    gt = _as_bool_tensor(gt_masks, device)
    pred = _as_bool_tensor(pred_masks, device)
    assert gt.shape == pred.shape and gt.ndim == 3
    h, w = gt.shape[1:]
    bound_pix = bound_th if bound_th >= 1 else int(
        np.ceil(bound_th * np.linalg.norm((h, w))))
    counts = _jf_counts(gt, pred, int(bound_pix)).cpu().numpy()
    out = []
    for inter, union, n_fg, n_gt, fg_match, gt_match in counts:
        j = 0.0 if union == 0 else float(inter) / float(union)
        if n_fg == 0 and n_gt > 0:
            precision, recall = 1.0, 0.0
        elif n_fg > 0 and n_gt == 0:
            precision, recall = 0.0, 1.0
        elif n_fg == 0 and n_gt == 0:
            precision, recall = 1.0, 1.0
        else:
            precision = float(fg_match) / float(n_fg)
            recall = float(gt_match) / float(n_gt)
        f = (0.0 if precision + recall == 0
             else 2.0 * precision * recall / (precision + recall))
        out.append(0.5 * j + 0.5 * f)
    return np.asarray(out, dtype=np.float64)
