"""Predictor with the official ``SamPredictor`` contract, plus the
reference's controller facade (counterpart of
``eva_vos_tpu/models/sam/predictor.py``).

* official predictor semantics: longest-side resize to ``img_size``, pixel
  normalisation, bottom-right padding, coordinate transforms, multimask
  selection, low-res logits fed back as ``mask_input``, threshold 0.0;
* ``sam/sam_controller.py`` in the reference: ``set_image`` embeds once,
  ``reset_image``, ``predict(click_coords, click_labels, bbox, mask_input,
  multimask_output)`` -> (masks [n, 1, H, W], scores, logits [n, 256, 256]).

Resizes: ``set_image`` grows the frame to the input size and
``postprocess_masks`` grows the low-res logits to ``img_size``, crops and
shrinks them to the frame; both use the port's ``resize_bilinear``, which
antialiases on the shrink as ``jax.image.resize`` does (the official SAM
does not; pixels near the 0 threshold would move).

``features`` is the embedding, ``[S, S, 256]`` channel-last, on the device.
Prompts are padded to ``max_points`` slots.  ``predict_select`` and
``warmstart_select`` keep the selection among SAM's masks on the device:
the smoothed-IoU order is exact in int64 (frames of up to
``MAX_SELECT_PIXELS``), a later candidate winning only on a strict
improvement, and a call's host reads are the counts, the index and the
chosen mask.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .build import PIXEL_MEAN, PIXEL_STD, Sam
from .prompt_encoder import NOT_A_POINT, PAD_LABEL
from ...ops.components import click_robot_interact, middle_click
from ...ops.metrics import SMOOTH
from ...ops.resize import resize_bilinear

MASK_THRESHOLD = 0.0
# 1 / SMOOTH as an integer, and the largest frame (in pixels) whose IoU
# cross product, scaled by it, stays within int64
_INV_SMOOTH = round(1 / SMOOTH)
MAX_SELECT_PIXELS = 3_000_000
# images a pass of the batched encode: ViT-H's global attention holds three
# [16, 4096, 4096] fp32 tensors an image (scores, rel-pos sum, softmax: 3.2
# GB), so a 40-image fleet in one pass would need ~130 GB.  ViT has no batch
# statistics, and with one image a pass each embedding is set_image's.
ENCODE_CHUNK = 1


def get_preprocess_shape(oldh: int, oldw: int, long_side: int):
    scale = long_side * 1.0 / max(oldh, oldw)
    newh, neww = oldh * scale, oldw * scale
    return int(newh + 0.5), int(neww + 0.5)


def _better(ia, ua, ib, ub):
    """Smoothed IoU (ia + s) / (ua + s) > (ib + s) / (ub + s), exactly, for
    int64 pixel counts: multiplied out and divided by s, the integer test
    (ia * ub - ib * ua) / s + (ia + ub) - (ib + ua) > 0, in range for frames
    of up to MAX_SELECT_PIXELS."""
    return ((ia * ub - ib * ua) * _INV_SMOOTH
            + (ia + ub) - (ib + ua)) > 0


class SamPredictor:
    def __init__(self, sam: Sam, max_points: int = 64):
        self.sam = sam
        self.cfg = sam.config
        self.max_points = max_points
        self.device = sam.image_encoder.pos_embed.device
        # the device copy of the last target of predict_select: the warm
        # start and the click rounds pass the same host array again
        self._tgt_cache = None       # (host array, device bool tensor)
        self.reset_image()

    # ------------------------------------------------------------------
    def reset_image(self):
        self.features = None
        self.original_size = None
        self.input_size = None
        self.is_image_set = False

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [N, H, W, 3] on the device -> normalised, resized, padded
        [N, img, img, 3] float32."""
        h, w = images.shape[1:3]
        newh, neww = get_preprocess_shape(h, w, self.cfg.img_size)
        x = resize_bilinear(images.float(), (newh, neww))
        mean = torch.tensor(PIXEL_MEAN, device=x.device)
        std = torch.tensor(PIXEL_STD, device=x.device)
        x = (x - mean) / std
        return torch.nn.functional.pad(
            x, (0, 0, 0, self.cfg.img_size - neww, 0, self.cfg.img_size - newh))

    def set_image(self, image: np.ndarray):
        """image: uint8 RGB [H, W, 3]."""
        assert image.ndim == 3 and image.shape[2] == 3
        self.original_size = tuple(image.shape[:2])
        self.input_size = get_preprocess_shape(*self.original_size,
                                               self.cfg.img_size)
        x = torch.as_tensor(np.ascontiguousarray(image), device=self.device)
        self.features = self.sam.encode_image(self._preprocess(x[None]))[0]
        self.is_image_set = True

    def get_image_embedding(self) -> np.ndarray:
        """[256, S, S] channel-first on the host, as the official API."""
        assert self.is_image_set
        return self.features.float().permute(2, 0, 1).cpu().numpy()

    # ------------------------------------------------------------------
    def _transform_coords(self, coords):
        oldh, oldw = self.original_size
        newh, neww = self.input_size
        c = np.asarray(coords, np.float32).copy()
        c[..., 0] *= np.float32(neww / oldw)
        c[..., 1] *= np.float32(newh / oldh)
        return c

    def _build_prompts(self, point_coords, point_labels, box):
        coords = np.zeros((self.max_points, 2), np.float32)
        labels = np.full((self.max_points,), PAD_LABEL, np.int64)
        n = 0
        if point_coords is not None:
            pts = self._transform_coords(point_coords)
            k = len(pts)
            assert k + 3 <= self.max_points, (
                f"too many prompt points ({k}) for max_points="
                f"{self.max_points}")
            coords[:k] = pts
            labels[:k] = np.asarray(point_labels, np.int64)
            n = k
            if box is None:
                # the official predictor pads points with a not-a-point
                labels[n] = NOT_A_POINT
                n += 1
        if box is not None:
            coords[n:n + 2] = self._transform_coords(
                np.asarray(box, np.float32).reshape(2, 2))
            labels[n:n + 2] = (2, 3)
        return coords, labels

    def _mask_input(self, mask_input):
        """(low-res logits [low, low] on the device, has_mask)."""
        low = self.cfg.low_res
        if mask_input is None:
            return torch.zeros((low, low), device=self.device), False
        if isinstance(mask_input, torch.Tensor):
            m = mask_input.to(self.device).float()
        else:
            m = torch.tensor(np.asarray(mask_input, np.float32),
                             device=self.device)
        return m.reshape(m.shape[-2:]), True

    def _decode(self, coords, labels, mask_input):
        m, has_mask = self._mask_input(mask_input)
        return self.sam.decode(
            self.features, torch.as_tensor(coords, device=self.device),
            torch.as_tensor(labels, device=self.device), m, has_mask)

    def postprocess_masks(self, low_res_masks: torch.Tensor) -> torch.Tensor:
        """[n, low, low] logits -> [n, H, W] logits at the original size:
        grown to img_size, cropped to the input size, shrunk (antialiased)
        to the frame."""
        img = self.cfg.img_size
        up = resize_bilinear(low_res_masks.float(), (img, img),
                             h_axis=-2, w_axis=-1)
        up = up[:, :self.input_size[0], :self.input_size[1]]
        return resize_bilinear(up, self.original_size, h_axis=-2, w_axis=-1)

    @staticmethod
    def _selection(multimask_output: bool) -> slice:
        return slice(1, None) if multimask_output else slice(0, 1)

    def predict(self, point_coords=None, point_labels=None, box=None,
                mask_input=None, multimask_output: bool = True,
                return_logits: bool = False):
        """Returns (masks [n, H, W] bool, iou_predictions [n],
        low_res_logits [n, low, low]) on the host, as the official
        predictor."""
        assert self.is_image_set, "set_image must be called before predict"
        coords, labels = self._build_prompts(point_coords, point_labels, box)
        all_masks, all_iou = self._decode(coords, labels, mask_input)
        sel = self._selection(multimask_output)
        low = all_masks[sel]
        masks = self.postprocess_masks(low)
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        return (masks.cpu().numpy(), all_iou[sel].cpu().numpy(),
                low.cpu().numpy())

    # ------------------------------------------------------------------
    # decode + best-mask selection on the device
    # ------------------------------------------------------------------
    def _target(self, target_mask) -> torch.Tensor:
        if isinstance(target_mask, torch.Tensor):
            return target_mask.to(self.device).bool()
        cached = self._tgt_cache
        if cached is not None and cached[0] is target_mask:
            return cached[1]
        tgt = torch.as_tensor(np.asarray(target_mask).squeeze().astype(bool),
                              device=self.device)
        self._tgt_cache = (target_mask, tgt)
        return tgt

    def _decode_select(self, coords, labels, mask_input, tgt, sel):
        """Decode, threshold at the frame's size, and pick the first mask of
        the highest smoothed IoU against ``tgt``: (inter, union, index,
        mask [H, W] bool, low-res logits [low, low]), all on the device."""
        h, w = self.original_size
        assert h * w <= MAX_SELECT_PIXELS, (
            f"a {h}x{w} frame is too large for the exact IoU order")
        all_masks, _ = self._decode(coords, labels, mask_input)
        low = all_masks[sel]
        pred = self.postprocess_masks(low) > MASK_THRESHOLD
        inter = (pred & tgt).sum(dim=(1, 2))
        union = (pred | tgt).sum(dim=(1, 2))
        bi, bu = inter[0], union[0]
        idx = torch.zeros((), dtype=torch.int64, device=self.device)
        for k in range(1, pred.shape[0]):
            better = _better(inter[k], union[k], bi, bu)
            bi = torch.where(better, inter[k], bi)
            bu = torch.where(better, union[k], bu)
            idx = torch.where(better, k, idx)
        return bi, bu, idx, pred[idx], low[idx]

    def predict_select(self, target_mask, point_coords=None,
                       point_labels=None, box=None, mask_input=None,
                       multimask_output: bool = True):
        """``predict`` + the reference's ``best_sam_mask`` with the
        selection on the device.  Returns ``(mask [H, W] bool, max_iou,
        idx, low_res_logits [low, low])``: the logits stay on the device for
        the next round's ``mask_input``, and ``max_iou`` is the float64
        smoothed IoU of the host's ``compute_iou``.  ``target_mask`` is a
        host array (uploaded once while the same object comes back) or a
        tensor."""
        assert self.is_image_set, "set_image must be called before predict"
        coords, labels = self._build_prompts(point_coords, point_labels, box)
        bi, bu, idx, mask, low = self._decode_select(
            coords, labels, mask_input, self._target(target_mask),
            self._selection(multimask_output))
        bi, bu, idx = torch.stack([bi, bu, idx]).tolist()
        max_iou = float((np.float64(bi) + SMOOTH) / (np.float64(bu) + SMOOTH))
        return mask.cpu().numpy(), max_iou, int(idx), low

    # ------------------------------------------------------------------
    # the warm-start chain on the device
    # ------------------------------------------------------------------
    def warmstart_select(self, pred_mask, threshold: float = 0.8,
                         max_tries: int = 20):
        """The reference warm start (``annotator.py:60-107``) with the click
        robot on the device: middle click -> decode -> best of 3 -> a
        refinement click -> decode ... until the smoothed IoU exceeds
        ``threshold`` or ``max_tries`` refinements.  One small host read a
        decode decides the stop, as the exact integer test
        q * inter - p * union >= 0 for threshold p / q (the smoothing term
        only breaks ties at the boundary upwards).

        Returns ``(ok, low_res_logits [low, low] on the device, mask [H, W]
        bool, clicks [n, 2] float64, labels [n])``, the host loop's episode;
        ``ok`` False (and Nones) where the host loop gives up."""
        assert self.is_image_set
        frac = Fraction(str(threshold))
        p, q = frac.numerator, frac.denominator
        assert p < q, "warm-start threshold must be < 1"
        assert max_tries + 4 <= self.max_points
        tgt = self._target(pred_mask)
        sel = self._selection(True)
        clicks = [torch.stack(middle_click(tgt)).tolist()]
        labels = [1]
        low = None
        for t in range(max_tries + 1):
            if t:
                x, y, lab = torch.stack(
                    click_robot_interact(best, tgt)).tolist()
                clicks.append([x, y])
                labels.append(lab)
            coords, lab_arr = self._build_prompts(np.asarray(clicks),
                                                  np.asarray(labels), None)
            bi, bu, _, best, low = self._decode_select(coords, lab_arr, low,
                                                       tgt, sel)
            if bool(q * bi - p * bu >= 0):
                return (True, low, best.cpu().numpy(),
                        np.asarray(clicks, np.float64),
                        np.asarray(labels, np.int64))
        return False, None, None, None, None

    # ------------------------------------------------------------------
    # batched paths (the vectorised PPO environments)
    # ------------------------------------------------------------------
    def encode_images(self, images, chunk: int = ENCODE_CHUNK) -> torch.Tensor:
        """N uint8 RGB images of one size -> features [N, S, S, 256],
        encoded ``chunk`` images a pass."""
        sizes = {im.shape[:2] for im in images}
        assert len(sizes) == 1, "batched encode requires equal image sizes"
        x = torch.as_tensor(np.stack(images), device=self.device)
        return torch.cat([self.sam.encode_image(self._preprocess(x[i:i + chunk]))
                          for i in range(0, len(x), chunk)])

    def predict_batch(self, features, original_size, prompts,
                      multimask_output: bool = True):
        """Decode N prompt sets against N embeddings [N, S, S, 256] (one
        frame size).  prompts: dicts with optional point_coords /
        point_labels / box / mask_input in original pixels.  Returns per
        item (masks [n, H, W] bool, iou [n], low_res [n, low, low])."""
        self.original_size = tuple(original_size)
        self.input_size = get_preprocess_shape(*original_size,
                                               self.cfg.img_size)
        sel = self._selection(multimask_output)
        out = []
        for feats, pr in zip(features, prompts):
            coords, labels = self._build_prompts(
                pr.get("point_coords"), pr.get("point_labels"), pr.get("box"))
            m, has_mask = self._mask_input(pr.get("mask_input"))
            all_masks, all_iou = self.sam.decode(
                feats, torch.as_tensor(coords, device=self.device),
                torch.as_tensor(labels, device=self.device), m, has_mask)
            low = all_masks[sel]
            masks = self.postprocess_masks(low) > MASK_THRESHOLD
            out.append((masks.cpu().numpy(), all_iou[sel].cpu().numpy(),
                        low.cpu().numpy()))
        return out


class SAMController:
    """Reference-API facade (``sam/sam_controller.py``) over the predictor."""

    def __init__(self, predictor: SamPredictor, verbose: bool = False):
        self.predictor = predictor
        self.embedded = False
        if verbose:
            print("Initializing the PyTorch SAM")

    def set_image(self, image: np.ndarray):
        if self.embedded:
            print("repeat embedding, please reset_image.")
            return
        self.predictor.set_image(image)
        self.embedded = True

    def reset_image(self):
        self.predictor.reset_image()
        self.embedded = False

    def get_image_embedding(self) -> np.ndarray:
        return self.predictor.get_image_embedding()

    def export_embedding_state(self):
        """The embedding on the device and the size bookkeeping: a frame's
        later rounds restore it instead of running the encoder again."""
        assert self.embedded
        p = self.predictor
        return (p.features, p.original_size, p.input_size)

    def restore_embedding_state(self, state):
        p = self.predictor
        p.features, p.original_size, p.input_size = state
        p.is_image_set = True
        self.embedded = True

    def predict(self, click_coords=None, click_labels=None, bbox=None,
                mask_input=None, multimask_output=True):
        assert self.embedded, "prediction called before set_image"
        masks, scores, logits = self.predictor.predict(
            point_coords=click_coords, point_labels=click_labels, box=bbox,
            mask_input=mask_input, multimask_output=multimask_output)
        return masks[:, None], scores, logits             # [n, 1, H, W]

    def predict_select(self, target_mask, click_coords=None,
                       click_labels=None, bbox=None, mask_input=None,
                       multimask_output=True):
        """Decode + the best mask against a target, on the device (see
        ``SamPredictor.predict_select``)."""
        assert self.embedded, "prediction called before set_image"
        return self.predictor.predict_select(
            target_mask, point_coords=click_coords,
            point_labels=click_labels, box=bbox, mask_input=mask_input,
            multimask_output=multimask_output)

    def warmstart_select(self, pred_mask, threshold: float = 0.8,
                         max_tries: int = 20):
        """The warm-start chain with the click robot on the device (see
        ``SamPredictor.warmstart_select``)."""
        assert self.embedded, "prediction called before set_image"
        return self.predictor.warmstart_select(
            pred_mask, threshold=threshold, max_tries=max_tries)
