"""The simulated annotator: orchestrates SAM + click/bbox robots.

Behavior parity target: ``annotator/annotator.py`` in the reference:

* ``get_mask('mask', ...)``  -> ground truth at 80 s; empty gt -> 3 s with
  the quality token 20.
* ``get_mask('click', ...)`` -> warm-start SAM to reproduce the current
  propagated (MiVOS) mask (middle click + up to 20 refinement clicks until
  IoU > 0.8, ``create_similar_samlogits``), then ``num_prompts`` click
  rounds, each keeping the best of SAM's multimask outputs by gt-IoU and
  accumulating prompts; cost = clicks * 1.5 s + 1 s overhead.
* ``get_mask('bbox', ...)``  -> box first (7 s) then refinement clicks.
* prompt_type 'a' = fresh prompts each time, 'b' = logits only,
  'c' = previous prompts + new prompts (default).

The SAM controller is injected: ``SAMController`` over the port's
``SamPredictor`` in production, :class:`FakeSAMController` in tests.  With
a controller that has it, the selection among SAM's masks
(``predict_select``) runs on the device.  The warm start is the host loop
(the scipy robot, one decode a click); ``device_warmstart=True`` takes the
controller's ``warmstart_select`` instead, with the robot on the device,
which is slower on the H100 (``PERF.md``).  Either gives the host path's
episodes exactly.  This is the counterpart of
``eva_vos_tpu/annotator/annotator.py``.
"""

from __future__ import annotations

import numpy as np

from .robots import ClickRobot, BboxRobot
from ..ops.metrics import compute_iou
from ..ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from ..utils.costs import ANNOTATION_COSTS

SIMILAR_IOU_THRESHOLD = 0.8
MAX_WARMSTART_TRIES = 20
EMPTY_GT_TOKEN = 20


def denormalize_to_uint8(im) -> np.ndarray:
    """[H, W, 3] ImageNet-normalized -> uint8 RGB (reference ``inv_im_trans``)."""
    im = np.asarray(im, dtype=np.float32)
    im = im * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(im, 0.0, 1.0) * 255).astype(np.uint8)


class Annotator:
    def __init__(self, sam_controller, prompt_type: str = "c",
                 cache_embeddings: bool = True,
                 device_warmstart: bool = False):
        assert prompt_type in {"a", "b", "c"}
        self.sam = sam_controller
        self.device_warmstart = device_warmstart
        self.click_robot = ClickRobot()
        self.bbox_robot = BboxRobot()
        self.prompt_type = prompt_type
        # per-frame SAM embedding cache: the same frame is re-embedded on
        # every re-annotation round in the reference
        # (``mulitple_annotations.py:291`` + ``annotator.py:30-36``); the
        # encoder is deterministic per frame, so caching is a pure win.
        # Keys are caller-chosen (the loops use the frame index and clear
        # per video).
        self.cache_embeddings = cache_embeddings and hasattr(
            sam_controller, "export_embedding_state")
        self._embed_cache = {}

    # ------------------------------------------------------------------
    def clear_sam_cache(self):
        """Drop cached embeddings (call between videos — keys are per-video
        frame indices)."""
        self._embed_cache.clear()

    def set_image_to_sam(self, im, cache_key=None):
        """im: [H, W, 3] normalized float image (channel-last)."""
        if cache_key is not None and self.cache_embeddings:
            hit = self._embed_cache.get(cache_key)
            if hit is not None:
                self.sam.restore_embedding_state(hit)
                return
        self.sam.reset_image()
        self.sam.set_image(denormalize_to_uint8(im))
        if cache_key is not None and self.cache_embeddings:
            self._embed_cache[cache_key] = self.sam.export_embedding_state()

    def best_sam_mask(self, sam_masks, target_mask):
        """Highest-IoU output; first strict improvement wins, index -1 when
        every candidate has zero IoU (reference ``annotator.py:38-57``)."""
        target = np.asarray(target_mask).squeeze()[None].astype(bool)
        mask_idx, max_iou = -1, 0.0
        for ii, gen in enumerate(np.asarray(sam_masks)):
            iou = compute_iou(np.asarray(gen, dtype=bool), target)
            if iou > max_iou:
                mask_idx, max_iou = ii, iou
        return max_iou, mask_idx

    def _predict_best(self, target, click_coords=None, click_labels=None,
                      bbox=None, mask_input=None):
        """One decode round + best-of-multimask selection vs ``target``.

        Uses the controller's ``predict_select`` when it has one (the
        selection on the device, the logits left there for the next
        round).  Returns ``(mask [1, H, W], max_iou, logits [1, low, low])``
        with the semantics of ``predict`` + :meth:`best_sam_mask`.
        """
        ps = getattr(self.sam, "predict_select", None)
        if ps is not None:
            mask, max_iou, _, low = ps(
                target, click_coords=click_coords,
                click_labels=click_labels, bbox=bbox, mask_input=mask_input)
            return np.asarray(mask)[None], max_iou, low[None]
        masks, _, logits = self.sam.predict(
            click_coords=click_coords, click_labels=click_labels, bbox=bbox,
            mask_input=mask_input, multimask_output=True)
        max_iou, idx = self.best_sam_mask(masks, target)
        return np.asarray(masks[idx]), max_iou, logits[idx][None]

    def create_similar_samlogits(self, pred_mask):
        """Warm-start SAM so its logits reproduce the propagated mask."""
        pred = np.asarray(pred_mask).squeeze().astype(bool)
        if pred.sum() == 0:
            return None, None, None, None

        # the chain with the click robot on the device, on request: the host
        # loop's episode (tests/test_torch_port_sam.py::TestWarmstartChainParity)
        if self.device_warmstart:
            ok, logits, mask, clicks, labels = self.sam.warmstart_select(
                pred, threshold=SIMILAR_IOU_THRESHOLD,
                max_tries=MAX_WARMSTART_TRIES)
            if not ok:
                return None, None, None, None
            return logits[None], mask[None], clicks, labels

        clicks, labels = self.click_robot.middle_click(pred)
        best_mask, max_iou, best_logits = self._predict_best(
            pred, click_coords=clicks, click_labels=labels)
        if max_iou > SIMILAR_IOU_THRESHOLD:
            return best_logits, best_mask, clicks, labels

        prev_clicks, prev_labels = clicks, labels

        for _ in range(MAX_WARMSTART_TRIES):
            new_clicks, new_labels = self.click_robot.interact(best_mask, pred)
            prompt_clicks = np.concatenate([prev_clicks, new_clicks], 0)
            prompt_labels = np.concatenate([prev_labels, new_labels], 0)
            best_mask, max_iou, best_logits = self._predict_best(
                pred, click_coords=prompt_clicks,
                click_labels=prompt_labels, mask_input=best_logits)
            prev_clicks, prev_labels = prompt_clicks, prompt_labels
            if max_iou > SIMILAR_IOU_THRESHOLD:
                return best_logits, best_mask, prompt_clicks, prompt_labels
        return None, None, None, None

    # ------------------------------------------------------------------
    def get_mask(self, annotation_type, gt_mask, im=None, num_prompts=1,
                 mivos_mask=None, prev_iter_data=None, cache_key=None):
        """Returns (mask [1?, H, W] bool-ish, cost_s, quality, sam_logits,
        prompt_clicks, prompt_labels, bbox)."""
        assert annotation_type in {"mask", "click", "bbox"}
        gt = np.asarray(gt_mask)

        if gt.sum() == 0:
            return gt, ANNOTATION_COSTS["no_object"], EMPTY_GT_TOKEN, None, None, None, None
        if annotation_type == "mask":
            return gt, ANNOTATION_COSTS["mask"], 1, None, None, None, None

        self.set_image_to_sam(im, cache_key=cache_key)
        gt_bool = gt.astype(bool)
        if annotation_type == "click":
            return self._click_rounds(gt_bool, num_prompts, mivos_mask,
                                      prev_iter_data)
        return self._bbox_rounds(gt_bool, num_prompts, mivos_mask, prev_iter_data)

    def _resolve_prompts(self, mivos_mask, prev_iter_data):
        """Previous-round prompts or a fresh warm start (``get_prompts``)."""
        if prev_iter_data is None or prev_iter_data.get("sam_logits") is None:
            bbox = None
            if self.prompt_type in {"b", "c"} and mivos_mask is not None:
                sam_logits, sam_mask, clicks, labels = \
                    self.create_similar_samlogits(mivos_mask)
            else:
                sam_logits, sam_mask, clicks, labels = None, None, None, None
        else:
            sam_mask = mivos_mask
            clicks = prev_iter_data["click_coords"]
            labels = prev_iter_data["click_labels"]
            sam_logits = prev_iter_data["sam_logits"]
            bbox = prev_iter_data["bbox"]

        if self.prompt_type == "b":
            clicks, labels, bbox = None, None, None
        return sam_logits, sam_mask, clicks, labels, bbox

    def _click_rounds(self, gt, num_clicks, mivos_mask, prev_iter_data):
        cost = 0.0
        curr_iou = 0.0
        sam_logits, sam_mask, prev_clicks, prev_labels, bbox = \
            self._resolve_prompts(mivos_mask, prev_iter_data)

        prompt_clicks, prompt_labels = prev_clicks, prev_labels
        for _ in range(num_clicks):
            if prev_clicks is None:
                if sam_mask is None:
                    prompt_clicks, prompt_labels = self.click_robot.middle_click(gt)
                else:
                    prompt_clicks, prompt_labels = self.click_robot.interact(sam_mask, gt)
                cost += ANNOTATION_COSTS["click"]
            else:
                new_clicks, new_labels = self.click_robot.interact(sam_mask, gt)
                cost += len(new_labels) * ANNOTATION_COSTS["click"]
                prompt_clicks = np.concatenate([prev_clicks, new_clicks], 0)
                prompt_labels = np.concatenate([prev_labels, new_labels], 0)

            sam_mask, curr_iou, sam_logits = self._predict_best(
                gt, click_coords=prompt_clicks, click_labels=prompt_labels,
                bbox=bbox, mask_input=sam_logits)
            prev_clicks, prev_labels = prompt_clicks, prompt_labels

        cost += ANNOTATION_COSTS["click_overhead"]
        return sam_mask, cost, curr_iou, sam_logits, prompt_clicks, prompt_labels, bbox

    def _bbox_rounds(self, gt, prompts, mivos_mask, prev_iter_data):
        cost = 0.0
        curr_iou = 0.0
        sam_logits, sam_mask, prev_clicks, prev_labels, prev_box = \
            self._resolve_prompts(mivos_mask, prev_iter_data)
        assert prev_box is None, "bbox rounds cannot resume from a prior box"

        new_clicks_used = False
        bbox = None
        prompt_clicks, prompt_labels = prev_clicks, prev_labels
        for ii in range(prompts):
            if ii == 0:
                bbox = self.bbox_robot.interact(gt)
                cost += ANNOTATION_COSTS["bbox"]
            else:
                new_clicks_used = True
                new_clicks, new_labels = self.click_robot.interact(sam_mask, gt)
                cost += len(new_labels) * ANNOTATION_COSTS["click"]
                if prompt_labels is None:
                    prompt_clicks, prompt_labels = new_clicks, new_labels
                else:
                    prompt_clicks = np.concatenate([prompt_clicks, new_clicks], 0)
                    prompt_labels = np.concatenate([prompt_labels, new_labels], 0)

            sam_mask, curr_iou, sam_logits = self._predict_best(
                gt, click_coords=prompt_clicks, click_labels=prompt_labels,
                bbox=bbox, mask_input=sam_logits)

        if new_clicks_used:
            cost += ANNOTATION_COSTS["click_overhead"]
        return sam_mask, cost, curr_iou, sam_logits, prompt_clicks, prompt_labels, bbox
