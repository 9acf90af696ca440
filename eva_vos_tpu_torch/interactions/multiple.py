"""Multi-annotation-type policies, clicks / bbox / mask per round
(counterpart of ``eva_vos_tpu/interactions/multiple.py``).

Behavior parity target: ``interactions/mulitple_annotations.py`` — the
reward function, the annotation-type grammar ('Nclicks'), the oracle /
random / RL-agent type selectors, and the four round loops
(``oracle_oracle``, ``rand_type``, ``rand_rand``, ``eva_vos``).

``gen_masks`` lies on the engine's device; the annotator works on the host,
so each annotated frame's mask comes to the host alone.  Besides the
session's ``propagate`` and ``eval`` spans, a round's ``annotate`` (the
type choice and the annotation) and ``choice`` (the next frame) are timed
on its ``WallClock``.
"""

from __future__ import annotations

import re
from copy import deepcopy

import numpy as np
import torch

from .eval import (Session, as_host, initialize, eval_session_metric,
                   not_avail_frames, EMPTY_GT_TOKEN)
from .policies import qnet_frame_selection, frames_to_224, masks_to_224_3ch
from ..ops.metrics import compute_iou
from ..ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from ..utils.costs import ANNOTATION_COSTS


def reward_func(iou, cost, init_iou):
    return (iou - init_iou) / cost


def ann_type_to_annotator_input(annot_type: str):
    """'click' / 'bbox' / 'mask' / 'Nclicks' -> (annotator type, num prompts)."""
    if annot_type == "click":
        return "click", 1
    if annot_type == "bbox":
        return "bbox", 1
    if re.match(r"^\d+clicks$", annot_type):
        return "click", int(annot_type.split("clicks")[0])
    if annot_type == "mask":
        return "mask", 1
    raise AttributeError(f"{annot_type} does not exist!")


def annotate(annotator, annot_type, gt_mask, im, mivos_mask=None,
             frame_annots=None, cache_key=None):
    ann_type, num_prompts = ann_type_to_annotator_input(annot_type)
    return annotator.get_mask(
        annotation_type=ann_type, num_prompts=num_prompts, gt_mask=gt_mask,
        im=im, mivos_mask=mivos_mask, prev_iter_data=frame_annots,
        cache_key=cache_key)


def oracle_action(annotator, annotation_types, gt_mask, mivos_mask, im,
                  frame_annots, frame_num=-1, return_action_data=False):
    """Try every annotation type, keep the best reward (ties -> last type,
    matching the reference's ``>=``)."""
    best = dict(reward=-1e10, action=None, mask=None, cost=1e10, logits=None,
                clicks=None, labels=None, bbox=None)
    mivos_mask = as_host(mivos_mask).astype(bool)
    init_iou = compute_iou(np.asarray(gt_mask, bool)[None],
                           mivos_mask.squeeze()[None])
    actions_data = {"init_iou": init_iou, "frame_num": frame_num}

    for ann_type in annotation_types:
        if ann_type == "bbox" and "bbox" in frame_annots["annotations"]:
            continue
        sam_mask, cost, curr_iou, logits, clicks, labels, bbox = annotate(
            annotator, ann_type, gt_mask, im, mivos_mask,
            frame_annots=frame_annots,
            cache_key=frame_num if frame_num >= 0 else None)
        r = reward_func(curr_iou, cost, init_iou)
        actions_data[ann_type] = {"iou": curr_iou, "cost": cost, "reward": r}
        if r >= best["reward"]:
            best = dict(reward=r, action=ann_type, mask=deepcopy(sam_mask),
                        cost=cost, logits=deepcopy(logits),
                        clicks=deepcopy(clicks), labels=deepcopy(labels),
                        bbox=deepcopy(bbox))

    actions_data["selected_action"] = best["action"]
    out = (best["mask"], best["cost"], best["action"], best["logits"],
           best["clicks"], best["labels"], best["bbox"])
    if return_action_data:
        return (*out, actions_data)
    return out


def store_action_data(session: Session, frame: int, ann_action: str,
                      sam_mask, clicks, labels, bbox, sam_logits):
    """Record the annotation and return the mask to feed the engine
    ([K, H, W] float), per ``store_action_data`` in the reference."""
    if ann_action == "mask":
        session.frame_interaction_type[frame] = 1
        return session.gt_mask(frame)
    session.frame_interaction_type[frame] = 2
    mask = np.asarray(sam_mask).squeeze().astype(np.float32)
    session.masks_from_sam[frame] = mask
    session.sam_dirty.add(frame)  # device mirror refreshed at next eval
    rec = session.pf_annots[frame]
    rec["click_labels"] = labels
    rec["click_coords"] = clicks
    rec["bbox"] = bbox
    rec["sam_logits"] = sam_logits
    return mask[None]


def _frame_image(session: Session, frame: int) -> np.ndarray:
    """Normalized image at the ORIGINAL (unpadded) resolution — SAM prompts
    and masks live in original pixel space, exactly like the reference
    (``initialize`` hands the loops ``data['rgb']``, never the padded copy)."""
    img = session.sample.frame_float(frame)
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def _run_multi_loop(engine, sample, rounds, annotator, eval_metric,
                    choose_annotation, choose_next_frame, extra):
    """Shared loop for the multi-annotation policies.

    choose_annotation(session, frame, gen_masks, r) ->
        (mask_for_interaction [K,H,W], cost, ann_action)
    choose_next_frame(session, gen_masks, metric, r) -> int or None (stop)
    """
    session = initialize(engine, sample)
    if hasattr(annotator, "clear_sam_cache"):
        annotator.clear_sam_cache()  # keys are per-video frame indices
    session.annotation_times = []
    metric = None
    gen_masks = None
    fully_annotated = False
    annotations_actions = []
    round_metrics = []

    for r in range(1, rounds + 1):
        if (r >= session.num_frames and metric is not None
                and np.min(metric) == 1) or fully_annotated:
            continue
        if metric is not None and not_avail_frames(metric, session.frames_list,
                                                   session.num_frames):
            continue

        frame = session.frames_list[-1]
        if r > 1:
            with session.timers.span("annotate"):
                mask_for_interaction, cost, ann_action = choose_annotation(
                    session, frame, gen_masks, r)
        else:
            mask_for_interaction = session.gt_mask(frame)
            cost = ANNOTATION_COSTS["mask"]
            ann_action = "mask"

        session.pf_annots[frame]["annotations"].append(ann_action)
        session.interact(mask_for_interaction, frame)

        mu, gen_masks, _, metric = eval_session_metric(session, eval_metric)
        for ii, m in enumerate(metric):
            session.pf_annots[ii]["metric"] = m

        # Per-policy "fully annotated" handling differs in the reference:
        # oracle_oracle flags it but STILL appends argmin; rand_* appends
        # nothing; eva_vos only checks from r >= num_frames and appends -1.
        # choose_next_frame owns that logic and returns (selected | None,
        # fully_annotated).
        not_mask_annotated = np.where(session.frame_interaction_type != 1)[0]
        with session.timers.span("choice"):
            selected, became_full = choose_next_frame(
                session, gen_masks, metric, r, not_mask_annotated)
        fully_annotated = fully_annotated or became_full
        if selected is not None:
            session.frames_list.append(int(selected))

        session.mu_metrics.append(mu)
        session.annotation_times.append(cost)
        annotations_actions.append(ann_action)
        round_metrics.append(list(metric))
        if extra is not None:
            extra(session, r)

    return session, annotations_actions, round_metrics


def oracle_oracle(rounds, engine, sample, annotator,
                  annotation_types=("click", "mask"), eval_metric="j"):
    """Oracle frame (argmin quality) + oracle annotation type."""
    assert len(annotation_types) > 1

    def choose_annotation(session, frame, gen_masks, r):
        sam_mask, cost, action, logits, clicks, labels, bbox, _ = oracle_action(
            annotator=annotator, annotation_types=annotation_types,
            frame_annots=session.pf_annots[frame],
            gt_mask=session.sample.gt[0, frame], mivos_mask=gen_masks[frame],
            im=_frame_image(session, frame), frame_num=frame,
            return_action_data=True)
        mask = store_action_data(session, frame, action, sam_mask,
                                 clicks, labels, bbox, logits)
        return mask, cost, action

    def choose_next_frame(session, gen_masks, metric, r, not_mask):
        # reference flags fully_annotated but still appends the argmin
        # (mulitple_annotations.py:146-151)
        return int(np.argmin(metric)), len(not_mask) == 0

    session, actions, round_metrics = _run_multi_loop(
        engine, sample, rounds, annotator, eval_metric,
        choose_annotation, choose_next_frame, None)
    return (session.mu_metrics, session.annotation_times, actions,
            round_metrics, session.frames_list[:-1])


def _rand_next_frame(session, rng, not_mask):
    """Random frame among those not annotated with a full mask; None when
    every frame is (reference rand loops then stop selecting)."""
    if len(not_mask) == 0:
        return None, True
    return int(rng.choice(not_mask)), False


def rand_type(rounds, engine, sample, annotator, annotation_type="3clicks",
              eval_metric="j", rng=None):
    """Random frame, one fixed annotation type."""
    assert isinstance(annotation_type, str)
    rng = rng or np.random.default_rng(29102910)

    def choose_annotation(session, frame, gen_masks, r):
        sam_mask, cost, _, logits, clicks, labels, bbox = annotate(
            annotator, annotation_type, session.sample.gt[0, frame],
            _frame_image(session, frame),
            as_host(gen_masks[frame]).astype(bool),
            frame_annots=session.pf_annots[frame], cache_key=frame)
        mask = store_action_data(session, frame, annotation_type, sam_mask,
                                 clicks, labels, bbox, logits)
        return mask, cost, annotation_type

    def choose_next_frame(session, gen_masks, metric, r, not_mask):
        return _rand_next_frame(session, rng, not_mask)

    session, actions, _ = _run_multi_loop(
        engine, sample, rounds, annotator, eval_metric,
        choose_annotation, choose_next_frame, None)
    return session.mu_metrics, session.annotation_times, actions


def rand_rand(rounds, engine, sample, annotator,
              annotation_types=("3clicks", "mask"), eval_metric="j", rng=None):
    """Random frame, random annotation type."""
    assert len(annotation_types) > 1
    rng = rng or np.random.default_rng(29102910)

    def choose_annotation(session, frame, gen_masks, r):
        ann_action = annotation_types[int(rng.integers(len(annotation_types)))]
        sam_mask, cost, _, logits, clicks, labels, bbox = annotate(
            annotator, ann_action, session.sample.gt[0, frame],
            _frame_image(session, frame),
            as_host(gen_masks[frame]).astype(bool),
            frame_annots=session.pf_annots[frame], cache_key=frame)
        mask = store_action_data(session, frame, ann_action, sam_mask,
                                 clicks, labels, bbox, logits)
        return mask, cost, ann_action

    def choose_next_frame(session, gen_masks, metric, r, not_mask):
        return _rand_next_frame(session, rng, not_mask)

    session, actions, _ = _run_multi_loop(
        engine, sample, rounds, annotator, eval_metric,
        choose_annotation, choose_next_frame, None)
    return session.mu_metrics, session.annotation_times, actions


def rl_agent_annotate(annotator, rl_agent_act, mivos_mask, gt_mask, im,
                      frame_annots, frame=None, device="cuda"):
    """RL-agent annotation-type choice for one frame
    (``mulitple_annotations.py:286-304``).

    rl_agent_act: (sam_embedding [1, 64, 64, 256], mask224 [1, 224, 224, 3])
                  -> (action int, value float); mask224 is a tensor on the
                  device of ``mivos_mask`` (``device`` when it is an array)
    Returns (mask, cost, ann_type, logits, clicks, labels, bbox, value).
    """
    if frame_annots["metric"] == EMPTY_GT_TOKEN:
        return (np.asarray(gt_mask)[None], ANNOTATION_COSTS["no_object"],
                "no_object", None, None, None, None, 0)

    annotator.set_image_to_sam(im, cache_key=frame)
    feats_dev = getattr(getattr(annotator.sam, "predictor", None),
                        "features", None)
    if feats_dev is not None:
        # the predictor's embedding on its device, channel-last: the
        # official layout's fetch + transpose + upload is a layout change
        # the agent net immediately undoes
        emb = torch.as_tensor(feats_dev).float()[None]     # [1, S, S, 256]
    else:
        emb = np.asarray(annotator.sam.get_image_embedding())
        emb = np.transpose(emb, (1, 2, 0))[None]           # [1, 64, 64, 256]

    m = (mivos_mask.float() if isinstance(mivos_mask, torch.Tensor)
         else np.asarray(mivos_mask, np.float32))  # device slices stay put
    mask224 = masks_to_224_3ch(m.squeeze()[None], device=device)

    action, value = rl_agent_act(emb, mask224)
    avail_actions = ["3clicks", "mask"]
    ann_type = avail_actions[int(action)]
    sam_mask, cost, _, logits, clicks, labels, bbox = annotate(
        annotator, ann_type, gt_mask, im, as_host(mivos_mask).astype(bool),
        frame_annots=frame_annots, cache_key=frame)
    return sam_mask, cost, ann_type, logits, clicks, labels, bbox, float(value)


def eva_vos(qnet_extract, rl_agent_act, rounds, engine, sample, annotator,
            annotation_types=("3clicks", "mask"), eval_metric="j"):
    """The flagship policy: QNet frame selection + RL-agent type selection
    (``mulitple_annotations.py:307-378``)."""
    assert len(annotation_types) > 1
    frames224 = frames_to_224(sample.images01, device=engine.device)
    rl_values = [-2]

    def choose_annotation(session, frame, gen_masks, r):
        sam_mask, cost, action, logits, clicks, labels, bbox, value = \
            rl_agent_annotate(
                annotator, rl_agent_act, gen_masks[frame],
                session.sample.gt[0, frame], _frame_image(session, frame),
                session.pf_annots[frame], frame=frame, device=engine.device)
        rl_values.append(value)
        mask = store_action_data(session, frame, action, sam_mask,
                                 clicks, labels, bbox, logits)
        return mask, cost, action

    def choose_next_frame(session, gen_masks, metric, r, not_mask):
        # reference checks full annotation only once r >= num_frames and
        # records the -1 sentinel (mulitple_annotations.py:361-371)
        if r >= session.num_frames:
            if len(not_mask) == 0:
                return -1, True
            return qnet_frame_selection(qnet_extract, frames224, gen_masks,
                                        not_mask), False
        return qnet_frame_selection(qnet_extract, frames224, gen_masks,
                                    session.frames_list), False

    session, actions, round_metrics = _run_multi_loop(
        engine, sample, rounds, annotator, eval_metric,
        choose_annotation, choose_next_frame, None)
    return (session.mu_metrics, session.annotation_times, rl_values, actions,
            round_metrics, session.frames_list[:-1])
