"""Mask-only annotation policies, one gt mask per round (counterpart of
``eva_vos_tpu/interactions/mask.py``).

Behavior parity target: ``interactions/mask.py`` — every policy shares the
round skeleton (interact with gt on the selected frame -> propagate ->
evaluate -> select next frame -> record 80 s, or 3 s for empty-gt frames);
they differ only in the frame selector.  The reference repeats the skeleton
per policy; here it is one loop parameterized by a selector callback, whose
calls are the session's ``choice`` span.
"""

from __future__ import annotations

import numpy as np

from .eval import (as_host, initialize, eval_session_metric, not_avail_frames,
                   EMPTY_GT_TOKEN)
from .policies import (qnet_frame_selection, rand_frame_selection,
                       l2_frame_selection, upper_bound_frame_selection,
                       frames_to_224)
from ..utils.costs import ANNOTATION_COSTS


def _mask_round_loop(engine, sample, rounds, select_frame, eval_metric="j",
                     collect_states=False):
    """Shared skeleton.  ``select_frame(session, gen_masks, metric) -> int``.

    Returns (mu_metrics, annotation_times) like the reference policies, plus
    the per-round (gen_masks, frames, metrics, times) when
    ``collect_states`` (the FQ-dataset generator's needs).
    """
    session = initialize(engine, sample)
    metric = None
    per_round = {"gen_masks": [], "frames": [], "metrics": [], "times": []}

    for r in range(1, rounds + 1):
        if r >= session.num_frames:
            continue
        if metric is not None and not_avail_frames(metric, session.frames_list,
                                                   session.num_frames):
            continue

        frame = session.frames_list[r - 1]
        session.interact(session.gt_mask(frame), frame)
        session.frame_interaction_type[frame] = 1

        mu, gen_masks, _, metric = eval_session_metric(session, eval_metric)
        session.mu_metrics.append(mu)

        with session.timers.span("choice"):
            selected = select_frame(session, gen_masks, metric)
        cost = (ANNOTATION_COSTS["no_object"]
                if metric[selected] == EMPTY_GT_TOKEN
                else ANNOTATION_COSTS["mask"])
        session.annotation_times.append(cost)
        session.frames_list.append(int(selected))

        if collect_states:
            # host snapshot: the dataset generator writes PNGs from these
            per_round["gen_masks"].append(as_host(gen_masks))
            per_round["frames"].append(int(selected))
            per_round["metrics"].append(list(metric))
            per_round["times"].append(cost)

    if collect_states:
        return per_round
    return session.mu_metrics, session.annotation_times[:-1]


def qnet_mask(qnet_extract, rounds, engine, sample, eval_metric="j"):
    """QNet farthest-point frame selection (``mask.py:10-42``).
    ``qnet_extract`` receives tensors on the engine's device."""
    frames224 = frames_to_224(sample.images01, device=engine.device)

    def select(session, gen_masks, metric):
        return qnet_frame_selection(qnet_extract, frames224, gen_masks,
                                    session.frames_list)

    return _mask_round_loop(engine, sample, rounds, select, eval_metric)


def rand_mask(rounds, engine, sample, eval_metric="j", rng=None):
    rng = rng or np.random.default_rng(29102910)

    def select(session, gen_masks, metric):
        return rand_frame_selection(session.num_frames, session.frames_list, rng)

    return _mask_round_loop(engine, sample, rounds, select, eval_metric)


def oracle_mask(rounds, engine, sample, eval_metric="j"):
    """Annotate the currently-worst frame (``mask.py:79-110``)."""

    def select(session, gen_masks, metric):
        return int(np.argmin(metric))

    return _mask_round_loop(engine, sample, rounds, select, eval_metric)


def oracle_mask_dataset(rounds, engine, sample, eval_metric="j"):
    """8-round oracle variant recording per-round masks/IoUs for the FQ
    dataset generator (``mask.py:113-156``).

    Returns (generated_masks_per_round, frames_list[1:], metric_list,
    annotation_times).
    """

    def select(session, gen_masks, metric):
        return int(np.argmin(metric))

    per_round = _mask_round_loop(engine, sample, rounds, select, eval_metric,
                                 collect_states=True)
    return (per_round["gen_masks"], per_round["frames"],
            per_round["metrics"], per_round["times"])


def l2_mask(encoder_extract, rounds, engine, sample, eval_metric="j"):
    """Farthest-point on pretrained-encoder features (``mask.py:159-193``).

    ``encoder_extract(images) -> [T, D]`` runs once per video.
    """
    enc_input = (sample.encoder_images if sample.encoder_images is not None
                 else sample.images01)
    features = encoder_extract(enc_input)

    def select(session, gen_masks, metric):
        return l2_frame_selection(features, session.frames_list)

    return _mask_round_loop(engine, sample, rounds, select, eval_metric)


def upper_bound_mask(rounds, engine, sample, eval_metric="j"):
    """One-step-lookahead oracle (``mask.py:196-228``)."""

    def select(session, gen_masks, metric):
        return upper_bound_frame_selection(session, eval_metric)

    return _mask_round_loop(engine, sample, rounds, select, eval_metric)
