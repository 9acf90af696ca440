"""Result aggregation and cross-video greedy ranking (counterpart of
``eva_vos_tpu/vis/vis_util.py``, on ``utils.table`` and numpy, without
pandas).

Behavior parity target: ``vis/vis_util.py`` in the reference:
* ``read_exp`` aggregates an experiment CSV per round into a cumulative
  annotation-time vs mean-quality curve;
* ``rank_policy`` implements the paper's Eq. 3 greedy ranking — repeatedly
  annotate the video with the highest expected reward (oracle mode:
  realized ΔIoU/cost of the next round; EVA-VOS mode:
  (rl_value + 0.04) * gamma^round / cost, gamma 0.6) to produce one
  global time-vs-quality curve across the dataset.

The videos are walked in the order of their first row.  The JAX function
walks a ``set`` of names, whose order follows Python's string hashing; the
two differ only where two videos tie in the greedy reward.  The CSV's
floats are read exactly (pandas' default parser may miss by an ulp).
"""

from __future__ import annotations

import ast
import math

import numpy as np

from ..utils.table import read_columns

PLOT_DATA = {
    "qnet_mask": ["black", "-"],
    "oracle_mask": [(1.0, 0.0, 0.16, 1.0), "--"],
    "rand_mask": [(0.36, 1.0, 0.0, 1.0), "-"],
    "l2_mask_dino_large": ["cyan", "-"],
    "l2_mask_resnet101": ["#B2BEB5", "-"],
    "l2_mask_vit_large": ["#FFEF00", "-"],
}

PLOT_DATA_ANNOTATIONS = {
    "eva_vos": ["black", "-", "EVA-VOS"],
    "rand_rand_3clicks_mask": [(0.36, 1.0, 0.0, 1.0), "-", "Random"],
    "oracle_oracle_3clicks_mask": [(1.0, 0.0, 0.16, 1.0), "--", "Oracle"],
    "rand_mask": ["magenta", "-", "Mask-only"],
    "rand_type_3clicks": ["cyan", "-", "Clicks-only"],
}


def read_exp(path_to_csv: str):
    """-> (cumulative hours [R], mean quality per round [R])."""
    table = read_columns(path_to_csv)
    if "oracle_oracle" in path_to_csv:
        return rank_policy(table)
    if "eva_vos" in path_to_csv:
        return rank_policy(table, rl_agent=True)
    by_round: dict = {}
    for r, mu, t in zip(table["round"], table["mu_metric"],
                        table["annotation_time"]):
        by_round.setdefault(r, ([], []))
        by_round[r][0].append(mu)
        by_round[r][1].append(t)
    rounds = sorted(by_round)
    metric = np.asarray([math.fsum(by_round[r][0]) / len(by_round[r][0])
                         for r in rounds])
    annotation_time = np.cumsum(
        [math.fsum(by_round[r][1]) for r in rounds]) / 3600
    return annotation_time, metric


def _parse_maybe(x):
    return ast.literal_eval(x) if isinstance(x, str) else x


def rank_policy(table: dict, gamma: float = 0.6, rl_agent: bool = False):
    """Greedy cross-video annotation ordering (paper Eq. 3); ``table`` is
    an experiment CSV's columns (``utils.table.read_columns``)."""
    rows = [dict(zip(table, values)) for values in zip(*table.values())]
    first = {}                       # (video, round) -> its first row
    for row in rows:
        first.setdefault((row["video"], row["round"]), row)
    policy_data: dict = {}
    videos_max_round: dict = {}
    for row in rows:
        vid, curr_round = row["video"], row["round"]
        policy_data.setdefault(vid, {})
        videos_max_round[vid] = max(videos_max_round.get(vid, curr_round),
                                    curr_round)
        nxt = first.get((vid, curr_round + 1))
        if nxt is None:
            continue
        entry = {
            "metric": _parse_maybe(row["round_metrics"]),
            "mu_metric": row["mu_metric"],
            "next_frame": int(nxt["annotated_frames"]),
            "next_metric": _parse_maybe(nxt["round_metrics"]),
            "annotation_time": row["annotation_time"],
            "next_annotation_time": nxt["annotation_time"],
        }
        if rl_agent:
            entry["rl_value"] = nxt["rl_values"]
        policy_data[vid][curr_round] = entry

    videos = list(policy_data)
    round_pointers = {v: 0 for v in videos}
    initial_mus = [np.mean(policy_data[v][0]["mu_metric"]) for v in videos]
    initial_times = [policy_data[v][0]["annotation_time"] for v in videos]
    points = [float(np.mean(initial_mus))]
    times = [float(np.sum(initial_times))]

    while True:
        rewards = {}
        for vid in videos:
            try:
                p = round_pointers[vid]
                curr_m = policy_data[vid][p]["metric"]
                next_m = policy_data[vid][p + 1]["metric"]
                frame = policy_data[vid][p]["next_frame"]
                cost = policy_data[vid][p]["next_annotation_time"]
                if rl_agent:
                    value = policy_data[vid][p]["rl_value"] + 0.04
                    if value == -2:
                        value = 0
                    rewards[vid] = value * (gamma ** p) / cost
                else:
                    rewards[vid] = (next_m[frame] - curr_m[frame]) / cost
            except KeyError:
                rewards[vid] = -1e10

        selected = -1
        for vid, _ in sorted(rewards.items(), key=lambda x: x[1],
                             reverse=True):
            if round_pointers[vid] != videos_max_round[vid] - 1:
                selected = vid
                break
        if selected == -1:
            break

        cost = policy_data[selected][round_pointers[selected]][
            "next_annotation_time"]
        round_pointers[selected] += 1

        points.append(float(np.mean(
            [policy_data[v][round_pointers[v]]["mu_metric"]
             for v in videos])))
        times.append(times[-1] + cost)

    return np.asarray(times) / 3600.0, points
