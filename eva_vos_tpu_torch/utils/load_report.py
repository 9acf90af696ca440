"""Checkpoint-load bookkeeping (a copy of
``eva_vos_tpu/utils/load_report.py``): which models run on real weights and
which fell back to random init (``allow_random``).

Experiment CSVs stamp a loud ``RANDOM_WEIGHTS`` marker when ANY model in
the run random-initialized, so a smoke run can never be mistaken for a
real baseline.
"""

from __future__ import annotations

_REPORT: dict[str, bool] = {}


def record(name: str, random_init: bool) -> None:
    _REPORT[name] = bool(random_init)


def reset() -> None:
    _REPORT.clear()


def report() -> dict:
    return dict(_REPORT)


def any_random() -> bool:
    return any(_REPORT.values())


def weights_marker() -> str:
    """'RANDOM_WEIGHTS' when any loaded model is random-init, else
    'converted' (no loads recorded counts as converted)."""
    return "RANDOM_WEIGHTS" if any_random() else "converted"
