"""Determinism helpers (a copy of ``eva_vos_tpu/utils/seeding.py``;
reference ``util/dist.py:55-57``).  The port's networks and samplers take
explicit ``torch.Generator`` s; this seeds the host's numpy and ``random``."""

from __future__ import annotations

import random

import numpy as np

DEFAULT_SEED = 29102910


def seed_everything(seed: int = DEFAULT_SEED):
    np.random.seed(seed)
    random.seed(seed)
    return seed
