"""Multi-object soft aggregation (counterpart of ``eva_vos_tpu/ops/aggregate.py``).

K per-object probabilities become a (K+1)-way distribution: background is the
product of the complements, probabilities are clamped to [eps, 1 - eps],
turned into logits and softmaxed over the object axis.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def aggregate_wbg(prob: torch.Tensor, keep_bg: bool = False) -> torch.Tensor:
    """prob: [K, ...spatial] per-object probabilities -> [K(+1), ...spatial]."""
    bg = torch.prod(1.0 - prob, dim=0, keepdim=True)
    new_prob = torch.cat([bg, prob], dim=0).clamp(_EPS, 1.0 - _EPS)
    logits = torch.log(new_prob / (1.0 - new_prob))
    out = torch.softmax(logits, dim=0)
    return out if keep_bg else out[1:]
