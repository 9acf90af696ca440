"""Multi-object soft aggregation (counterpart of ``eva_vos_tpu/ops/aggregate.py``).

K per-object probabilities become a (K+1)-way distribution: background is the
product of the complements (or 0.5, ``aggregate_sbg``), probabilities are
clamped to [eps, 1 - eps], turned into logits (x1000 when ``hard``) and
softmaxed over the object axis.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _logits(new_prob: torch.Tensor, hard: bool) -> torch.Tensor:
    new_prob = new_prob.clamp(_EPS, 1.0 - _EPS)
    logits = torch.log(new_prob / (1.0 - new_prob))
    return logits * 1000.0 if hard else logits


def aggregate_wbg(prob: torch.Tensor, keep_bg: bool = False,
                  hard: bool = False) -> torch.Tensor:
    """prob: [K, ...spatial] per-object probabilities -> [K(+1), ...spatial]."""
    bg = torch.prod(1.0 - prob, dim=0, keepdim=True)
    out = torch.softmax(_logits(torch.cat([bg, prob], dim=0), hard), dim=0)
    return out if keep_bg else out[1:]


def aggregate_sbg(prob: torch.Tensor, keep_bg: bool = False,
                  hard: bool = False) -> torch.Tensor:
    """Background fixed at 0.5 instead of the product-of-complements."""
    bg = torch.full_like(prob[:1], 0.5)
    out = torch.softmax(_logits(torch.cat([bg, prob], dim=0), hard), dim=0)
    return out if keep_bg else out[1:]


def aggregate_wbg_channel(prob: torch.Tensor, keep_bg: bool = False,
                          hard: bool = False):
    """Batched variant over axis 1: prob [B, K, ...] -> (logits, softmax)."""
    bg = torch.prod(1.0 - prob, dim=1, keepdim=True)
    logits = _logits(torch.cat([bg, prob], dim=1), hard)
    out = torch.softmax(logits, dim=1)
    return logits, (out if keep_bg else out[:, 1:])
