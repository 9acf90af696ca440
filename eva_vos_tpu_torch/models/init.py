"""Seeded random initialisation of the port's networks.

No checkpoint of the decision models, the feature extractors or SAM is in
the repository, so their modules start from random weights made by one
explicit ``torch.Generator``: on the module's own device, so a network built
on the card is initialised there (ViT-H SAM's 2.5 GB need no host copy).

The rule follows Flax's defaults, which the JAX package's random trees come
from: conv and linear weights ~ N(0, 1/fan_in) (LeCun normal), biases 0,
norm scales 1 and shifts 0, BatchNorm statistics (0, 1), embedding tables
(SAM's tokens) ~ N(0, 1); every other
parameter (tokens, embeddings, position tables) ~ N(0, std) with the std
that the module names in ``_param_std`` (0.02 when it names none; "ones"
fills the parameter with ones, as LayerScale's gammas start).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_NORMS = (nn.LayerNorm, nn.BatchNorm2d, nn.GroupNorm)


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``module`` from ``generator``."""
    for sub in module.modules():
        stds = getattr(sub, "_param_std", {})
        for name, p in sub.named_parameters(recurse=False):
            if isinstance(sub, _NORMS) or getattr(sub, "is_norm", False):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif isinstance(sub, nn.Embedding):
                p.normal_(0.0, 1.0, generator=generator)
            elif name == "bias" or name.endswith("_bias"):
                p.zero_()
            elif name == "weight" or name.endswith("_weight"):
                if isinstance(sub, nn.ConvTranspose2d):
                    fan_in = p.shape[0] * p[0, 0].numel()
                else:
                    fan_in = p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            else:
                std = stds.get(name, 0.02)
                if std == "ones":
                    p.fill_(1.0)
                elif std == 0.0:
                    p.zero_()
                else:
                    p.normal_(0.0, std, generator=generator)
        if isinstance(sub, nn.BatchNorm2d):
            sub.running_mean.zero_()
            sub.running_var.fill_(1.0)
    return module


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
