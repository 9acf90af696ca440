"""What the port's trainers share: dropout from an explicit generator, the
Flax BatchNorm statistics, and the optimizers of the JAX trainers.

* ``SeededDropout`` takes the place of a network's ``nn.Dropout`` in a
  trainer (dropout has no weights, so the state dict is unchanged): its
  masks come from a ``torch.Generator``, as Flax's come from a key.
* ``flax_batch_stats_`` makes every ``BatchNorm2d`` update its running
  variance with the biased batch variance, as Flax's ``BatchNorm`` does
  (momentum 0.9 there, 0.1 here: the same update); ``nn.BatchNorm2d`` takes
  the unbiased one, n / (n - 1) larger (6.7% on layer4's 2x2 maps at batch
  4).  The inference modules keep torch's own update.
* ``make_optimizer``: ``optax.adamw(lr)`` is AdamW with weight decay 1e-4
  (torch's default is 1e-2), ``optax.sgd(lr, momentum=0.9)`` is SGD with
  momentum 0.9.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class SeededDropout(nn.Module):
    """Inverted dropout drawing its keep mask from ``generator``."""

    def __init__(self, p: float, generator: torch.Generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def _keep_running_var(bn, args):
    if bn.training:
        bn._running_var_before = bn.running_var.clone()


def _biased_running_var(bn, args, out):
    """torch wrote (1 - m) old + m var n / (n - 1); take away m var / (n -
    1), what it added over (1 - m) old + m var.  The buffer is replaced,
    not written in place: the autograd graph holds the one torch wrote."""
    if bn.training:
        x = args[0]
        n = x.numel() // x.shape[1]
        old = bn.__dict__.pop("_running_var_before")
        with torch.no_grad():
            new = bn.running_var
            bn.running_var = new - (new - (1.0 - bn.momentum) * old) / n


def flax_batch_stats_(module: nn.Module) -> nn.Module:
    """Hook every ``BatchNorm2d`` of ``module`` to the biased update."""
    for sub in module.modules():
        if isinstance(sub, nn.BatchNorm2d):
            sub.register_forward_pre_hook(_keep_running_var)
            sub.register_forward_hook(_biased_running_var)
    return module


def make_optimizer(params, optim: str, lr: float) -> torch.optim.Optimizer:
    assert optim in {"Adam", "SGD"}
    if optim == "Adam":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    return torch.optim.SGD(params, lr=lr, momentum=0.9)
