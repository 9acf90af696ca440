"""What the port's trainers share: dropout from an explicit generator, the
Flax BatchNorm statistics, and the optimizers of the JAX trainers.

* ``SeededDropout`` takes the place of a network's ``nn.Dropout`` in a
  trainer (dropout has no weights, so the state dict is unchanged): its
  masks come from a ``torch.Generator``, as Flax's come from a key.
* ``flax_batch_stats_`` makes every ``BatchNorm2d`` update its running
  variance with the biased batch variance, as Flax's ``BatchNorm`` does
  (momentum 0.9 there, 0.1 here: the same update); ``nn.BatchNorm2d`` takes
  the unbiased one, n / (n - 1) larger (6.7% on layer4's 2x2 maps at batch
  4).  The inference modules keep torch's own update.  On a mesh it gives
  them a global-batch forward instead (:func:`_global_batch_norm`): the
  statistics of the whole data-parallel batch, as Flax's ``BatchNorm``
  takes under a sharded jit.  (``nn.SyncBatchNorm`` runs on CUDA tensors
  only, and updates the unbiased variance.)
* On a mesh ``SeededDropout`` draws the mask of the global batch and keeps
  this rank's rows, so a data-parallel step equals the one-process step on
  the global batch.  A data-parallel step is given this rank's rows (the
  global batch is every rank's, in rank order); :func:`batch_rows` checks
  that the ranks hold equal shares, which the dropout mask assumes.
* ``make_optimizer``: ``optax.adamw(lr)`` is AdamW with weight decay 1e-4
  (torch's default is 1e-2), ``optax.sgd(lr, momentum=0.9)`` is SGD with
  momentum 0.9.
"""

from __future__ import annotations

import types

import torch
import torch.nn as nn

from ..parallel.mesh import all_gather, all_reduce


class SeededDropout(nn.Module):
    """Inverted dropout drawing its keep mask from ``generator``; on a
    ``mesh``, the global batch's mask, of which this rank keeps its rows."""

    def __init__(self, p: float, generator: torch.Generator, mesh=None):
        super().__init__()
        self.p = p
        self.generator = generator
        self.mesh = mesh

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        size, rank = (1, 0) if self.mesh is None else (self.mesh.size,
                                                         self.mesh.rank)
        b = x.shape[0]
        keep = torch.rand((size * b, *x.shape[1:]), generator=self.generator,
                          device=x.device)[rank * b:(rank + 1) * b] >= self.p
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


def _global_batch_norm(bn, mesh):
    """``bn``'s training forward over the global batch of ``mesh``: the
    per-channel count, sum and sum of squares all-reduced (with their
    gradient), the global mean and biased variance, and the running
    statistics updated with them as Flax updates its own.  The sums are
    taken about the running mean, which every rank holds: the same
    statistics, with less cancellation than raw sums of squares."""
    eval_forward = bn.forward

    def forward(self, x):
        if not self.training:
            return eval_forward(x)
        c = x.shape[1]
        shift = self.running_mean.to(x.dtype, copy=True)
        xs = x - shift.view(1, c, 1, 1)
        n_local = x.numel() // c
        stats = torch.cat([xs.new_full((1,), float(n_local)),
                           xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3))])
        stats = all_reduce(stats, mesh, grad=True)
        n = stats[0]
        mean_s = stats[1:c + 1] / n
        var = (stats[c + 1:] / n - mean_s * mean_s).clamp_min(0.0)
        mean = mean_s + shift
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean.view(1, c, 1, 1)) * scale.view(1, c, 1, 1)
                + self.bias.view(1, c, 1, 1))

    return types.MethodType(forward, bn)


def flax_batch_stats_(module: nn.Module, mesh=None) -> nn.Module:
    """Hook every ``BatchNorm2d`` of ``module`` to the biased update; on a
    ``mesh``, give it the global-batch forward (:func:`_global_batch_norm`)."""
    for sub in module.modules():
        if not isinstance(sub, nn.BatchNorm2d):
            continue
        if mesh is None:
            sub.register_forward_pre_hook(_keep_running_var)
            sub.register_forward_hook(_biased_running_var)
        else:
            sub.forward = _global_batch_norm(sub, mesh)
    return module


def batch_rows(n: int, mesh, equal: bool = True) -> int:
    """The global batch's rows from this rank's ``n`` (``n`` without a
    mesh).  With ``equal``, shares that differ raise on every rank."""
    if mesh is None:
        return n
    counts = all_gather(torch.tensor(n, device=mesh.device), mesh).tolist()
    if equal and len(set(counts)) > 1:
        raise ValueError(f"a data-parallel step needs equal shares of the "
                         f"global batch; the ranks hold {counts} rows")
    return sum(counts)


def all_reduce_grads_(params, mesh) -> None:
    """Sum every parameter's gradient across ``mesh``, in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_optimizer(params, optim: str, lr: float) -> torch.optim.Optimizer:
    assert optim in {"Adam", "SGD"}
    if optim == "Adam":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    return torch.optim.SGD(params, lr=lr, momentum=0.9)
