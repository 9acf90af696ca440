"""QNet trainer (counterpart of ``eva_vos_tpu/train/qnet.py``).

Behavior parity target: ``train_qnet.py`` in the reference — 20-bin CE over
(frame, mask) pairs, SGD(momentum 0.9) or AdamW at lr 1e-5, 30 epochs.

The step is the JAX one: cross-entropy on fp32 logits, accuracy,
BatchNorm on batch statistics with Flax's running-statistics update
(``common.flax_batch_stats_``), dropout from the trainer's generator.
Batches are the JAX dicts of host arrays (``img`` [B, S, S, 3], ``mask``
[B, S, S], ``label`` [B]); metrics are 0-d tensors on the device.

With a ``mesh`` (``parallel.make_mesh``) the steps are data-parallel, as
the JAX trainer's are over its device mesh.  Each rank is given its own
rows (``shard_batch`` takes them from a global batch; the CLI loads only
them), and the global batch is every rank's rows in rank order: BatchNorm
normalises with its statistics, the loss is the sum of the rank's rows
over its size, the gradients are summed across the ranks, and the metrics
are its own.  A training step needs equal shares (``batch_rows`` raises on
every rank otherwise); an evaluation takes any, none included.  Every
rank holds the same weights after a step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import (SeededDropout, all_reduce_grads_, batch_rows,
                     flax_batch_stats_, make_optimizer)
from ..models.init import make_generator, seeded_init_
from ..models.qnet import QualityNet
from ..parallel.mesh import all_reduce


class QNetTrainState(NamedTuple):
    net: QualityNet
    optimizer: torch.optim.Optimizer
    step: int


def _mask_to_3ch(mask):
    return mask[..., None].repeat(1, 1, 1, 3)


class QNetTrainer:
    def __init__(self, arch: str = "resnet18", n_labels: int = 20,
                 lr: float = 1e-5, optim: str = "SGD",
                 merge_strategy: str = "cat", dropout: float = 0.5,
                 device=None, mesh=None):
        """``device``: by default the mesh's, else 'cuda'."""
        assert optim in {"Adam", "SGD"}
        self.arch, self.n_labels = arch, n_labels
        self.merge_strategy, self.dropout = merge_strategy, dropout
        self.lr, self.optim = lr, optim
        self.mesh = mesh
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, state_dict=None) -> QNetTrainState:
        """A fresh network: seeded random weights, or ``state_dict``'s
        (reference layout); dropout from a generator seeded ``seed + 1``."""
        net = QualityNet(arch=self.arch, n_labels=self.n_labels,
                         merge_strategy=self.merge_strategy).to(self.device)
        if state_dict is None:
            seeded_init_(net, make_generator(seed, self.device))
        else:
            net.load_state_dict(state_dict)
        net.drop = SeededDropout(self.dropout,
                                 make_generator(seed + 1, self.device),
                                 self.mesh)
        flax_batch_stats_(net, self.mesh)
        opt = make_optimizer(net.parameters(), self.optim, self.lr)
        return QNetTrainState(net=net, optimizer=opt, step=0)

    def _arrays(self, state, batch, equal: bool):
        """The batch (on a mesh, this rank's rows) on the device, images and
        masks in the network's dtype, and the global batch size."""
        dtype = next(state.net.parameters()).dtype
        rows = batch_rows(len(batch["label"]), self.mesh, equal)

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x) if isinstance(x, np.ndarray)
                                   else x, device=self.device).to(dtype)

        return (dev(batch["img"], dtype), dev(batch["mask"], dtype),
                dev(batch["label"], torch.long), rows)

    def _metrics(self, logits, labels, rows: int):
        """(loss, correct): this rank's share of the global batch's mean
        cross-entropy, and its count of correct labels."""
        loss = F.cross_entropy(logits.float(), labels, reduction="sum") / rows
        return loss, (logits.argmax(-1) == labels).float().sum()

    def _global(self, loss, correct, rows: int):
        """The global batch's metrics from this rank's shares."""
        both = torch.stack([loss.detach(), correct])
        if self.mesh is not None:
            both = all_reduce(both, self.mesh)
        return {"loss": both[0], "acc": both[1] / rows}

    # ------------------------------------------------------------------
    def train_step(self, state: QNetTrainState, batch):
        """One optimizer step; -> (state, {"loss", "acc"})."""
        imgs, masks, labels, rows = self._arrays(state, batch, equal=True)
        state.net.train()
        loss, correct = self._metrics(state.net(imgs, _mask_to_3ch(masks)),
                                      labels, rows)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            all_reduce_grads_(state.net.parameters(), self.mesh)
        state.optimizer.step()
        return (state._replace(step=state.step + 1),
                self._global(loss, correct, rows))

    @torch.no_grad()
    def eval_step(self, state: QNetTrainState, batch):
        imgs, masks, labels, rows = self._arrays(state, batch, equal=False)
        state.net.eval()
        return self._global(*self._metrics(
            state.net(imgs, _mask_to_3ch(masks)), labels, rows), rows)

    def extract_fn(self, state: QNetTrainState):
        """The feature extractor for frame-selection policies (eval mode)."""
        net = state.net

        def extract(imgs, masks):
            net.eval()
            return net.extract_features(imgs, masks)

        return extract
