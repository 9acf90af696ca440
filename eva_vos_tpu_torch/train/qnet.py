"""QNet trainer (counterpart of ``eva_vos_tpu/train/qnet.py``).

Behavior parity target: ``train_qnet.py`` in the reference — 20-bin CE over
(frame, mask) pairs, SGD(momentum 0.9) or AdamW at lr 1e-5, 30 epochs.

One device, no mesh (the JAX trainer's data-parallel mesh becomes DDP in a
later slice).  The step is the JAX one: cross-entropy on fp32 logits,
accuracy, BatchNorm on batch statistics with Flax's running-statistics
update (``common.flax_batch_stats_``), dropout from the trainer's
generator.  Batches are the JAX dicts of host arrays (``img`` [B, S, S, 3],
``mask`` [B, S, S], ``label`` [B]); metrics are 0-d tensors on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import SeededDropout, flax_batch_stats_, make_optimizer
from ..models.init import make_generator, seeded_init_
from ..models.qnet import QualityNet


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
                 device="cuda"):
        assert optim in {"Adam", "SGD"}
        self.arch, self.n_labels = arch, n_labels
        self.merge_strategy, self.dropout = merge_strategy, dropout
        self.lr, self.optim = lr, optim
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
                                 make_generator(seed + 1, self.device))
        flax_batch_stats_(net)
        opt = make_optimizer(net.parameters(), self.optim, self.lr)
        return QNetTrainState(net=net, optimizer=opt, step=0)

    def _arrays(self, state, batch):
        """The batch on the device, images and masks in the network's
        dtype."""
        dtype = next(state.net.parameters()).dtype

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

        return (dev(batch["img"], dtype), dev(batch["mask"], dtype),
                dev(batch["label"], torch.long))

    @staticmethod
    def _metrics(logits, labels):
        loss = F.cross_entropy(logits.float(), labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    # ------------------------------------------------------------------
    def train_step(self, state: QNetTrainState, batch):
        """One optimizer step; -> (state, {"loss", "acc"})."""
        imgs, masks, labels = self._arrays(state, batch)
        state.net.train()
        loss, acc = self._metrics(state.net(imgs, _mask_to_3ch(masks)), labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return (state._replace(step=state.step + 1),
                {"loss": loss.detach(), "acc": acc})

    @torch.no_grad()
    def eval_step(self, state: QNetTrainState, batch):
        imgs, masks, labels = self._arrays(state, batch)
        state.net.eval()
        loss, acc = self._metrics(state.net(imgs, _mask_to_3ch(masks)), labels)
        return {"loss": loss, "acc": acc}

    def extract_fn(self, state: QNetTrainState):
        """The feature extractor for frame-selection policies (eval mode)."""
        net = state.net

        def extract(imgs, masks):
            net.eval()
            return net.extract_features(imgs, masks)

        return extract
