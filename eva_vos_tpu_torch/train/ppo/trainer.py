"""Clipped-surrogate PPO trainer (counterpart of
``eva_vos_tpu/train/ppo/trainer.py``).

Behavior parity target: ``ppo/ppo_trainer.py`` — ratio clip 0.2, MSE value
loss x 0.5, entropy bonus, per-epoch KL early stop, AdamW/SGD at lr 1e-5.

``act`` / ``act_batch`` run the ``ActorCritic`` in eval mode (BatchNorm's
running statistics) and sample from the trainer's action generator; the
update runs it in training mode on the minibatch's statistics (padding
slots included, as in the JAX update) with Flax's running-statistics
update, dropout from its own generator, and per-sample weights that keep
the padding out of the loss.

With a ``mesh`` (``parallel.make_mesh``) the minibatch update is
data-parallel, as the JAX trainer's is over its device mesh.  Every rank
runs its own rollouts and updates on its own minibatch of them; the global
minibatch is every rank's, in rank order.  Each rank normalises with the
global minibatch's BatchNorm statistics, divides its weighted sums by the
global weight sum and sums its gradients with the other ranks'; the loss
and KL are the global minibatch's, so every rank stops a pass at the same
KL.  The ranks' minibatches must be of one size (every rank's storage has
the same envs, steps and minibatch count): a size that differs, or a pass
that ends on one rank before the others, raises on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..common import (SeededDropout, all_reduce_grads_, batch_rows,
                      flax_batch_stats_, make_optimizer)
from ...models.init import make_generator, seeded_init_
from ...models.rl_agent import ActorCritic
from ...parallel.mesh import all_reduce


class PPOTrainer:
    def __init__(self, action_space, ppo_epochs, clip_param, value_loss_coef,
                 entropy_coef, target_kl_div, lr, optim_str, arch, dropout,
                 seed: int = 0, embed_dim: int = 256, device=None,
                 mesh=None):
        """``device``: by default the mesh's, else 'cuda'."""
        assert optim_str in {"Adam", "SGD"}
        self.action_space = action_space
        self.ppo_epochs = ppo_epochs
        self.clip_param = clip_param
        self.value_loss_coef = value_loss_coef
        self.entropy_coef = entropy_coef
        self.target_kl_div = target_kl_div
        self.mesh = mesh
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = torch.device(device)

        net = ActorCritic(out_dim=action_space, arch=arch, dropout=dropout,
                          embed_dim=embed_dim).to(self.device)
        seeded_init_(net, make_generator(seed, self.device))
        net.drop = SeededDropout(dropout, make_generator(seed + 2,
                                                         self.device), mesh)
        self.net = flax_batch_stats_(net, mesh)
        self.optimizer = make_optimizer(net.parameters(), optim_str, lr)
        self._act_gen = make_generator(seed + 1, self.device)

        n_params = sum(p.numel() for p in net.parameters())
        print(f"Trainable parameters: {n_params / 1e6:.2f}M")

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward(self, emb, mask):
        self.net.eval()
        logits, value = self.net(torch.as_tensor(emb, device=self.device),
                                 torch.as_tensor(mask, device=self.device))
        return logits.float(), value.float()

    def act(self, x_img, x_mask, x_cost=None, rng=None):
        """Sample an action; returns (action, log_prob, value)."""
        logits, value = self._forward(x_img, x_mask)
        action = torch.multinomial(torch.softmax(logits[0], -1), 1,
                                   generator=self._act_gen)[0]
        log_prob = torch.log_softmax(logits[0], -1)[action]
        a, lp, v = torch.stack([action.float(), log_prob,
                                value.reshape(-1)[0]]).tolist()
        return int(a), lp, v

    def act_batch(self, x_imgs, x_masks):
        """Vectorized act over N envs: one forward, N categorical samples.
        Returns (actions [N], log_probs [N], values [N]) as numpy."""
        logits, values = self._forward(x_imgs, x_masks)
        actions = torch.multinomial(torch.softmax(logits, -1), 1,
                                    generator=self._act_gen)
        lp = torch.log_softmax(logits, -1).gather(1, actions)[:, 0]
        host = torch.stack([actions[:, 0].float(), lp, values[:, 0]]).cpu()
        return (host[0].long().numpy(), host[1].numpy(), host[2].numpy())

    # ------------------------------------------------------------------
    def _reduced(self, x):
        return x if self.mesh is None else all_reduce(x, self.mesh)

    def _update(self, batch):
        """One optimizer step on a minibatch of device tensors (on a mesh,
        this rank's share of the global minibatch); -> (loss, kl) as 0-d
        tensors."""
        batch_rows(len(batch["weights"]), self.mesh)
        self.net.train()
        logits, values = self.net(batch["embeddings"], batch["masks"])
        logits, values = logits.float(), values.float()

        log_probs = F.log_softmax(logits, -1)
        act_lp = log_probs.gather(1, batch["actions"][:, None])[:, 0]
        entropy = -(log_probs.exp() * log_probs).sum(1)

        w = batch["weights"]
        wsum = self._reduced(w.sum()).clamp_min(1.0)

        ratios = torch.exp(act_lp - batch["old_log_probs"])
        surr1 = ratios * batch["advantages"]
        surr2 = torch.clamp(ratios, 1 - self.clip_param,
                            1 + self.clip_param) * batch["advantages"]
        policy_loss = -(torch.minimum(surr1, surr2) * w).sum() / wsum
        critic_loss = (((values[:, 0] - batch["returns"]) ** 2) * w
                       ).sum() / wsum
        ent = (entropy * w).sum() / wsum
        loss = policy_loss + self.value_loss_coef * critic_loss \
            - self.entropy_coef * ent

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            all_reduce_grads_(self.net.parameters(), self.mesh)
        self.optimizer.step()
        with torch.no_grad():
            kl = ((batch["old_log_probs"] - act_lp) * w).sum() / wsum
            loss, kl = self._reduced(torch.stack([loss.detach(), kl]))
        return loss, kl

    def optimize(self, rollouts, rng: np.random.Generator) -> float:
        """``ppo_epochs`` passes over the minibatches; a pass stops early
        once a minibatch's KL reaches ``target_kl_div`` (the next epoch
        starts again).  On a mesh a pass that runs out ends with an empty
        share on every rank: one rank's ending while another still updates
        raises on all of them."""
        total_loss = 0.0
        steps = 0
        for _ in range(self.ppo_epochs):
            for batch in rollouts.data_generator(rng):
                loss, kl = self._update(batch)
                loss, kl = torch.stack([loss, kl]).tolist()
                total_loss += loss
                steps += 1
                if (self.target_kl_div is not None
                        and kl >= self.target_kl_div):
                    break
            else:
                batch_rows(0, self.mesh)
        return total_loss / max(steps, 1)
