"""Rollout storage with fixed-shape minibatches (counterpart of
``eva_vos_tpu/train/ppo/storage.py``).

Behavior parity target: ``ppo/storage.py`` — per-env episode buffers with
padding flags and a shuffled minibatch generator.  Every minibatch is a
fixed ``[envs_per_batch * num_steps]`` block, as in the JAX storage:
padding slots repeat a valid sample and carry weight 0, so the loss is the
reference's over the valid steps (BatchNorm's batch statistics see the
repeats, as the JAX update's do).

The observations (224 masks, SAM embeddings) stay on ``device``, where the
environments made them; the per-step scalars live on the host.  A
minibatch's scalars and the indices of its observations go to the device
in one copy, and the observations are gathered there.
"""

from __future__ import annotations

import numpy as np
import torch


class RolloutStorage:
    def __init__(self, num_envs, num_steps, obs_hw=(224, 224),
                 embed_shape=(64, 64, 256), num_mini_batch=4, device="cuda"):
        assert num_envs >= num_mini_batch
        self.num_envs = num_envs
        self.num_steps = num_steps
        self.num_mini_batch = num_mini_batch
        self.device = torch.device(device)

        self.masks = torch.zeros((num_envs, num_steps, *obs_hw, 3),
                                 device=self.device)
        self.img_embeddings = torch.zeros((num_envs, *embed_shape),
                                          device=self.device)
        self.rewards = np.zeros((num_envs, num_steps), np.float32)
        self.value_preds = np.zeros((num_envs, num_steps), np.float32)
        self.returns = np.zeros((num_envs, num_steps), np.float32)
        self.action_log_probs = np.zeros((num_envs, num_steps), np.float32)
        self.actions = np.zeros((num_envs, num_steps), np.int32)
        self.paddings = np.ones((num_envs, num_steps), bool)
        self.advantages = np.zeros((num_envs, num_steps), np.float32)

    def insert(self, env_num, masks, img_embedding, actions, log_probs,
               values, rewards, returns, paddings, advantages):
        """Episode tensors are only filled up to the episode length; the
        rest stays padding.  ``masks`` [steps, 224, 224, 3] and
        ``img_embedding`` [64, 64, C] are tensors (or arrays)."""
        steps = len(actions)
        self.masks[env_num, :steps] = torch.as_tensor(masks,
                                                      device=self.device)
        self.img_embeddings[env_num] = torch.as_tensor(img_embedding,
                                                       device=self.device)
        self.actions[env_num, :steps] = actions
        self.action_log_probs[env_num, :steps] = log_probs
        self.value_preds[env_num, :steps] = values
        self.rewards[env_num, :steps] = rewards
        self.returns[env_num, :steps] = returns
        self.paddings[env_num] = True
        self.paddings[env_num, :steps] = np.asarray(paddings[:steps])
        self.advantages[env_num, :steps] = advantages

    def mean_valid_reward(self) -> float:
        valid = ~self.paddings
        return float(self.rewards[valid].mean()) if valid.any() else 0.0

    def data_generator(self, rng: np.random.Generator):
        """Yields fixed-shape minibatches of tensors on the device:
        dict(masks, embeddings, actions, values, returns, old_log_probs,
             advantages, weights) with leading dim envs_per_batch*num_steps.
        """
        envs_per_batch = self.num_envs // self.num_mini_batch
        perm = rng.permutation(self.num_envs)
        size = envs_per_batch * self.num_steps

        for start in range(0, self.num_envs, envs_per_batch):
            env_ids = perm[start:start + envs_per_batch]
            src = [(e, t) for e in env_ids
                   for t in np.where(~self.paddings[e])[0]]
            if not src:
                continue
            # padding slot j repeats valid sample j % len(src), weight 0
            e, t = np.asarray(src).T[:, np.arange(size) % len(src)]
            weights = (np.arange(size) < len(src)).astype(np.float32)
            host = np.stack([e, t, self.actions[e, t], self.value_preds[e, t],
                             self.returns[e, t], self.action_log_probs[e, t],
                             self.advantages[e, t], weights]).astype(np.float32)
            cols = torch.as_tensor(host).to(self.device)
            e_dev, t_dev = cols[0].long(), cols[1].long()
            yield {"masks": self.masks[e_dev, t_dev],
                   "embeddings": self.img_embeddings[e_dev],
                   "actions": cols[2].long(), "values": cols[3],
                   "returns": cols[4], "old_log_probs": cols[5],
                   "advantages": cols[6], "weights": cols[7]}
