"""Inference-time PPO agent (counterpart of
``eva_vos_tpu/train/ppo/agent.py``; reference ``ppo/ppo_agent.py``)."""

from __future__ import annotations

import torch

from ...models.rl_agent import ActorCritic


class PPOAgent:
    """Holds an ``ActorCritic`` (reference state-dict layout) in eval mode;
    ``act`` samples from the categorical policy and returns (action,
    value).

    The action is drawn from a seeded ``torch.Generator`` on the network's
    device, where the JAX agent splits a ``jax.random`` key: the logits and
    values match the JAX agent's, the sampled actions cannot."""

    def __init__(self, action_space, arch, state_dict, return_logits=False,
                 seed: int = 0, device="cuda"):
        # the SAM embedding's width comes from the weights, as the JAX
        # agent's comes from its variables
        net = ActorCritic(out_dim=action_space, arch=arch, dropout=0.0,
                          embed_dim=state_dict["embed_branch.2.weight"].shape[1])
        net.load_state_dict(state_dict)
        self.net = net.to(device).eval()
        self.device = torch.device(device)
        self.return_logits = return_logits
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def act(self, x_img, x_mask, x_cost=None):
        x_img = torch.as_tensor(x_img, device=self.device).float()
        x_mask = torch.as_tensor(x_mask, device=self.device).float()
        if x_cost is not None:
            x_cost = torch.as_tensor(x_cost, device=self.device).float()
        logits, value = self.net(x_img, x_mask, x_cost)
        logits = logits.float()
        if self.return_logits:
            return logits.cpu().numpy(), value.float().cpu().numpy()
        probs = torch.softmax(logits[0], dim=-1)
        action = int(torch.multinomial(probs, 1, generator=self._gen))
        return action, float(value.squeeze())

    def act_fn(self):
        """Adapter matching ``rl_agent_annotate``'s expected callable."""

        def fn(emb, mask224):
            return self.act(emb, mask224)

        return fn
