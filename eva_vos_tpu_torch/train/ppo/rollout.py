"""Episode rollout and return/advantage computation (counterpart of
``eva_vos_tpu/train/ppo/rollout.py``).

Behavior parity target: ``ppo/rollout.py`` — discounted returns over valid
steps, GAE with the reference's (gamma=0.99, decay=0.97) defaults (the
reference calls ``calculate_gaes`` without passing its config gamma —
preserved faithfully), and episode padding to ``num_steps``.  The
environments run on the storage's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .env import AnnotationEnv


def compute_returns(rewards, gamma: float) -> np.ndarray:
    out = np.zeros(len(rewards), np.float32)
    acc = 0.0
    for i in reversed(range(len(rewards))):
        acc = rewards[i] + gamma * acc
        out[i] = acc
    return out


def calculate_gaes(rewards, values, gamma: float = 0.99,
                   decay: float = 0.97) -> np.ndarray:
    rewards = np.asarray(rewards, np.float32)
    values = np.asarray(values, np.float32)
    next_values = np.concatenate([values[1:], [0.0]])
    deltas = rewards + gamma * next_values - values
    gaes = np.zeros_like(deltas)
    gaes[-1] = deltas[-1]
    for i in reversed(range(len(deltas) - 1)):
        gaes[i] = deltas[i] + decay * gamma * gaes[i + 1]
    return gaes


def _advantages(rewards, values, returns, advantages: str) -> np.ndarray:
    if advantages == "diff":
        return returns - np.asarray(values, np.float32)
    if advantages == "gae":
        return calculate_gaes(rewards, values)    # gamma 0.99, as the reference
    raise AttributeError("Invalid adv type")


def rollout(ppo_trainer, sam_controller, image, gt_mask, init_mask, env_num,
            storage, num_steps, gamma, advantages: str, rng):
    """Run one episode and insert it into storage."""
    env = AnnotationEnv(sam_controller, image, gt_mask, init_mask, num_steps,
                        device=storage.device)

    ep_masks, ep_actions, ep_rewards = [], [], []
    ep_log_probs, ep_values = [], []
    for _ in range(num_steps):
        state = env.state
        action, log_prob, value = ppo_trainer.act(*state, rng=rng)
        reward, _, done = env.step(int(action))
        ep_masks.append(state[1][0])
        ep_actions.append(int(action))
        ep_rewards.append(float(reward))
        ep_log_probs.append(float(log_prob))
        ep_values.append(float(value))
        if done:
            break

    steps = len(ep_actions)
    ep_returns = compute_returns(ep_rewards, gamma)
    storage.insert(
        env_num,
        masks=torch.stack(ep_masks),
        img_embedding=env.state[0][0],
        actions=np.asarray(ep_actions, np.int32),
        log_probs=np.asarray(ep_log_probs, np.float32),
        values=np.asarray(ep_values, np.float32),
        rewards=np.asarray(ep_rewards, np.float32),
        returns=ep_returns,
        paddings=np.zeros(steps, bool),
        advantages=_advantages(ep_rewards, ep_values, ep_returns, advantages),
    )
    return steps


def batched_rollouts(ppo_trainer, sam, images, gt_masks, init_masks, storage,
                     num_steps, gamma, advantages: str, rng):
    """Run ``len(images)`` episodes in lockstep through the vectorized env
    (one batched SAM encode + one batched decode per step) and fill the
    rollout storage.  Matches the sequential ``rollout`` semantics env-wise;
    an env that is done keeps stepping with action 2 ('stop'), which it
    ignores.
    """
    from .vector_env import VectorizedAnnotationEnvs

    n = len(images)
    envs = VectorizedAnnotationEnvs(sam, images, gt_masks, init_masks,
                                    num_steps, device=storage.device)
    traj = [dict(masks=[], actions=[], rewards=[], log_probs=[], values=[])
            for _ in range(n)]
    alive = np.ones(n, bool)

    for _ in range(num_steps):
        embs, masks224 = envs.states()
        actions, log_probs, values = ppo_trainer.act_batch(embs, masks224)
        rewards, dones = envs.step(np.where(alive, actions, 2))
        for e in range(n):
            if not alive[e]:
                continue
            traj[e]["masks"].append(masks224[e])
            traj[e]["actions"].append(int(actions[e]))
            traj[e]["rewards"].append(float(rewards[e]))
            traj[e]["log_probs"].append(float(log_probs[e]))
            traj[e]["values"].append(float(values[e]))
        alive &= ~dones
        if not alive.any():
            break

    embs, _ = envs.states()
    for e in range(n):
        t = traj[e]
        steps = len(t["actions"])
        returns = compute_returns(t["rewards"], gamma)
        storage.insert(
            e, masks=torch.stack(t["masks"]), img_embedding=embs[e],
            actions=np.asarray(t["actions"], np.int32),
            log_probs=np.asarray(t["log_probs"], np.float32),
            values=np.asarray(t["values"], np.float32),
            rewards=np.asarray(t["rewards"], np.float32),
            returns=returns, paddings=np.zeros(steps, bool),
            advantages=_advantages(t["rewards"], t["values"], returns,
                                   advantages))
    return envs
