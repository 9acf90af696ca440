"""PPO annotation-type agent training CLI (counterpart of
``eva_vos_tpu/cli/train_rl_agent.py``).

Behavior parity target: ``train_rl_agent.py`` + ``config/rl_agent.yaml`` in
the reference: 7e4 rollouts over 40-env batches of 5-step episodes, PPO
with clip 0.2 / gamma 0.95 / GAE, resume support, best-reward model saved
separately, per-iteration checkpoint, per-epoch dataset resampling.
Checkpoints are ``torch.save`` state dicts in the reference layout:
``<out>/model`` (the best mean reward) and ``<out>/_checkpoint`` (each
pass, with ``iters`` and ``max_reward``; no optimizer state is resumed).

Usage:
    python -m eva_vos_tpu_torch.cli.train_rl_agent --rollouts 70000
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.datasets import AnnotTypeDB
from ..ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from ..train.ppo import RolloutStorage, rollout, batched_rollouts, PPOTrainer
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.config import apply_yaml_config
from ..utils.logging import MetricsLogger
from ..utils.paths import DataPaths
from ..utils.seeding import seed_everything


def build_parser():
    p = argparse.ArgumentParser()
    # mirrors config/rl_agent.yaml
    p.add_argument("--rollouts", type=float, default=7e4)
    p.add_argument("--imset", default="subset_train_4")
    p.add_argument("--num-envs", type=int, default=40)
    p.add_argument("--num-steps", type=int, default=5)
    p.add_argument("--mini-batch", type=int, default=10)
    p.add_argument("--action-space", type=int, default=2, choices=[2, 3])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--no-sample", action="store_true")
    p.add_argument("--ppo-epochs", type=int, default=40)
    p.add_argument("--clip-param", type=float, default=0.2)
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--value-loss-coef", type=float, default=0.5)
    p.add_argument("--entropy-coef", type=float, default=1e-4)
    p.add_argument("--target-kl-div", type=float, default=0.02)
    p.add_argument("--advantages", default="gae", choices=["gae", "diff"])
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--optim", default="Adam", choices=["Adam", "SGD"])
    p.add_argument("--arch", default="resnet18")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--sam", default="vit_h",
                   help="'vit_h'/'vit_l'/'vit_b' or 'fake' for smoke runs")
    p.add_argument("--sequential", action="store_true",
                   help="step the envs one by one (the reference's loop, "
                        "train_rl_agent.py:86-106) instead of the default "
                        "vectorized fleet (one chunked SAM encode per batch, "
                        "one batched decode per step)")
    p.add_argument("--allow-random", action="store_true")
    p.add_argument("--out", default="model_weights/rl_agent")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = apply_yaml_config(build_parser(), argv)
    seed_everything()
    rng = np.random.default_rng(29102910)

    from ..utils import model_zoo

    sam_controller = model_zoo.load_sam(args.sam,
                                        allow_random=args.allow_random,
                                        device=args.device)

    root = DataPaths.db_root("AnnotDB")
    sample_size = None if args.no_sample else 5
    train_db = AnnotTypeDB(root=root, imset=args.imset,
                           sample_size=sample_size, rng=rng)
    print(f"[DB INFO] Number of images: {len(train_db)}")
    if len(train_db) < args.num_envs:
        raise ValueError(f"{len(train_db)} states for {args.num_envs} envs")

    trainer = PPOTrainer(
        action_space=args.action_space, ppo_epochs=args.ppo_epochs,
        clip_param=args.clip_param, value_loss_coef=args.value_loss_coef,
        entropy_coef=args.entropy_coef, target_kl_div=args.target_kl_div,
        lr=args.lr, optim_str=args.optim, arch=args.arch,
        dropout=args.dropout, device=args.device)
    storage = RolloutStorage(num_envs=args.num_envs, num_steps=args.num_steps,
                             num_mini_batch=args.mini_batch,
                             device=args.device)
    logger = MetricsLogger("eva-vos-rl-agent", config=vars(args))

    os.makedirs(args.out, exist_ok=True)
    ckpt_path = os.path.join(args.out, "_checkpoint")
    iters, max_reward = 0, -1e10
    if args.resume and os.path.exists(ckpt_path):
        sd, extra = restore_checkpoint(ckpt_path)
        trainer.net.load_state_dict(sd)
        iters, max_reward = int(extra["iters"]), float(extra["max_reward"])
        print(f"Model is loaded! {iters} with max reward: {max_reward:.0e}")

    def normalize(img01):
        return (img01 - IMAGENET_MEAN) / IMAGENET_STD

    while iters < args.rollouts:
        order = rng.permutation(len(train_db))
        avg_loss, avg_reward, batches = 0.0, 0.0, 0
        for start in range(0, len(order) - args.num_envs + 1, args.num_envs):
            items = [train_db[int(di)]
                     for di in order[start:start + args.num_envs]]
            if args.sequential:
                for e, item in enumerate(items):
                    rollout(trainer, sam_controller, normalize(item["img"]),
                            item["gt_mask"], item["mask"], e, storage,
                            args.num_steps, args.gamma, args.advantages, rng)
            else:
                # the fleet shares one chunked SAM encode and one batched
                # decode per step (vector_env.py); env-wise semantics are
                # lockstep-equal to the sequential path
                batched_rollouts(
                    trainer, sam_controller,
                    [normalize(item["img"]) for item in items],
                    [item["gt_mask"] for item in items],
                    [item["mask"] for item in items],
                    storage, args.num_steps, args.gamma, args.advantages,
                    rng)
            iters += len(items)
            avg_reward += storage.mean_valid_reward()
            avg_loss += trainer.optimize(storage, rng)
            batches += 1
            if iters >= args.rollouts:
                break

        avg_loss /= max(batches, 1)
        avg_reward /= max(batches, 1)
        logger.log({"Reward": avg_reward, "Loss": avg_loss, "Iters": iters})
        print(f"[{iters:.0f}/{args.rollouts:.0f}] reward={avg_reward:.4f} "
              f"loss={avg_loss:.4f}")

        if avg_reward >= max_reward:
            max_reward = avg_reward
            save_checkpoint(os.path.join(args.out, "model"),
                            trainer.net.state_dict())
        save_checkpoint(ckpt_path, trainer.net.state_dict(), iters=iters,
                        max_reward=max_reward)
        train_db.sample_df()
    return trainer


if __name__ == "__main__":
    main()
