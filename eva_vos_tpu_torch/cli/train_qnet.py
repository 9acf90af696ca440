"""QNet training CLI (counterpart of ``eva_vos_tpu/cli/train_qnet.py``).

Behavior parity target: ``train_qnet.py`` + ``util/hyper_para.py`` in the
reference — 30 epochs of 20-bin CE on the FQ dataset, SGD lr 1e-5 batch 64.
Metrics go to CSV (and wandb when available) and the final weights to
``<out>/qnet_ckpt``, a ``torch.save`` state dict in the reference layout
(``utils/checkpoint.py``).

Launched as a group (``EVAVOS_NUM_PROCESSES`` > 1, with
``EVAVOS_COORDINATOR`` and each process's ``EVAVOS_PROCESS_ID``; one
process per card, NCCL, or gloo with ``--device cpu``) it trains
data-parallel over ``make_mesh()``, as the JAX CLI trains over every local
device: each process loads only its rows of every batch.  The training
batch size must divide by the number of processes; the validation batches
split into shares that differ by at most a row (the JAX CLI's sharded
evaluation takes only batches that divide).  Rank 0 alone writes the logs
and the checkpoint.

Usage:
    python -m eva_vos_tpu_torch.cli.train_qnet --train-set subset_train_4
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import torch

from ..data.datasets import MaskQualityDB
from ..parallel.mesh import init_distributed, make_mesh
from ..train import QNetTrainer
from ..utils.checkpoint import save_checkpoint
from ..utils.config import apply_yaml_config
from ..utils.logging import MetricsLogger
from ..utils.paths import DataPaths
from ..utils.seeding import seed_everything


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--optim", type=str, default="SGD",
                   choices=["Adam", "SGD"])
    p.add_argument("--train-set", type=str, default="subset_train_4")
    p.add_argument("--arch", type=str, default="resnet18",
                   choices=["resnet50", "resnet18", "small", "resnet101"])
    p.add_argument("--out", type=str, default="model_weights/qnet")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = apply_yaml_config(build_parser(), argv)
    seed_everything()
    rng = np.random.default_rng(29102910)

    db_root = DataPaths.db_root("FQ_DB")
    train_db = MaskQualityDB(db_root, db_root / f"res_{args.train_set}.csv")
    val_db = MaskQualityDB(db_root, db_root / "res_val.csv")

    # a no-op unless EVAVOS_NUM_PROCESSES > 1
    mesh = None
    if init_distributed(backend="nccl" if torch.device(args.device).type
                        == "cuda" else "gloo"):
        mesh = make_mesh(device=args.device)
        if args.batch_size % mesh.size:
            raise ValueError(f"--batch-size {args.batch_size} does not "
                             f"divide by the {mesh.size} processes")
    part = None if mesh is None else (mesh.rank, mesh.size)
    lead = mesh is None or mesh.rank == 0
    trainer = QNetTrainer(arch=args.arch, lr=args.lr, optim=args.optim,
                          device=None if mesh else args.device, mesh=mesh)
    state = trainer.init(seed=0)
    logger = MetricsLogger("qnet", config=vars(args)) if lead else None

    n_params = sum(p.numel() for p in state.net.parameters())
    print(f"[INFO] Architecture: {args.arch}")
    print(f"[INFO] Trainable parameters: {n_params / 1e6:.2f}M")
    print(f"[INFO] Device: {trainer.device}"
          + (f" (rank {mesh.rank} of {mesh.size})" if mesh else ""))

    for epoch in range(args.epochs):
        t0 = time.time()
        tr_loss, tr_acc, n = 0.0, 0.0, 0
        for batch in train_db.batches(args.batch_size, rng=rng, part=part):
            state, metrics = trainer.train_step(state, batch)
            tr_loss += float(metrics["loss"])
            tr_acc += float(metrics["acc"])
            n += 1

        va_acc, vn = 0.0, 0
        for batch in val_db.batches(32, drop_last=False, part=part):
            metrics = trainer.eval_step(state, batch)
            va_acc += float(metrics["acc"])
            vn += 1

        if not lead:
            continue
        logger.log({
            "Train loss": tr_loss / max(n, 1),
            "Train acc": tr_acc / max(n, 1),
            "Val acc": va_acc / max(vn, 1),
        })
        print(f"[epoch {epoch + 1}/{args.epochs}] "
              f"loss={tr_loss / max(n, 1):.4f} acc={tr_acc / max(n, 1):.3f} "
              f"val_acc={va_acc / max(vn, 1):.3f} ({time.time() - t0:.1f}s)")

    if lead:
        path = os.path.join(args.out, "qnet_ckpt")
        save_checkpoint(path, state.net.state_dict())
        print(f"[done] saved to {path}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
