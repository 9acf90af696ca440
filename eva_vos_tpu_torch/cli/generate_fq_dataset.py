"""FQ (frame-quality) dataset generator for QNet training (counterpart of
``eva_vos_tpu/cli/generate_fq_dataset.py``).

Behavior parity target: ``generate_fq_dataset.py`` + ``util/fq_dataset.py``
in the reference: run 8 oracle-mask rounds per (video, object) on MOSE,
save each round's propagated masks at 224p plus the 224p RGB frames, and a
``res_<imset>.csv`` with the per-state IoU lists; skip states where the
worst frame isn't the oracle pick (a consistency filter the reference
applies at ``generate_fq_dataset.py:72-75``).  PNGs go through
``data._png``, the CSV through the ``csv`` module.

Usage:
    python -m eva_vos_tpu_torch.cli.generate_fq_dataset --imset train --rounds 8
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ..data._png import write_png
from ..data.datasets import write_csv_rows
from ..engine import InferenceEngine
from ..engine.propagation import EngineConfig
from ..interactions.mask import oracle_mask_dataset
from ..ops.resize import resize_bicubic, resize_nearest
from ..utils.paths import DataPaths
from ..utils.seeding import seed_everything


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--imset", default="train")
    p.add_argument("--db", default="MOSE")
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--metric", default="j", choices=["j", "j_and_f"])
    p.add_argument("--min-idx", type=int)
    p.add_argument("--max-idx", type=int)
    p.add_argument("--out", default=None, help="defaults to <data>/FQ_DB")
    p.add_argument("--allow-random", action="store_true")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--device", default="cuda")
    return p


def save_state_masks(out_root: Path, state_name: str, gen_masks,
                     device="cuda"):
    """gen_masks [T, H, W] 0/1 -> 224p PNGs under Annotations/224/<state>/."""
    d = out_root / "Annotations" / "224" / state_name
    os.makedirs(d, exist_ok=True)
    m = torch.as_tensor(np.asarray(gen_masks, np.float32), device=device)
    m224 = (resize_nearest(m, (224, 224), h_axis=1, w_axis=2) * 255
            ).to(torch.uint8).cpu().numpy()
    for f in range(m224.shape[0]):
        write_png(d / f"{f:05d}.png", m224[f])


def save_frames(out_root: Path, video_name: str, images01, device="cuda"):
    d = out_root / "RGBFrames" / "224" / video_name
    if d.exists():
        return
    os.makedirs(d, exist_ok=True)
    x = torch.as_tensor(np.asarray(images01), device=device)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    im224 = resize_bicubic(x, (224, 224), h_axis=1, w_axis=2)
    im224 = (im224.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    for f in range(im224.shape[0]):
        write_png(d / f"{f:05d}.png", im224[f])


def generate_sample(rounds, engine, sample, metric, out_root: Path) -> list:
    """One (video, object): the oracle rounds, the video's 224 frames, and
    each kept state's 224 masks; -> the kept states' CSV rows."""
    gen_per_round, frames, metric_list, _times = oracle_mask_dataset(
        rounds, engine, sample, metric)
    save_frames(out_root, sample.name.split("__")[0], sample.images01,
                engine.device)
    rows = []
    for r, (gen, worst, quality) in enumerate(
            zip(gen_per_round, frames, metric_list), start=1):
        # consistency filter: keep only states whose recorded worst frame
        # is the true argmin of the iou list
        if int(np.argmin(quality)) != worst:
            continue
        state_name = f"{sample.name}_round_{r}"
        save_state_masks(out_root, state_name, gen, engine.device)
        rows.append({"state_name": state_name, "ious": str(list(quality))})
    return rows


def main(argv=None):
    args = build_parser().parse_args(argv)
    seed_everything()

    from ..utils import model_zoo

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    stcn = model_zoo.load_stcn(dtype=dtype, allow_random=args.allow_random,
                               device=args.device)
    fusion = model_zoo.load_fusion(dtype=dtype,
                                   allow_random=args.allow_random,
                                   device=args.device)
    engine = InferenceEngine(stcn, fusion,
                             EngineConfig(max_interactions=args.rounds + 2),
                             device=args.device)

    out_root = Path(args.out) if args.out else DataPaths.db_root("FQ_DB")

    if args.synthetic:
        from ..data.datasets import make_synthetic_sample

        samples = (make_synthetic_sample(t=6, h=64, w=96, seed=i)
                   for i in range(args.synthetic))
    else:
        from ..data.datasets import AnnotationDataset

        root = DataPaths.db_root(args.db)
        imset = root / "ImageSets" / f"{args.imset}.txt"
        samples = AnnotationDataset(root, imset, min_idx=args.min_idx,
                                    max_idx=args.max_idx)

    rows = []
    for sample in samples:
        kept = generate_sample(args.rounds, engine, sample, args.metric,
                               out_root)
        rows += kept
        print(f"[fq] {sample.name}: {len(kept)} states kept")

    os.makedirs(out_root, exist_ok=True)
    out_csv = out_root / f"res_{args.imset}.csv"
    write_csv_rows(out_csv, rows)
    print(f"[done] {len(rows)} states -> {out_csv}")


if __name__ == "__main__":
    main()
