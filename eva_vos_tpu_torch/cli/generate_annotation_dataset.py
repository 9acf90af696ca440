"""Annotation-type dataset generator for PPO training (counterpart of
``eva_vos_tpu/cli/generate_annotation_dataset.py``).

Behavior parity target: ``generate_annotation_dataset.py`` in the
reference: per (video, object), run rounds of oracle frame selection
(argmin quality) with ``oracle_action`` over {3clicks, mask}; persist each
state's image + propagated-mask PNGs, its SAM image embedding (.npy,
[256, 64, 64]), and a CSV with the per-action rewards and the selection.

Usage:
    python -m eva_vos_tpu_torch.cli.generate_annotation_dataset --imset train
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from ..annotator import Annotator
from ..data._png import write_png
from ..data.datasets import write_csv_rows
from ..engine import InferenceEngine
from ..engine.propagation import EngineConfig
from ..interactions.eval import (as_host, eval_session_metric, initialize,
                                 not_avail_frames)
from ..interactions.multiple import (_frame_image, oracle_action,
                                     store_action_data)
from ..utils.costs import ANNOTATION_COSTS
from ..utils.paths import DataPaths
from ..utils.seeding import seed_everything


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--imset", default="train")
    p.add_argument("--db", default="MOSE")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--types", nargs="+", default=["3clicks", "mask"])
    p.add_argument("--metric", default="j", choices=["j", "j_and_f"])
    p.add_argument("--min-idx", type=int)
    p.add_argument("--max-idx", type=int)
    p.add_argument("--out", default=None, help="defaults to <data>/AnnotDB")
    p.add_argument("--sam", default="vit_h")
    p.add_argument("--allow-random", action="store_true")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def save_png(path: Path, arr: np.ndarray):
    os.makedirs(path.parent, exist_ok=True)
    write_png(path, arr)


def generate_sample(sample, engine, annotator, rounds, types, metric_name,
                    out_root: Path) -> list:
    """One (video, object): ``rounds`` rounds of oracle frame selection and
    oracle annotation; each state after the first round is written (image,
    propagated mask, SAM embedding); -> their CSV rows."""
    session = initialize(engine, sample)
    if hasattr(annotator, "clear_sam_cache"):
        annotator.clear_sam_cache()  # cache keys are per-video frames
    metric = None
    gen_masks = None
    video_cost = 0.0
    rows = []
    for r in range(1, rounds + 1):
        if metric is not None and not_avail_frames(
                metric, session.frames_list, session.num_frames):
            continue
        frame = session.frames_list[-1]
        if r > 1:
            im = _frame_image(session, frame)
            mivos_mask = as_host(gen_masks[frame])
            # persist the pre-annotation state
            state_id = f"{sample.name}_f{frame}_r{r}"
            img_u8 = (np.clip(sample.frame_float(frame), 0, 1) * 255
                      ).astype(np.uint8)
            save_png(out_root / "Images" / f"{state_id}.png", img_u8)
            save_png(out_root / "Masks" / f"{state_id}.png",
                     (mivos_mask * 255).astype(np.uint8))

            annotator.set_image_to_sam(im, cache_key=frame)
            emb = np.asarray(annotator.sam.get_image_embedding(), np.float32)
            os.makedirs(out_root / "SAM_Embeddings", exist_ok=True)
            np.save(out_root / "SAM_Embeddings" / f"{state_id}.npy", emb)

            sam_mask, cost, action, logits, clicks, labels, bbox, adata = \
                oracle_action(annotator, types, session.sample.gt[0, frame],
                              mivos_mask, im, session.pf_annots[frame],
                              frame_num=frame, return_action_data=True)
            mask = store_action_data(session, frame, action, sam_mask,
                                     clicks, labels, bbox, logits)
            video_cost += cost
            row = {"id": state_id, "video_name": sample.name,
                   "frame_num": frame, "frame_cost": cost,
                   "video_cost": video_cost,
                   "selected_annotation": action,
                   "init_iou": adata["init_iou"]}
            for t in types:
                if t in adata:
                    row[f"{t}_iou"] = adata[t]["iou"]
                    row[f"{t}_reward"] = adata[t]["reward"]
            rows.append(row)
        else:
            mask = session.gt_mask(frame)
            video_cost += ANNOTATION_COSTS["mask"]

        session.pf_annots[frame]["annotations"].append(
            "mask" if r == 1 else action)
        session.interact(mask, frame)
        _, gen_masks, _, metric = eval_session_metric(session, metric_name)
        for ii, mq in enumerate(metric):
            session.pf_annots[ii]["metric"] = mq
        session.frames_list.append(int(np.argmin(metric)))
    return rows


def main(argv=None):
    args = build_parser().parse_args(argv)
    seed_everything()

    from ..utils import model_zoo

    stcn = model_zoo.load_stcn(allow_random=args.allow_random,
                               device=args.device)
    fusion = model_zoo.load_fusion(allow_random=args.allow_random,
                                   device=args.device)
    engine = InferenceEngine(stcn, fusion,
                             EngineConfig(max_interactions=args.rounds + 2),
                             device=args.device)
    sam = model_zoo.load_sam(args.sam, allow_random=args.allow_random,
                             device=args.device)
    annotator = Annotator(sam)

    out_root = Path(args.out) if args.out else DataPaths.db_root("AnnotDB")

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
        rows += generate_sample(sample, engine, annotator, args.rounds,
                                args.types, args.metric, out_root)
        print(f"[annot-db] {sample.name}")

    os.makedirs(out_root, exist_ok=True)
    out_csv = out_root / f"{args.imset}.csv"
    write_csv_rows(out_csv, rows)
    print(f"[done] {len(rows)} states -> {out_csv}")


if __name__ == "__main__":
    main()
