"""Dataset acquisition + preprocessing (counterpart of
``eva_vos_tpu/cli/download_data.py``).

Behavior parity target: ``download_data.py`` + ``scripts/resize.py`` in the
reference: fetch MOSE train.tar.gz, resize to 480p (bicubic frames, nearest
masks), keep videos with 16..104 frames, and split 800 train / 150 val /
remainder test with seed 292910.

Nothing is fetched here: given the archive (``--archive``), or an
extracted ``raw/`` tree under the MOSE root, this runs the same
extract, resize, filter and split.  PIL does the resizing, as in the JAX
package, and is imported by the workers that resize.

Usage:
    python -m eva_vos_tpu_torch.cli.download_data --archive /path/to/train.tar.gz
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import tarfile
from pathlib import Path

import numpy as np

from ..utils.paths import DataPaths

SPLIT_SEED = 292910
MIN_FRAMES, MAX_FRAMES = 16, 104
N_TRAIN, N_VAL = 800, 150
MOSE_URL_ID = "10HYO-CJTaITalhzl_Zbz_Qpesh8F3gZR"  # gdown id in the reference


def resize_video(task):
    """Resize one video's frames (bicubic) and masks (nearest) to 480p."""
    from PIL import Image

    src_img, src_msk, dst_img, dst_msk = task
    os.makedirs(dst_img, exist_ok=True)
    os.makedirs(dst_msk, exist_ok=True)
    for f in sorted(os.listdir(src_img)):
        im = Image.open(Path(src_img) / f)
        w, h = im.size
        nh = 480
        nw = int(round(w * 480 / h))
        im.resize((nw, nh), Image.BICUBIC).save(Path(dst_img) / f)
    for f in sorted(os.listdir(src_msk)):
        m = Image.open(Path(src_msk) / f)
        w, h = m.size
        nw = int(round(w * 480 / h))
        m.resize((nw, 480), Image.NEAREST).save(Path(dst_msk) / f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archive", default=None,
                    help="path to a pre-downloaded MOSE train.tar.gz")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    root = DataPaths.db_root("MOSE")
    raw = root / "raw"
    os.makedirs(root, exist_ok=True)

    if args.archive:
        print(f"extracting {args.archive}")
        with tarfile.open(args.archive) as tf:
            tf.extractall(raw, filter="data")
    elif not raw.exists():
        raise SystemExit(
            "No network egress in this environment: download MOSE "
            f"train.tar.gz (gdown id {MOSE_URL_ID}) elsewhere and pass "
            "--archive /path/to/train.tar.gz")

    src_images = raw / "train" / "JPEGImages"
    src_masks = raw / "train" / "Annotations"
    tasks = []
    for video in sorted(os.listdir(src_images)):
        tasks.append((src_images / video, src_masks / video,
                      root / "JPEGImages" / "480p" / video,
                      root / "Annotations" / "480p" / video))
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        pool.map(resize_video, tasks)

    # filter by frame count + split
    videos = []
    for video in sorted(os.listdir(root / "JPEGImages" / "480p")):
        n = len(os.listdir(root / "JPEGImages" / "480p" / video))
        if MIN_FRAMES <= n <= MAX_FRAMES:
            videos.append(video)
    rng = np.random.RandomState(SPLIT_SEED)
    rng.shuffle(videos)
    splits = {"train": videos[:N_TRAIN],
              "val": videos[N_TRAIN:N_TRAIN + N_VAL],
              "test": videos[N_TRAIN + N_VAL:]}
    os.makedirs(root / "ImageSets", exist_ok=True)
    for name, vids in splits.items():
        with open(root / "ImageSets" / f"{name}.txt", "w") as fh:
            fh.write("\n".join(vids) + "\n")
        print(f"{name}: {len(vids)} videos")


if __name__ == "__main__":
    main()
