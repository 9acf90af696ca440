"""Datasets over the reference's on-disk layouts (counterpart of
``eva_vos_tpu/data/datasets.py``; numpy, on the host).

* ``AnnotationDataset`` — DAVIS/MOSE video+object samples (one sample per
  (video, object), video title ``<video>__<obj_id>``).
* ``MaskQualityDB`` — QNet training pairs from the FQ dataset (224p
  states, 20-bin IoU labels, empty-gt rows dropped).
* ``AnnotTypeDB`` — PPO training states (image, propagated mask,
  precomputed SAM embedding, gt mask), with corrupt-image dropping and
  per-epoch <= sample_size states per video resampling.

CSVs go through the ``csv`` module and PNGs through ``_png``; the items
equal the JAX readers' (pandas and PIL) on the same tree.  Only
``AnnotationDataset``'s JPEG frames need PIL, imported when one is read; a
frame file that holds PNG bytes reads without it, whatever its suffix.
"""

from __future__ import annotations

import ast
import csv
import os
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ._png import PNG_SIGNATURE, imread_palette, imread_rgb01 as _png_rgb01
from .synthetic import synthetic_video
from ..ops.masks import all_to_onehot
from ..interactions.eval import VideoSample

IOU_BINS = np.arange(0, 1.01, 0.05)
EMPTY_GT_TOKEN = 20


def _imread_rgb01(path) -> np.ndarray:
    """A frame as [H, W, 3] float32 in [0, 1].  The file's first bytes
    decide, as PIL's ``open`` does: PNG bytes go through ``_png`` whatever
    the suffix, anything else through PIL."""
    with open(path, "rb") as fh:
        if fh.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE:
            return _png_rgb01(path)
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(f"reading {path} needs PIL (Pillow), which only "
                          f"the JPEG frames of a real dataset tree "
                          f"use") from exc
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def read_csv_rows(path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def write_csv_rows(path, rows: list[dict]):
    """Rows under the union of their keys in order of first appearance
    (a missing value is an empty field), as ``pd.DataFrame(rows).to_csv(
    index=False)`` lays them out."""
    keys = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys, restval="",
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


class AnnotationDataset:
    """Video annotation dataset for MOSE / DAVIS.

    Iterates :class:`VideoSample` objects — one per (video, object id) —
    with ``min_idx``/``max_idx`` slicing for embarrassingly-parallel
    experiment sharding across hosts (reference ``--min-idx/--max-idx``).
    """

    def __init__(self, root, imset, resolution="480p", min_idx=None,
                 max_idx=None, encoder_transform=None):
        self.root = Path(root)
        self.mask_dir = self.root / "Annotations" / resolution
        self.image_dir = self.root / "JPEGImages" / resolution
        self.encoder_transform = encoder_transform

        self.samples = []  # (video_title, video, obj_id, n_frames)
        ii = 0
        with open(imset) as fh:
            for line in fh:
                video = line.strip()
                if not video:
                    continue
                first = imread_palette(self.mask_dir / video / "00000.png")
                n_objs = int(first.max())
                n_frames = len(os.listdir(self.image_dir / video))
                for obj_id in range(1, n_objs + 1):
                    in_range = not (min_idx is not None and max_idx is not None
                                    and (ii < min_idx or ii > max_idx))
                    if in_range:
                        self.samples.append(
                            (f"{video}__{obj_id}", video, obj_id, n_frames))
                    ii += 1

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index) -> VideoSample:
        title, video, obj_id, n_frames = self.samples[index]
        images, masks = [], []
        for f in range(n_frames):
            images.append(_imread_rgb01(self.image_dir / video / f"{f:05d}.jpg"))
            masks.append(imread_palette(self.mask_dir / video / f"{f:05d}.png"))
        images = np.stack(images)
        gt = all_to_onehot(np.stack(masks), [obj_id])

        enc = None
        if self.encoder_transform is not None:
            enc = np.stack([self.encoder_transform(im) for im in images])
        return VideoSample(name=title, images01=images, gt=gt,
                           encoder_images=enc)

    def __iter__(self) -> Iterator[VideoSample]:
        for i in range(len(self)):
            yield self[i]


class MaskQualityDB:
    """QNet training set: (224p frame, 224p mask, 20-bin IoU label)."""

    def __init__(self, root, csv_set, resolution="224"):
        self.root = Path(root)
        self.mask_dir = self.root / "Annotations" / resolution
        self.image_dir = self.root / "RGBFrames" / resolution

        self.items = []  # (state_name, iou, frame_num)
        for row in read_csv_rows(csv_set):
            ious = np.asarray(ast.literal_eval(row["ious"]))
            frames = np.arange(len(ious))
            keep = ious != EMPTY_GT_TOKEN
            for iou, fnum in zip(ious[keep], frames[keep]):
                self.items.append((row["state_name"], float(iou), int(fnum)))

    def __len__(self):
        return len(self.items)

    @staticmethod
    def iou_to_label(iou: float) -> int:
        """Discretize into 20 bins over [0, 1] (bin i covers
        [0.05i, 0.05(i+1)]; boundaries go to the lower bin, matching the
        reference's first-match scan)."""
        for i in range(1, len(IOU_BINS)):
            if IOU_BINS[i - 1] <= iou <= IOU_BINS[i]:
                return i - 1
        raise ValueError(f"invalid iou {iou}")

    def __getitem__(self, index):
        state, iou, frame_num = self.items[index]
        mask = imread_palette(self.mask_dir / state / f"{frame_num:05d}.png")
        mask = mask.astype(np.float32) / 255.0
        video = state.split("__")[0]
        img = _imread_rgb01(self.image_dir / video / f"{frame_num:05d}.png")
        return {"img": img, "mask": mask,
                "label": self.iou_to_label(iou)}

    def batches(self, batch_size, rng: Optional[np.random.Generator] = None,
                drop_last=True, part: Optional[tuple] = None):
        """Batches of ``batch_size`` rows in ``rng``'s order.  ``part``
        (rank, size): only that rank's contiguous share of each batch is
        loaded (shares differ by at most a row)."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        end = len(self) - (len(self) % batch_size) if drop_last else len(self)
        for start in range(0, end, batch_size):
            idx = order[start:start + batch_size]
            if part is not None:
                idx = np.array_split(idx, part[1])[part[0]]
            items = [self[i] for i in idx]
            rows = len(items)
            if not items:       # a share of a batch smaller than the group
                items = [self[order[start]]]
            yield {
                "img": np.stack([it["img"] for it in items])[:rows],
                "mask": np.stack([it["mask"] for it in items])[:rows],
                "label": np.asarray([it["label"] for it in items],
                                    np.int32)[:rows],
            }


class AnnotTypeDB:
    """PPO training states: image + propagated mask + SAM embedding + gt."""

    def __init__(self, root, imset, sample_size: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None):
        self.root = Path(root)
        self.image_dir = self.root / "Images"
        self.mask_dir = self.root / "Masks"
        self.embeddings_dir = self.root / "SAM_Embeddings"
        mose_root = Path(str(root).replace("AnnotDB", "MOSE"))
        self.gt_annotation_dir = mose_root / "Annotations" / "480p"
        self.sample_size = sample_size
        self.rng = rng or np.random.default_rng(29102910)

        self.rows = []
        for row in read_csv_rows(self.root / f"{imset}.csv"):
            try:
                _imread_rgb01(self.image_dir / f"{row['id']}.png")
            except OSError:
                continue
            self.rows.append(row)
        self.sample_df()

    def sample_df(self):
        """Resample <= sample_size states per video (per epoch), in the
        order of pandas' ``groupby("video_name")`` (videos sorted) and
        ``DataFrame.sample(n, random_state=seed)`` (the first n of a
        ``RandomState(seed)`` permutation), one seed a video from ``rng``."""
        if self.sample_size is None:
            self.active = self.rows
            return
        groups: dict[str, list] = {}
        for row in self.rows:
            groups.setdefault(row["video_name"], []).append(row)
        self.active = []
        for video in sorted(groups):
            group = groups[video]
            n = min(len(group), self.sample_size)
            seed = int(self.rng.integers(2 ** 31))
            pick = np.random.RandomState(seed).permutation(len(group))[:n]
            self.active += [group[i] for i in pick]

    def __len__(self):
        return len(self.active)

    def __getitem__(self, index):
        row = self.active[index]
        state_id = row["id"]
        mask = imread_palette(self.mask_dir / f"{state_id}.png")
        mask = mask.astype(np.float32) / 255.0
        img = _imread_rgb01(self.image_dir / f"{state_id}.png")
        emb = np.load(self.embeddings_dir / f"{state_id}.npy")

        video_name, label = row["video_name"].split("__")
        frame_num = int(float(row["frame_num"]))
        gt = imread_palette(
            self.gt_annotation_dir / video_name / f"{frame_num:05d}.png")
        gt = all_to_onehot(gt, [int(label)])[0, 0]
        return {"img": img, "mask": mask, "sam_embedding": emb,
                "gt_mask": gt.astype(np.float32)}


def make_synthetic_sample(t=5, h=48, w=64, seed=0, empty_frame=None
                          ) -> VideoSample:
    """Test/bench helper: a VideoSample without any dataset on disk."""
    images, masks = synthetic_video(t, h, w, num_objects=1, seed=seed)
    if empty_frame is not None:
        masks = masks.copy()
        masks[0, empty_frame] = 0
    return VideoSample(name=f"synthetic_{seed}__1", images01=images, gt=masks)
