"""Per-video evaluation session and quality measurement (counterpart of
``eva_vos_tpu/interactions/eval.py``).

Behavior parity targets: ``interactions/eval.py`` in the reference —
``initialize`` (frame-0 gt bootstrap, interaction-type bookkeeping) and
``eval_processor_metric`` (argmax masks, interacted-frame overrides, the
empty-gt token 20, per-frame J or J&F).

The session wraps :class:`InferenceEngine` and runs on the engine's device.
The engine copies the state on every ``interact`` unless it is told to
update it in place (``donate``), so a lookahead clone, which never donates,
leaves its parent's tensors as they were.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..engine import InferenceEngine, PropagationState, VideoFeatures
from ..engine.propagation import pad_mask, prepare_video
from ..ops.metrics import compute_iou, get_j_and_f, quality_batch
from ..ops.padding import unpad_hw
from ..utils.costs import ANNOTATION_COSTS
from ..utils.profiling import TRACE, WallClock

EMPTY_GT_TOKEN = 20


@dataclass
class VideoSample:
    """One (video, object) evaluation sample — reference ``AnnotationDataset``
    emits exactly one object per sample, so K == 1 on the eval paths.

    ``images01`` may be float in [0, 1] (the reference's ToTensor output)
    or uint8 in [0, 255]: uint8 is moved at 1 byte a pixel and scaled to
    [0, 1] on the device; the reference's own pipeline loads uint8 PNGs, so
    the float values are identical."""

    name: str
    images01: np.ndarray          # [T, H, W, 3] float in [0,1] or uint8
    gt: np.ndarray                # [K, T, H, W] uint8 one-hot
    encoder_images: Optional[np.ndarray] = None  # for l2_mask baselines

    @property
    def num_frames(self) -> int:
        return self.images01.shape[0]

    def frame_float(self, idx: int) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1] regardless of storage dtype."""
        f = self.images01[idx]
        if f.dtype == np.uint8:
            return f.astype(np.float32) / 255.0
        return f.astype(np.float32)


def _fresh_frame_record():
    return {
        "annotations": [],
        "click_labels": None,
        "click_coords": None,
        "bbox": None,
        "sam_logits": None,
        "metric": 0,
    }


@dataclass
class Session:
    engine: InferenceEngine
    feats: VideoFeatures
    state: PropagationState
    pad: tuple
    sample: VideoSample
    frame_interaction_type: np.ndarray          # 0 none / 1 gt mask / 2 SAM
    frames_list: list = field(default_factory=lambda: [0])
    mu_metrics: list = field(default_factory=list)
    annotation_times: list = field(default_factory=lambda: [ANNOTATION_COSTS["mask"]])
    masks_from_sam: dict = field(default_factory=dict)
    pf_annots: list = field(default_factory=list)
    timers: WallClock = field(default_factory=WallClock)
    gt_dev: Optional[torch.Tensor] = None   # [T, H, W] bool gt on the device
    sam_dev: Optional[torch.Tensor] = None  # device mirror of masks_from_sam
    sam_dirty: set = field(default_factory=set)  # frames to mirror
    # The round loop replaces ``state`` every interact, so the engine may
    # update its tensors in place (no copy of the prob volume and the bank a
    # round).  Cloned (lookahead) sessions share the parent's state tensors
    # and MUST NOT: clone() sets False.
    donate: bool = True

    @property
    def num_frames(self) -> int:
        return self.sample.num_frames

    def gt_mask(self, idx: int) -> np.ndarray:
        """[K, H, W] float ground truth for frame idx."""
        return self.sample.gt[:, idx].astype(np.float32)

    def interact(self, mask: np.ndarray, idx: int):
        """mask [K, H, W] (unpadded) -> propagate; replaces the state."""
        with self.timers.span("propagate"):
            self.state = self.engine.interact(
                self.state, self.feats,
                pad_mask(mask, self.pad, device=self.engine.device), idx,
                donate=self.donate)
            if self.state.prob.is_cuda:
                torch.cuda.synchronize()

    def clone(self) -> "Session":
        """Cheap lookahead copy: shares features, copies bookkeeping.  It
        shares the parent's state tensors and never donates them, so its
        interacts leave them alone.  It shares the device gt (never
        written) but not the SAM mirror, which flushes write in place: the
        clone rebuilds its own from its stored SAM masks at its first
        evaluation."""
        return Session(
            engine=self.engine, feats=self.feats, state=self.state,
            pad=self.pad, sample=self.sample,
            frame_interaction_type=self.frame_interaction_type.copy(),
            frames_list=list(self.frames_list),
            mu_metrics=list(self.mu_metrics),
            annotation_times=list(self.annotation_times),
            masks_from_sam=dict(self.masks_from_sam),
            pf_annots=copy.deepcopy(self.pf_annots),
            gt_dev=self.gt_dev, sam_dev=None,
            sam_dirty=set(self.masks_from_sam),
            donate=False,
        )


# Most recent session, for observability hooks (the policy functions return
# the reference's result tuples, not the session).
LAST_SESSION: Optional[Session] = None


# Per-video feature cache: the reference recomputes features inside every
# policy call (``eval.py:92-118`` re-builds the InferenceCore per call), so
# an eva_vos run would pay the video upload and encode once per POLICY
# invocation.  Features are deterministic per (engine, video, dtype), so
# repeated policy calls on the same sample object reuse them.  Keyed by
# object identity with the array held strongly (no id reuse); 2 entries
# cover the current and previous video of a sequential eval run.
_FEATURE_CACHE: dict = {}
_FEATURE_CACHE_MAX = 2


def initialize(engine: InferenceEngine, sample: VideoSample,
               dtype=None) -> Session:
    """Build the per-video session (reference ``eval.py:92-118``).

    Bookkeeping marks frame 0 as mask-annotated, but the actual frame-0
    interaction is performed by the policy loop's first round, exactly like
    the reference.  ``dtype`` (a ``torch.dtype``) defaults to the engine's
    compute dtype; the features live on the engine's device.
    """
    dtype = dtype or engine.stcn.dtype
    key = (id(engine), id(sample.images01), str(dtype))
    hit = _FEATURE_CACHE.get(key)
    if hit is not None and hit[0] is sample.images01:
        TRACE.count("feature_cache_hits")
        feats, pad = hit[1], hit[2]
    else:
        TRACE.count("feature_cache_misses")
        images, pad = prepare_video(sample.images01, dtype=dtype,
                                    device=engine.device)
        feats = engine.precompute_features(images)
        while len(_FEATURE_CACHE) >= _FEATURE_CACHE_MAX:
            _FEATURE_CACHE.pop(next(iter(_FEATURE_CACHE)))
        _FEATURE_CACHE[key] = (sample.images01, feats, pad)
    state = engine.init_state(feats, sample.gt.shape[0])

    t = sample.num_frames
    session = Session(
        engine=engine, feats=feats, state=state, pad=pad, sample=sample,
        frame_interaction_type=np.zeros((t,)),
        pf_annots=[_fresh_frame_record() for _ in range(t)],
    )
    session.frame_interaction_type[0] = 1
    global LAST_SESSION
    LAST_SESSION = session
    return session


def eval_session_metric(session: Session, metric: str = "j"):
    """Quality of every frame after the latest interaction.

    Returns (mean quality over non-empty frames, gen_masks [T, H, W] float,
    frame_quality, frame_quality_all) — the reference's
    ``eval_processor_metric`` contract, including:
    * interacted type-1 frames override the prediction with gt,
    * type-2 frames override with the stored SAM mask,
    * empty-gt frames contribute the token 20 to ``frame_quality_all`` only.

    ``gen_masks`` is a float32 tensor on the engine's device, or a numpy
    array under ``EVAVOS_HOST_METRICS`` (the host loop, end to end).
    """
    assert metric in {"j", "j_and_f"}
    with session.timers.span(f"eval[{metric}]"):
        return _eval_session_metric(session, metric)


def _device_gen_masks(prob, gt, sam, itype, pad):
    """Argmax masks + interacted-frame overrides, on the device.

    Semantics identical to the host loop above the metric in the reference
    (``eval.py:57-64``): type-1 frames take the (bool) gt, type-2 frames the
    stored SAM mask.  ``gen_masks`` stays on the device, so no [T, H, W]
    volume goes to the host and back for the overrides, the metric or the
    QNet's mask resize."""
    gen = torch.argmax(unpad_hw(prob, pad), dim=0) > 0  # K == 1 on eval paths
    t1 = (itype == 1)[:, None, None]
    t2 = (itype == 2)[:, None, None]
    return torch.where(t1, gt, torch.where(t2, sam > 0, gen)).float()


def _flush_sam_dev(session: Session):
    """Mirror newly stored SAM masks into the session's device buffer (one
    indexed copy per dirty frame)."""
    t = session.num_frames
    h, w = session.sample.gt.shape[2:]
    if session.sam_dev is None:
        session.sam_dev = torch.zeros((t, h, w), dtype=torch.float32,
                                      device=session.engine.device)
    for f in sorted(session.sam_dirty):
        m = np.asarray(session.masks_from_sam[f], np.float32).squeeze()
        session.sam_dev[f] = torch.as_tensor(m, device=session.sam_dev.device)
    session.sam_dirty.clear()


def _eval_session_metric(session: Session, metric: str):
    gt_all = session.sample.gt[0]
    gt_sums = gt_all.reshape(gt_all.shape[0], -1).astype(bool).sum(axis=1)

    if os.environ.get("EVAVOS_HOST_METRICS"):
        # host cross-check path: the original per-frame loop, end to end
        ids = session.engine.masks_from_prob(session.state.prob, session.pad)
        gen_masks = (ids > 0).astype(np.float32)
        for f in set(session.frames_list):
            if session.frame_interaction_type[f] == 1:
                gen_masks[f] = gt_all[f].astype(bool)
            elif session.frame_interaction_type[f] == 2:
                gen_masks[f] = np.asarray(
                    session.masks_from_sam[f]).squeeze().astype(bool)
        qs = [compute_iou(gen_masks[f].astype(bool)[None],
                          gt_all[f].astype(bool)[None]) if metric == "j"
              else get_j_and_f(gt_all[f].astype(bool)[None],
                               gen_masks[f].astype(bool)[None])
              for f in range(session.num_frames)]
        qs = np.asarray(qs, np.float64)
    else:
        # device path: masks, overrides, and metric counts stay on the
        # device; only the [T, 2] (or [T, 6]) count matrix is fetched.
        # Bit-equal to the host loop (integer counts on the device, float64
        # assembly on the host).
        dev = session.engine.device
        if session.gt_dev is None:
            session.gt_dev = torch.as_tensor(gt_all.astype(bool), device=dev)
        _flush_sam_dev(session)
        itype = torch.as_tensor(session.frame_interaction_type,
                                dtype=torch.int32, device=dev)
        gen_masks = _device_gen_masks(session.state.prob, session.gt_dev,
                                      session.sam_dev, itype, session.pad)
        qs = quality_batch(session.gt_dev, gen_masks.bool(), metric)

    frame_quality, frame_quality_all = [], []
    for f in range(session.num_frames):
        if gt_sums[f] == 0:
            frame_quality_all.append(EMPTY_GT_TOKEN)
            continue
        q = float(qs[f])
        frame_quality.append(q)
        frame_quality_all.append(q)

    mu = float(np.mean(frame_quality)) if frame_quality else float("nan")
    return mu, gen_masks, frame_quality, frame_quality_all


def as_host(x) -> np.ndarray:
    """A mask stack or mask as a numpy array: a tensor is copied from its
    device (``gen_masks`` lies there unless the host loop made it)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def not_avail_frames(ious, interacted_frames, num_frames) -> bool:
    """True when every frame is either interacted or has an empty gt."""
    empty = set(np.where(np.asarray(ious) == EMPTY_GT_TOKEN)[0].tolist())
    blocked = empty | set(interacted_frames)
    return len(set(range(num_frames)) - blocked) == 0
