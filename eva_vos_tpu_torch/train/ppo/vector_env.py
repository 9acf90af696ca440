"""Vectorized annotation environments: N episodes stepped in lockstep
(counterpart of ``eva_vos_tpu/train/ppo/vector_env.py``).

The fleet shares one SAM: all N images are encoded at reset by the
predictor's ``encode_images`` (in chunks of images, so a 40-env fleet's
ViT-H encode fits the card), and each step's mask decodes go through one
``predict_batch`` over the still-active envs.  A ``SAMController`` is
routed to its predictor; a controller without one (the fake SAM) embeds
and decodes image by image.  Frames of different sizes are encoded and
decoded per size.  Click computation stays host-side per env.

Semantics per env are identical to :class:`AnnotationEnv`; rewards, costs,
warm starts and termination follow ``ppo/annotation_env.py``.  ``states``
hands the agent device tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .env import AVAIL_ACTIONS
from ...annotator.annotator import (denormalize_to_uint8,
                                    SIMILAR_IOU_THRESHOLD,
                                    MAX_WARMSTART_TRIES)
from ...annotator.robots import ClickRobot
from ...interactions.policies import masks_to_224_3ch
from ...ops.metrics import compute_iou
from ...utils.costs import ANNOTATION_COSTS


class _SamBatch:
    """Batched encode/decode over the port's ``SamPredictor`` (or a
    ``SAMController`` holding one), or image by image over any other
    controller."""

    def __init__(self, sam, device):
        self.sam = sam
        pred = sam if hasattr(sam, "encode_images") else getattr(
            sam, "predictor", None)
        self.predictor = pred if hasattr(pred, "encode_images") else None
        self.device = torch.device(device)

    def encode(self, images_u8):
        """-> embeddings [N, S, S, C] fp32 on the device."""
        self.sizes = [im.shape[:2] for im in images_u8]
        if self.predictor is not None:
            self.features = None
            for ids in self.by_size(range(len(images_u8))).values():
                feats = self.predictor.encode_images(
                    [images_u8[i] for i in ids])
                if self.features is None:
                    self.features = feats.new_empty((len(images_u8),
                                                     *feats.shape[1:]))
                self.features[torch.as_tensor(ids, device=feats.device)] = \
                    feats
            self.embeddings = self.features.float().to(self.device)
            return
        self.images = images_u8
        embs = []
        for im in images_u8:
            self.sam.reset_image()
            self.sam.set_image(im)
            embs.append(np.asarray(self.sam.get_image_embedding(), np.float32))
        self.embeddings = torch.as_tensor(np.stack(embs), device=self.device
                                          ).permute(0, 2, 3, 1)

    def by_size(self, env_ids) -> dict:
        """env ids grouped by frame size, in order."""
        groups: dict = {}
        for e in env_ids:
            groups.setdefault(self.sizes[e], []).append(e)
        return groups

    def decode(self, env_ids, prompts):
        """prompts: list of dicts aligned with env_ids.
        Returns list of (masks [n,H,W] bool, iou [n], low_res [n,l,l])."""
        if self.predictor is not None:
            prompt_of = dict(zip(env_ids, prompts))
            out = {}
            for size, ids in self.by_size(env_ids).items():
                feats = self.features[torch.as_tensor(
                    ids, device=self.features.device)]
                results = self.predictor.predict_batch(
                    feats, size, [prompt_of[e] for e in ids])
                out.update(zip(ids, results))
            return [out[e] for e in env_ids]
        out = []
        for ei, pr in zip(env_ids, prompts):
            self.sam.reset_image()
            self.sam.set_image(self.images[ei])
            masks, scores, logits = self.sam.predict(
                click_coords=pr.get("point_coords"),
                click_labels=pr.get("point_labels"),
                bbox=pr.get("box"), mask_input=pr.get("mask_input"),
                multimask_output=True)
            out.append((np.asarray(masks)[:, 0], scores, logits))
        return out


class VectorizedAnnotationEnvs:
    def __init__(self, sam, images, gt_masks, init_masks, max_steps: int,
                 device="cuda"):
        """images: [N, H, W, 3] normalized; gt/init masks: [N, H, W]."""
        self.n = len(images)
        self.max_steps = max_steps
        self.device = torch.device(device)
        self.click_robot = ClickRobot()
        self.gt = [np.asarray(g).squeeze().astype(bool) for g in gt_masks]
        self.init_masks = [np.asarray(m).squeeze() for m in init_masks]
        self.batch = _SamBatch(sam, device)
        self.batch.encode([denormalize_to_uint8(im) for im in images])
        self.reset()

    # ------------------------------------------------------------------
    def _best(self, masks, target):
        tgt = target[None]
        best_iou, best = 0.0, -1
        for i, m in enumerate(np.asarray(masks)):
            iou = compute_iou(np.asarray(m, bool).squeeze()[None], tgt)
            if iou > best_iou:
                best_iou, best = iou, i
        return best_iou, best

    def _warm_start(self):
        """Batched ``create_similar_samlogits``: every env tries to make SAM
        reproduce its initial propagated mask; still-unconverged envs keep
        refining together, one batched decode per iteration."""
        st = self.env_state
        active = []
        for e in range(self.n):
            pred = self.init_masks[e].astype(bool)
            if pred.sum() == 0:
                st[e]["sam_mask"] = np.zeros_like(self.gt[e])
                continue
            clicks, labels = self.click_robot.middle_click(pred)
            st[e]["clicks"], st[e]["labels"] = clicks, labels
            active.append(e)

        tries = 0
        self.warm_decodes = 0
        while active and tries <= MAX_WARMSTART_TRIES:
            prompts = [{"point_coords": st[e]["clicks"],
                        "point_labels": st[e]["labels"],
                        "mask_input": st[e]["logits"]} for e in active]
            results = self.batch.decode(active, prompts)
            self.warm_decodes += len(active)
            nxt = []
            for e, (masks, _, logits) in zip(active, results):
                pred = self.init_masks[e].astype(bool)
                iou, idx = self._best(masks, pred)
                st[e]["sam_mask"] = np.asarray(masks[idx]).squeeze().astype(bool)
                st[e]["logits"] = logits[idx][None]
                if iou > SIMILAR_IOU_THRESHOLD:
                    continue
                clicks, labels = self.click_robot.interact(
                    st[e]["sam_mask"], pred)
                st[e]["clicks"] = np.concatenate([st[e]["clicks"], clicks], 0)
                st[e]["labels"] = np.concatenate([st[e]["labels"], labels], 0)
                nxt.append(e)
            active = nxt
            tries += 1
        # envs that never converged start without warm-start prompts
        for e in active:
            st[e].update(sam_mask=np.zeros_like(self.gt[e]), logits=None,
                         clicks=None, labels=None)

    def reset(self):
        self.env_state = [
            dict(sam_mask=None, logits=None, clicks=None, labels=None,
                 cost=0.0, actions=[], done=False, iou=0.0, init_iou=0.0)
            for _ in range(self.n)]
        self._warm_start()
        for e, st in enumerate(self.env_state):
            st["iou"] = compute_iou(st["sam_mask"][None], self.gt[e][None])
            st["init_iou"] = st["iou"]
        return self.states()

    # ------------------------------------------------------------------
    def states(self):
        """-> (embeddings [N, 64, 64, C], masks224 [N, 224, 224, 3]), on
        the device (each frame size's masks resized together)."""
        masks224 = torch.empty((self.n, 224, 224, 3), device=self.device)
        for ids in self.batch.by_size(range(self.n)).values():
            m = np.stack([self.env_state[e]["sam_mask"] for e in ids])
            masks224[ids] = masks_to_224_3ch(
                torch.as_tensor(m, device=self.device).float())
        return self.batch.embeddings, masks224

    def step(self, actions):
        """actions [N] ints; returns (rewards [N], dones [N])."""
        st = self.env_state
        rewards = np.zeros(self.n, np.float32)
        click_envs, click_prompts = [], []

        for e, a in enumerate(actions):
            if st[e]["done"]:
                continue
            action = AVAIL_ACTIONS[int(a)]
            st[e]["actions"].append(action)
            st[e]["curr_cost"] = ANNOTATION_COSTS[action]
            st[e]["cost"] += st[e]["curr_cost"]
            st[e]["prev_iou"] = st[e]["iou"]

            if action == "click":
                if st[e]["logits"] is None:
                    clicks, labels = self.click_robot.middle_click(self.gt[e])
                else:
                    clicks, labels = self.click_robot.interact(
                        st[e]["sam_mask"], self.gt[e])
                    clicks = np.concatenate([st[e]["clicks"], clicks], 0)
                    labels = np.concatenate([st[e]["labels"], labels], 0)
                st[e]["clicks"], st[e]["labels"] = clicks, labels
                click_envs.append(e)
                click_prompts.append({"point_coords": clicks,
                                      "point_labels": labels,
                                      "mask_input": st[e]["logits"]})
            elif action == "mask":
                st[e]["sam_mask"] = self.gt[e].copy()
                st[e]["iou"] = 1.0
                st[e]["done"] = True
            else:  # stop
                st[e]["done"] = True

        if click_envs:
            results = self.batch.decode(click_envs, click_prompts)
            for e, (masks, _, logits) in zip(click_envs, results):
                iou, idx = self._best(masks, self.gt[e])
                st[e]["sam_mask"] = np.asarray(masks[idx]).squeeze().astype(bool)
                st[e]["logits"] = logits[idx][None]
                st[e]["iou"] = iou
                if len(st[e]["actions"]) == self.max_steps:
                    st[e]["done"] = True

        dones = np.zeros(self.n, bool)
        for e in range(self.n):
            s = st[e]
            if "prev_iou" not in s:
                dones[e] = s["done"]
                continue
            if s["done"]:
                if "click" in s["actions"]:
                    s["cost"] += ANNOTATION_COSTS["click_overhead"]
                rewards[e] = (0.0 if s["cost"] == 0 else
                              (s["iou"] - s["init_iou"]) / s["cost"])
            else:
                rewards[e] = (s["iou"] - s["prev_iou"]) / s["curr_cost"]
            dones[e] = s["done"]
            del s["prev_iou"]
        return rewards, dones
