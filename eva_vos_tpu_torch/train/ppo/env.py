"""Single-frame annotation MDP for PPO training (counterpart of
``eva_vos_tpu/train/ppo/env.py``).

Behavior parity target: ``ppo/annotation_env.py`` — state is the SAM image
embedding plus the current SAM mask at 224p; actions are click / mask /
stop; rewards are IoU gains per second of annotation cost, with the
click-overhead charge and the terminal total-efficiency reward.  The SAM
controller is injected and reused across episodes; ``reset`` re-embeds
only the new frame.

The masks, the clicks and the IoUs stay on the host (the click robot and
the rewards are host code); the state handed to the agent, ``[embedding
[1, 64, 64, C], mask224 [1, 224, 224, 3]]``, lies on ``device``: SAM's
embedding is taken where the predictor left it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...annotator.annotator import Annotator
from ...annotator.robots import ClickRobot
from ...interactions.policies import masks_to_224_3ch
from ...ops.metrics import compute_iou
from ...utils.costs import ANNOTATION_COSTS

AVAIL_ACTIONS = ("click", "mask", "stop")


def sam_embedding(sam, device) -> torch.Tensor:
    """The controller's image embedding, channel-last [S, S, C] fp32 on
    ``device``: SAM's features where its predictor holds them, else the
    controller's host array (the fake SAM's)."""
    features = getattr(getattr(sam, "predictor", None), "features", None)
    if features is not None:
        return features.float().to(device)
    return torch.as_tensor(np.asarray(sam.get_image_embedding(), np.float32),
                           device=device).permute(1, 2, 0)


class AnnotationEnv:
    def __init__(self, sam_controller, image, gt_mask, init_mask, max_steps,
                 use_cost: bool = False, device="cuda"):
        """image [H, W, 3] normalized; gt_mask/init_mask [H, W] (or [1, H, W])."""
        self.annotator = Annotator(sam_controller)
        self.click_robot = ClickRobot()
        self.device = torch.device(device)
        self.image = np.asarray(image)
        self.gt_mask = np.asarray(gt_mask).squeeze().astype(bool)
        self.init_mask = np.asarray(init_mask).squeeze()
        self.use_cost = use_cost
        self.max_steps = max_steps
        self.avail_actions = AVAIL_ACTIONS
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        self.annotator.set_image_to_sam(self.image)
        self.img_embedding = sam_embedding(self.annotator.sam, self.device)

        logits, sam_mask, clicks, labels = \
            self.annotator.create_similar_samlogits(
                self.init_mask.astype(bool))
        if sam_mask is None:
            sam_mask = np.zeros_like(self.gt_mask)

        self.sam_logits = logits
        self.sam_mask = np.asarray(sam_mask).squeeze().astype(bool)
        self.prompt_clicks = clicks
        self.prompt_labels = labels
        self.iou = compute_iou(self.sam_mask[None], self.gt_mask[None])
        self.init_iou = self.iou
        self.annotation_cost = 0.0
        self.curr_cost = 0.0
        self.annotation_actions = []
        self.done = False
        self._update_state()
        return self.state

    def _update_state(self):
        mask224 = masks_to_224_3ch(self.sam_mask[None].astype(np.float32),
                                   device=self.device)   # [1, 224, 224, 3]
        self.state = [self.img_embedding[None], mask224]
        if self.use_cost:
            self.state.append(torch.tensor([[self.annotation_cost]],
                                           device=self.device))

    # ------------------------------------------------------------------
    def _click(self):
        if self.sam_logits is None:
            self.prompt_clicks, self.prompt_labels = \
                self.click_robot.middle_click(self.gt_mask)
        else:
            clicks, labels = self.click_robot.interact(self.sam_mask,
                                                       self.gt_mask)
            self.prompt_clicks = np.concatenate(
                [self.prompt_clicks, clicks], 0)
            self.prompt_labels = np.concatenate(
                [self.prompt_labels, labels], 0)

        # SAM's multimask decode and the best mask against the gt (on the
        # device when the controller has the fused select)
        mask, iou, logits = self.annotator._predict_best(
            self.gt_mask, click_coords=self.prompt_clicks,
            click_labels=self.prompt_labels, mask_input=self.sam_logits)
        self.sam_mask = np.asarray(mask).squeeze().astype(bool)
        self.sam_logits = logits
        self.iou = iou

    def _reward(self, prev_iou, action):
        if self.done:
            if "click" in self.annotation_actions:
                self.annotation_cost += ANNOTATION_COSTS["click_overhead"]
            if self.annotation_cost == 0:
                # 'stop' as the first action: zero cost, zero gain.  The
                # reference divides by zero here (annotation_env.py:193) —
                # unreachable with its 2-action space; defined as 0 reward.
                return 0.0
            return (self.iou - self.init_iou) / self.annotation_cost
        return (self.iou - prev_iou) / self.curr_cost

    def step(self, action_idx: int):
        action = self.avail_actions[action_idx]
        assert not self.done
        self.annotation_actions.append(action)
        self.curr_cost = ANNOTATION_COSTS[action]
        self.annotation_cost += self.curr_cost

        prev_iou = self.iou
        if action == "click":
            self._click()
            done = len(self.annotation_actions) == self.max_steps
        elif action == "mask":
            self.sam_mask = self.gt_mask.copy()
            self.iou = 1.0
            done = True
        else:  # stop
            done = True

        self.done = done
        reward = self._reward(prev_iou, action)
        self._update_state()
        return reward, self.state, done
