"""Frame-selection policies (counterpart of
``eva_vos_tpu/interactions/policies.py``).

Behavior parity targets: ``interactions/policies.py`` in the reference —
QNet farthest-point selection in quality-feature space, random selection,
pretrained-encoder farthest-point, and the oracle one-step lookahead.

Feature extraction over all T frames is one batched call on the engine's
device; the farthest-point search runs where the features are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.normalize import im_normalize
from ..ops.resize import resize_bicubic, resize_nearest
from .eval import Session, eval_session_metric


def farthest_point_selection(features, interacted_frames) -> int:
    """Pick the frame whose feature is farthest (min-L2) from every
    interacted frame's feature; first max wins on ties, like the
    reference's strict-> scan.  ``features`` [T, D] is a tensor (searched on
    its device) or an array."""
    f = torch.as_tensor(features).float()
    # at most T of them, as the JAX package's fixed-length set keeps
    idx = torch.as_tensor(list(interacted_frames)[:f.shape[0]],
                          dtype=torch.long, device=f.device)
    d2 = ((f[:, None, :] - f[idx][None]) ** 2).sum(dim=-1)
    min_d = torch.sqrt(d2.min(dim=1).values)
    return int(torch.argmax(min_d))


def frames_to_224(images01, device="cuda") -> torch.Tensor:
    """[T, H, W, 3] in [0,1] (float) or [0,255] (uint8) -> normalized
    bicubic 224x224 (QNet input) on ``device``.  uint8 is moved at 1 byte a
    pixel and scaled on the device."""
    x = torch.as_tensor(np.asarray(images01), device=device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    x = im_normalize(x.float())
    return resize_bicubic(x, (224, 224), h_axis=1, w_axis=2)


def masks_to_224_3ch(masks, device="cuda") -> torch.Tensor:
    """[T, H, W] 0/1 -> [T, 224, 224, 3] nearest-resized; a tensor stays on
    its device, anything else goes to ``device``."""
    m = (masks.float() if isinstance(masks, torch.Tensor)
         else torch.as_tensor(np.asarray(masks, np.float32), device=device))
    m = resize_nearest(m, (224, 224), h_axis=1, w_axis=2)
    return m[..., None].repeat(1, 1, 1, 3)


def qnet_frame_selection(qnet_extract, frames224, gen_masks, interacted_frames):
    """QNet feature farthest-point selection (``policies.py:40-60``).

    qnet_extract: fn (imgs [T,224,224,3], masks [T,224,224,3]) -> [T, D],
        called with tensors on the device of ``frames224``
    frames224: precomputed normalized 224 frames for the video
    gen_masks: [T, H, W] current generated masks (0/1 float)
    """
    masks224 = masks_to_224_3ch(gen_masks, device=frames224.device)
    features = qnet_extract(frames224, masks224)
    return farthest_point_selection(features, interacted_frames)


def rand_frame_selection(num_frames: int, interacted_frames, rng) -> int:
    """Uniform choice among frames not yet interacted."""
    avail = sorted(set(range(num_frames)) - set(int(i) for i in interacted_frames))
    return int(rng.choice(avail))


def l2_frame_selection(encoder_features, interacted_frames) -> int:
    """Farthest-point on pretrained-encoder features (``get_frame_l2``)."""
    return farthest_point_selection(encoder_features, interacted_frames)


def upper_bound_frame_selection(session: Session, metric: str = "j") -> int:
    """Oracle one-step lookahead: try annotating every candidate frame and
    keep the one with the best resulting mean quality (``policies.py:91-118``).

    The reference deep-copies the whole stateful processor per candidate;
    here a clone interacts from the session's state without donating it, so
    the engine works on a copy and the session's state stays as it was.
    Ties keep the *last* best frame, matching the reference's ``>=``.
    """
    best_metric = -np.inf
    best_frame = -1
    prev = set(session.frames_list)
    for f in range(session.num_frames):
        if f in prev:
            continue
        look = session.clone()
        look.frame_interaction_type[f] = 1
        look.frames_list.append(f)
        look.interact(look.gt_mask(f), f)
        mu, *_ = eval_session_metric(look, metric)
        if mu >= best_metric:
            best_metric = mu
            best_frame = f
    return best_frame
