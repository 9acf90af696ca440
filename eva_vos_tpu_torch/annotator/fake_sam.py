"""A deterministic prompt-driven segmenter standing in for SAM in tests (a
copy of ``eva_vos_tpu/annotator/fake_sam.py``; numpy, on the host).

The reference has no test harness; SURVEY.md §4 calls for a "fake SAM" so
the interaction loops can run without the ViT-H checkpoint.  This simulator
honors the real predictor contract (``set_image`` / ``reset_image`` /
``predict`` with points, box, and 256x256 mask-logit warm starts) and has
the property the loops rely on: more (correct) clicks -> masks closer to
the clicked region; negative clicks carve regions out.
"""

from __future__ import annotations

import numpy as np

LOGIT_HIGH = 8.0
LOGIT_LOW = -8.0


class FakeSAMController:
    """Drop-in for ``SAMController`` (see ``annotator.sam_controller``)."""

    def __init__(self, radii=(6, 10, 16)):
        self.radii = radii
        self.embedded = False
        self._hw = None

    # -- predictor lifecycle -------------------------------------------------
    def set_image(self, image: np.ndarray):
        assert image.ndim == 3 and image.shape[-1] == 3
        self._hw = image.shape[:2]
        self.embedded = True

    def reset_image(self):
        self.embedded = False
        self._hw = None

    def get_image_embedding(self) -> np.ndarray:
        """[256, 64, 64] fake embedding (deterministic, image-size seeded)."""
        assert self.embedded
        rng = np.random.default_rng(self._hw[0] * 10007 + self._hw[1])
        return rng.standard_normal((256, 64, 64)).astype(np.float32)

    def export_embedding_state(self):
        """Same caching contract as ``SAMController``."""
        assert self.embedded
        return self._hw

    def restore_embedding_state(self, state):
        self._hw = state
        self.embedded = True

    # -- prediction ----------------------------------------------------------
    def _disk(self, cx, cy, r):
        h, w = self._hw
        y, x = np.ogrid[:h, :w]
        return (x - cx) ** 2 + (y - cy) ** 2 <= r ** 2

    def _mask_from_prompts(self, click_coords, click_labels, bbox, mask_input, r):
        h, w = self._hw
        m = np.zeros((h, w), dtype=bool)
        if mask_input is not None:
            low = np.asarray(mask_input)[0] > 0
            # upsample 256x256 logits to image size (nearest)
            yi = (np.arange(h) * low.shape[0] // h).clip(0, low.shape[0] - 1)
            xi = (np.arange(w) * low.shape[1] // w).clip(0, low.shape[1] - 1)
            m |= low[np.ix_(yi, xi)]
        if bbox is not None:
            b = np.asarray(bbox).reshape(-1)[:4].astype(int)
            m[b[1]:b[3] + 1, b[0]:b[2] + 1] = True
        if click_coords is not None:
            for (cx, cy), lab in zip(np.asarray(click_coords, int),
                                     np.asarray(click_labels, int)):
                if lab == 1:
                    m |= self._disk(cx, cy, r)
                else:
                    m &= ~self._disk(cx, cy, r)
        return m

    def _to_logits(self, mask):
        h, w = mask.shape
        yi = (np.arange(256) * h // 256).clip(0, h - 1)
        xi = (np.arange(256) * w // 256).clip(0, w - 1)
        low = mask[np.ix_(yi, xi)]
        return np.where(low, LOGIT_HIGH, LOGIT_LOW).astype(np.float32)

    def predict(self, click_coords=None, click_labels=None, bbox=None,
                mask_input=None, multimask_output=True):
        """Returns (masks [n, 1, H, W] bool, scores [n], logits [n, 256, 256])."""
        assert self.embedded, "predict called before set_image"
        radii = self.radii if multimask_output else self.radii[:1]
        masks, logits = [], []
        for r in radii:
            m = self._mask_from_prompts(click_coords, click_labels, bbox,
                                        mask_input, r)
            masks.append(m)
            logits.append(self._to_logits(m))
        masks = np.stack(masks)[:, None]  # [n, 1, H, W]
        scores = np.linspace(0.9, 0.7, len(radii)).astype(np.float32)
        return masks, scores, np.stack(logits)
