"""The port's simulated annotator against the JAX package's, on the CPU.

The click and box robots, the fake SAM and the ``Annotator`` run on the
host on numpy in both packages, so every output must be identical: masks,
costs, IoUs, clicks, labels, boxes and logits.  The cases are those of
``tests/test_robots.py`` and ``tests/test_annotator.py``.
"""

import numpy as np
import pytest

from eva_vos_tpu.annotator import Annotator as JxAnnotator
from eva_vos_tpu.annotator import BboxRobot as JxBbox
from eva_vos_tpu.annotator import ClickRobot as JxClick
from eva_vos_tpu.annotator import FakeSAMController as JxFakeSAM
from eva_vos_tpu.annotator.annotator import \
    denormalize_to_uint8 as jx_denormalize
from eva_vos_tpu_torch.annotator import (Annotator, BboxRobot, ClickRobot,
                                         FakeSAMController)
from eva_vos_tpu_torch.annotator.annotator import denormalize_to_uint8
from eva_vos_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD

H, W = 96, 128


def sq(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), dtype=bool)
    m[y0:y1, x0:x1] = True
    return m


def blob(y0, y1, x0, x1):
    return sq(H, W, y0, y1, x0, x1).astype(np.float32)


def normed_image():
    img01 = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return (img01 - IMAGENET_MEAN) / IMAGENET_STD


def assert_same(got, want):
    """Equal nested outputs: arrays equal in value, shape and dtype."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# (pred, gt, iou) of tests/test_robots.py; pred None: middle click
ROBOT_CASES = {
    "middle_center": (None, sq(32, 32, 10, 20, 10, 20), None),
    "middle_concave": (None, sq(40, 40, 10, 30, 10, 30)
                       & ~sq(40, 40, 14, 26, 14, 26), None),
    "false_negative": (np.zeros((32, 32), bool), sq(32, 32, 5, 25, 5, 25),
                       None),
    "false_positive": (sq(32, 32, 10, 26, 10, 26),
                       np.pad(np.ones((1, 1), bool), ((0, 31), (0, 31))),
                       None),
    "largest_region": (sq(64, 64, 0, 30, 0, 30) | sq(64, 64, 40, 64, 40, 64),
                       sq(64, 64, 0, 30, 0, 30), None),
    "perfect": (sq(32, 32, 8, 24, 8, 24), sq(32, 32, 8, 24, 8, 24), None),
    "low_iou": (sq(64, 64, 40, 64, 40, 64), sq(64, 64, 0, 20, 0, 20), 0.01),
    "refinement": (sq(64, 64, 30, 64, 30, 64), sq(64, 64, 0, 10, 0, 10),
                   None),
}


@pytest.mark.parametrize("case", sorted(ROBOT_CASES))
def test_click_robot_matches_jax(case):
    pred, gt, iou = ROBOT_CASES[case]
    ours, theirs = ClickRobot(), JxClick()
    if pred is None:
        assert_same(ours.middle_click(gt), theirs.middle_click(gt))
        assert_same(ours.three_pos_clicks(gt), theirs.three_pos_clicks(gt))
        return
    assert_same(ours.interact(pred, gt, iou=iou),
                theirs.interact(pred, gt, iou=iou))
    assert_same(ours.three_refinement_clicks(pred, gt),
                theirs.three_refinement_clicks(pred, gt))


def test_bbox_robot_matches_jax():
    for gt in (sq(32, 48, 4, 10, 6, 20), sq(32, 48, 0, 32, 0, 48)[None],
               blob(16, 64, 40, 100)):
        assert_same(BboxRobot().interact(gt), JxBbox().interact(gt))


def test_fake_sam_matches_jax():
    ours, theirs = FakeSAMController(), JxFakeSAM()
    img = denormalize_to_uint8(normed_image())
    for sam in (ours, theirs):
        sam.set_image(img)
    assert_same(ours.get_image_embedding(), theirs.get_image_embedding())
    assert ours.export_embedding_state() == theirs.export_embedding_state()
    clicks = np.array([[40, 30], [60, 50], [100, 20]])
    labels = np.array([1, 1, 0])
    _, _, logits = theirs.predict(clicks[:1], labels[:1])
    prompts = [dict(click_coords=clicks, click_labels=labels),
               dict(bbox=np.array([[10, 8, 70, 60]], np.float32)),
               dict(mask_input=logits[:1], click_coords=clicks[2:],
                    click_labels=labels[2:]),
               dict(click_coords=clicks[:2], click_labels=labels[:2],
                    multimask_output=False)]
    for kw in prompts:
        assert_same(ours.predict(**kw), theirs.predict(**kw))
    ours.reset_image()
    ours.restore_embedding_state(theirs.export_embedding_state())
    assert_same(ours.predict(**prompts[0]), theirs.predict(**prompts[0]))


def test_denormalize_matches_jax():
    im = normed_image()
    assert_same(denormalize_to_uint8(im), jx_denormalize(im))


# get_mask calls: (annotation_type, gt, num_prompts, mivos, prev) where prev
# names a call whose prompts the call resumes from
GET_MASK_CASES = {
    "empty_gt": ("mask", np.zeros((H, W), np.float32), 1, None, None),
    "mask": ("mask", blob(10, 40, 10, 50), 1, None, None),
    "click": ("click", blob(20, 70, 30, 90), 1, None, None),
    "3clicks": ("click", blob(20, 70, 30, 90), 3, None, None),
    "3clicks_warm": ("click", blob(20, 70, 30, 90), 3, blob(24, 74, 34, 94),
                     None),
    "click_empty_mivos": ("click", blob(20, 70, 30, 90), 1,
                          np.zeros((H, W), np.float32), None),
    "click_far_mivos": ("click", blob(20, 70, 30, 90), 1,
                        blob(0, 12, 100, 128), None),
    "bbox": ("bbox", blob(16, 64, 40, 100), 1, None, None),
    "bbox_refined": ("bbox", blob(16, 64, 40, 100), 2, blob(10, 60, 30, 80),
                     None),
    "click_resumed": ("click", blob(20, 70, 30, 90), 1, "mask", "click"),
}


@pytest.mark.parametrize("prompt_type", ["a", "b", "c"])
@pytest.mark.parametrize("case", list(GET_MASK_CASES))
def test_get_mask_matches_jax(case, prompt_type):
    kind, gt, n, mivos, prev = GET_MASK_CASES[case]
    im = normed_image()
    ours = Annotator(FakeSAMController(), prompt_type=prompt_type)
    theirs = JxAnnotator(JxFakeSAM(), prompt_type=prompt_type)
    prev_data = None
    if prev is not None:
        pkind, pgt, pn, _, _ = GET_MASK_CASES[prev]
        first = ours.get_mask(pkind, pgt, im=im, num_prompts=pn)
        assert_same(first, theirs.get_mask(pkind, pgt, im=im, num_prompts=pn))
        mivos = np.asarray(first[0]).squeeze()
        prev_data = {"sam_logits": first[3], "click_coords": first[4],
                     "click_labels": first[5], "bbox": first[6]}
    got = ours.get_mask(kind, gt, im=im, num_prompts=n, mivos_mask=mivos,
                        prev_iter_data=prev_data, cache_key=0)
    want = theirs.get_mask(kind, gt, im=im, num_prompts=n, mivos_mask=mivos,
                           prev_iter_data=prev_data, cache_key=0)
    assert_same(got, want)


def test_best_sam_mask_matches_jax():
    gt = blob(0, 10, 0, 10)
    cands = [np.zeros((3, 1, H, W), bool),
             np.stack([gt.astype(bool)[None]] * 2 + [np.zeros((1, H, W), bool)]),
             np.stack([blob(0, 5, 0, 5)[None], blob(0, 10, 0, 8)[None],
                       blob(0, 10, 0, 10)[None]]).astype(bool)]
    ours = Annotator(FakeSAMController())
    theirs = JxAnnotator(JxFakeSAM())
    for c in cands:
        assert ours.best_sam_mask(c, gt) == theirs.best_sam_mask(c, gt)


class _Counting:
    """A fake SAM that counts its image encodings."""

    def __init__(self):
        super().__init__()
        self.encode_calls = 0

    def set_image(self, image):
        self.encode_calls += 1
        super().set_image(image)


class CountingFakeSAM(_Counting, FakeSAMController):
    pass


class JxCountingFakeSAM(_Counting, JxFakeSAM):
    pass


def test_embedding_cache_hits_match_jax():
    """The same calls with cache keys embed each key once, in both
    packages, and give what the uncached annotator gives."""
    im = normed_image()
    keys = [0, 1, 0, 2, 1, 0]
    runs = {}
    for name, sam_cls, ann_cls in (("ours", CountingFakeSAM, Annotator),
                                   ("jax", JxCountingFakeSAM, JxAnnotator)):
        for cached in (True, False):
            sam = sam_cls()
            ann = ann_cls(sam, cache_embeddings=cached)
            outs = [ann.get_mask("click", blob(20, 70, 30, 90), im=im,
                                 num_prompts=2, cache_key=k) for k in keys]
            runs[name, cached] = (outs, sam.encode_calls,
                                  len(ann._embed_cache))
    assert runs["ours", True][1:] == runs["jax", True][1:] == (3, 3)
    assert runs["ours", False][1:] == runs["jax", False][1:] == (6, 0)
    for run in (runs["jax", True], runs["ours", False], runs["jax", False]):
        assert_same(runs["ours", True][0], run[0])
    ann = Annotator(CountingFakeSAM())
    ann.get_mask("click", blob(20, 70, 30, 90), im=im, cache_key=0)
    ann.clear_sam_cache()
    assert ann._embed_cache == {}
