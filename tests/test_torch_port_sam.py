"""The port's SAM (``eva_vos_tpu_torch/models/sam``) against the JAX
package's, on the CPU, in fp32, at the ``tiny`` preset.

A random, non-trivial JAX parameter tree (``test_torch_port_models``:
relative-position tables, tokens and norms included) crosses over through
``sam_state_dict_from_flax``, which the JAX ``convert_sam`` must take back
to the same tree leaf for leaf.  Then, on numpy inputs from a seed:

* the image embedding within 1e-4, the low-res logits within 1e-3 and the
  IoU predictions within 1e-4 (of the largest magnitude, at least 1), and
  the full-resolution masks equal on at least 99.9% of pixels;
* the port's versions of ``tests/test_sam.py``'s contract classes
  (padding invariance, the predictor contract, the fused select, the
  annotator's fused episode and the device warm start against the host
  loop), where fused and host paths must agree exactly;
* the JAX ``predict_select`` / ``warmstart_select`` and the port's pick the
  same index and the same clicks.
"""

from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.models.sam import SamPredictor as JxPredictor
from eva_vos_tpu.models.sam.build import PRESETS as JX_PRESETS
from eva_vos_tpu.models.sam.build import Sam as JxSam
from eva_vos_tpu.utils import weight_convert as jwc
from eva_vos_tpu_torch.annotator import annotator as annot_mod
from eva_vos_tpu_torch.models.sam import (SAMController, Sam, SamPredictor,
                                          build_sam)
from eva_vos_tpu_torch.models.sam.build import PRESETS
from eva_vos_tpu_torch.models.sam.image_encoder import (get_rel_pos,
                                                        window_partition,
                                                        window_unpartition)
from eva_vos_tpu_torch.models.sam.predictor import (MAX_SELECT_PIXELS,
                                                    _better,
                                                    get_preprocess_shape)
from eva_vos_tpu_torch.models.sam.prompt_encoder import PAD_LABEL
from eva_vos_tpu_torch.ops.metrics import compute_iou
from eva_vos_tpu_torch.utils import sam_state_dict_from_flax
from test_torch_port_decision import (_assert_round_trip, _numpy_sd,
                                      one_thread)  # noqa: F401
from test_torch_port_models import _init

CFG = PRESETS["tiny"]
HW = (61, 96)
MASK_AGREE = 0.999


def _scaled_close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def sams():
    """(JAX Sam, its variables, the port's Sam with the same weights)."""
    jx = JxSam(config=JX_PRESETS["tiny"])
    lr = CFG.low_res
    variables = _init(jx, np.random.default_rng(21),
                      jnp.zeros((1, CFG.img_size, CFG.img_size, 3)),
                      jnp.zeros((4, 2)), jnp.full((4,), -2, jnp.int32),
                      jnp.zeros((lr, lr)), False)
    ours = Sam(CFG)
    ours.load_state_dict(sam_state_dict_from_flax(variables), strict=True)
    return jx, variables, ours.eval()


@pytest.fixture(scope="module")
def predictors(sams):
    jx, variables, ours = sams
    return (JxPredictor(jx, variables, max_points=16),
            SamPredictor(ours, max_points=16))


def _image(seed, hw=HW):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (*hw, 3)) * 255).astype(np.uint8)


def _target():
    t = np.zeros(HW, bool)
    t[18:42, 25:65] = True
    t[30:50, 10:30] = True   # two lobes: the robot's components matter
    return t


def test_state_dict_round_trip(sams):
    _, variables, _ = sams
    sd = _numpy_sd(sam_state_dict_from_flax(variables))
    back = jwc.convert_sam(sd, depth=CFG.encoder_depth)
    _assert_round_trip(back, variables)
    assert jwc.infer_sam_dims(sd) == {"depth": 2, "decoder_depth": 2,
                                      "num_mask_tokens": 4}


def test_build_sam_is_seeded():
    a, b = build_sam("tiny", seed=3, device="cpu"), build_sam("tiny", seed=3,
                                                             device="cpu")
    c = build_sam("tiny", seed=4, device="cpu")
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not all(torch.equal(va, vc) for va, vc in
                   zip(a.state_dict().values(), c.state_dict().values()))


def test_windows_and_rel_pos(rng):
    x = torch.from_numpy(rng.standard_normal((1, 7, 10, 3)).astype(np.float32))
    wins, padded = window_partition(x, 4)
    assert padded == (8, 12) and wins.shape == (6, 4, 4, 3)
    assert torch.equal(window_unpartition(wins, 4, padded, (7, 10)), x)
    from eva_vos_tpu.models.sam.image_encoder import get_rel_pos as jx_rel_pos
    for length in (7, 13, 5):   # the module's own, a longer and a shorter table
        rp = rng.standard_normal((length, 4)).astype(np.float32)
        _scaled_close(get_rel_pos(4, 4, torch.from_numpy(rp)),
                      jx_rel_pos(4, 4, jnp.asarray(rp)), 1e-5)


def test_image_embedding_matches_jax(sams, rng):
    jx, variables, ours = sams
    x = rng.standard_normal((1, CFG.img_size, CFG.img_size, 3)).astype(
        np.float32)
    want = jx.apply(variables, jnp.asarray(x), method="encode_image")
    got = ours.encode_image(torch.from_numpy(x))
    assert got.shape == (1, CFG.grid, CFG.grid, CFG.prompt_embed_dim)
    _scaled_close(got, want, 1e-4)


PROMPTS = {
    "point": dict(point_coords=np.array([[45.0, 30.0]]),
                  point_labels=np.array([1])),
    "points": dict(point_coords=np.array([[45.0, 30.0], [10.0, 10.0]]),
                   point_labels=np.array([1, 0])),
    "box": dict(box=np.array([18.0, 8.0, 72.0, 37.0])),
    "box_point": dict(point_coords=np.array([[40.0, 20.0]]),
                      point_labels=np.array([1]),
                      box=np.array([18.0, 8.0, 72.0, 37.0])),
}


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
@pytest.mark.parametrize("with_mask", [False, True])
def test_predict_matches_jax(predictors, prompt, with_mask):
    jp, pp = predictors
    img = _image(1)
    jp.set_image(img)
    pp.set_image(img)
    _scaled_close(pp.features, jp.features, 1e-4)
    kw = dict(PROMPTS[prompt])
    if with_mask:
        _, _, low = jp.predict(**kw)
        kw["mask_input"] = low[:1]
    jm, ji, jl = jp.predict(**kw)
    pm, pi, pl = pp.predict(**kw)
    assert pm.shape == jm.shape == (3, *HW) and pm.dtype == bool
    _scaled_close(pl, jl, 1e-3)
    _scaled_close(pi, ji, 1e-4)
    assert np.mean(pm == jm) >= MASK_AGREE


# ---------------------------------------------------------------------------
# the contract of tests/test_sam.py, on the port
# ---------------------------------------------------------------------------

def test_extra_pad_slots_do_not_change_output(sams):
    _, _, ours = sams
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (CFG.grid, CFG.grid, CFG.prompt_embed_dim)).astype(np.float32))

    def run(n_slots):
        coords = torch.zeros((n_slots, 2))
        labels = torch.full((n_slots,), PAD_LABEL)
        coords[0] = torch.tensor([40.0, 60.0])
        labels[0], labels[1] = 1, -1
        return ours.decode(emb, coords, labels,
                           torch.zeros((CFG.low_res, CFG.low_res)), False)

    (m8, i8), (m16, i16) = run(8), run(16)
    torch.testing.assert_close(m8, m16, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(i8, i16, rtol=2e-5, atol=2e-5)


class TestPredictorContract:
    def test_multimask_is_decoder_outputs_1_to_3(self, predictors):
        _, pp = predictors
        pp.set_image(_image(2, (64, 64)))
        coords, labels = pp._build_prompts(np.array([[30.0, 20.0]]),
                                           np.array([1]), None)
        raw_masks, raw_iou = pp._decode(coords, labels, None)
        _, i3, l3 = pp.predict(point_coords=np.array([[30, 20]]),
                               point_labels=np.array([1]))
        np.testing.assert_array_equal(l3, raw_masks[1:].numpy())
        np.testing.assert_array_equal(i3, raw_iou[1:].numpy())
        m1, _, l1 = pp.predict(point_coords=np.array([[30, 20]]),
                               point_labels=np.array([1]),
                               multimask_output=False)
        assert m1.shape == (1, 64, 64)
        np.testing.assert_array_equal(l1, raw_masks[:1].numpy())

    def test_no_mask_flag_ignores_mask_content(self, predictors, rng):
        _, pp = predictors
        pp.set_image(_image(3, (64, 64)))
        coords, labels = pp._build_prompts(np.array([[30.0, 20.0]]),
                                           np.array([1]), None)
        lr = CFG.low_res
        garbage = torch.from_numpy(rng.standard_normal((lr, lr)).astype(
            np.float32))
        c, l = torch.from_numpy(coords), torch.from_numpy(labels)
        a = pp.sam.decode(pp.features, c, l, garbage, False)
        b = pp.sam.decode(pp.features, c, l, torch.zeros((lr, lr)), False)
        assert torch.equal(a[0], b[0])
        d = pp.sam.decode(pp.features, c, l, garbage, True)
        assert not torch.allclose(a[0], d[0], atol=1e-4)

    def test_logit_round_trip_and_threshold(self, predictors):
        _, pp = predictors
        pp.set_image(_image(4, (72, 96)))
        kw = dict(point_coords=np.array([[48, 36]]),
                  point_labels=np.array([1]))
        masks, _, logits = pp.predict(**kw)
        assert logits.shape == (3, CFG.low_res, CFG.low_res)
        up = pp.postprocess_masks(torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(masks, up > 0.0)
        m_a, _, _ = pp.predict(**kw, mask_input=logits[:1])
        m_b, _, _ = pp.predict(**kw, mask_input=logits[0])
        m_c, _, _ = pp.predict(**kw, mask_input=torch.from_numpy(logits[0]))
        np.testing.assert_array_equal(m_a, m_b)
        np.testing.assert_array_equal(m_a, m_c)

    def test_preprocess_shape_and_embedding_layout(self, predictors):
        for (h, w, long), want in [((480, 854, 1024), (576, 1024)),
                                   ((854, 480, 1024), (1024, 576)),
                                   ((720, 1280, 1024), (576, 1024)),
                                   ((3, 5, 1024), (614, 1024))]:
            assert get_preprocess_shape(h, w, long) == want
        _, pp = predictors
        pp.set_image(_image(5, (96, 120)))
        assert pp.input_size == (102, 128)
        emb = pp.get_image_embedding()
        assert emb.shape == (CFG.prompt_embed_dim, CFG.grid, CFG.grid)

    def test_controller_api(self, sams):
        ctrl = SAMController(SamPredictor(sams[2], max_points=16))
        ctrl.set_image(_image(6, (80, 100)))
        masks, scores, logits = ctrl.predict(
            click_coords=np.array([[50, 40]]), click_labels=np.array([1]))
        assert masks.shape == (3, 1, 80, 100) and scores.shape == (3,)
        state = ctrl.export_embedding_state()
        ctrl.reset_image()
        assert not ctrl.embedded
        ctrl.restore_embedding_state(state)
        assert ctrl.embedded and ctrl.predictor.original_size == (80, 100)

    def test_batched_paths(self, predictors):
        _, pp = predictors
        images = [_image(7), _image(8)]
        feats = pp.encode_images(images)
        pp.set_image(images[1])
        _scaled_close(feats[1], pp.features, 1e-5)
        out = pp.predict_batch(feats, HW, [PROMPTS["point"], PROMPTS["box"]])
        want = pp.predict(**PROMPTS["box"])
        np.testing.assert_array_equal(out[1][0], want[0])
        _scaled_close(out[1][2], want[2], 1e-5)


def _reference_select(pp, target, **kw):
    """``predict`` + the reference ``best_sam_mask`` scan."""
    masks, _, logits = pp.predict(**kw)
    tgt = np.asarray(target)[None].astype(bool)
    idx, best = -1, 0.0
    for ii, gen in enumerate(masks):
        iou = compute_iou(gen[None], tgt)
        if iou > best:
            idx, best = ii, iou
    return masks[idx], best, idx, logits[idx]


class TestFusedSelect:
    @pytest.mark.parametrize("multi", [True, False])
    @pytest.mark.parametrize("prompt", ["points", "box"])
    def test_matches_generic_path_and_jax(self, predictors, multi, prompt):
        jp, pp = predictors
        img = _image(9)
        jp.set_image(img)
        pp.set_image(img)
        target = _target()
        kw = dict(PROMPTS[prompt], multimask_output=multi)
        ref_mask, ref_iou, ref_idx, ref_low = _reference_select(
            pp, target, **kw)
        mask, iou, idx, low = pp.predict_select(target, **kw)
        assert idx == ref_idx and iou == ref_iou
        np.testing.assert_array_equal(mask, ref_mask)
        np.testing.assert_array_equal(low.numpy(), ref_low)
        assert jp.predict_select(target, **kw)[2] == idx

    def test_mask_input_round_trip(self, predictors):
        jp, pp = predictors
        img = _image(10)
        pp.set_image(img)
        jp.set_image(img)
        target = _target()
        kw = PROMPTS["box_point"]
        _, _, _, low = pp.predict_select(target, **kw)
        mask2, iou2, idx2, _ = pp.predict_select(target, **kw,
                                                 mask_input=low[None])
        _, _, _, ref_low = _reference_select(pp, target, **kw)
        ref_mask2, ref_iou2, ref_idx2, _ = _reference_select(
            pp, target, **kw, mask_input=ref_low[None])
        assert idx2 == ref_idx2 and iou2 == ref_iou2
        np.testing.assert_array_equal(mask2, ref_mask2)
        _, _, _, jlow = jp.predict_select(target, **kw)
        assert jp.predict_select(target, **kw, mask_input=jlow[None])[2] == idx2


def _near_ties(seed, n=2000):
    """(inter, union) pairs of two candidates with nearly equal IoU on
    frames of up to MAX_SELECT_PIXELS pixels."""
    r = np.random.default_rng(seed)
    ua = r.integers(1, MAX_SELECT_PIXELS + 1, n)
    ub = r.integers(1, MAX_SELECT_PIXELS + 1, n)
    ia = (r.random(n) * (ua + 1)).astype(np.int64)
    ib = np.clip(ia * ub // ua + r.integers(-2, 3, n), 0, ub)
    return [(int(a), int(b), int(c), int(d))
            for a, b, c, d in zip(ia, ua, ib, ub)]


@pytest.mark.parametrize("cases", [
    # a cross product of -1 that the smoothing term overturns (and one it
    # does not), at and beyond the reach of |s * d2| < 1
    [(0, 1, 1, MAX_SELECT_PIXELS), (0, 1, 1, 900_000),
     (0, 1, 1, 1_000_002), (0, 1, 1, 1_000_001), (5, 5, 7, 7)],
    _near_ties(0),
    _near_ties(1),
])
def test_iou_order_is_exact(cases):
    """``_better`` is the exact smoothed-IoU order for any frame the
    selection takes."""
    s = Fraction(1, 10 ** 6)
    t = torch.tensor(cases, dtype=torch.int64).T
    got = _better(t[0], t[1], t[2], t[3]).tolist()
    want = [(ia + s) / (ua + s) > (ib + s) / (ub + s)
            for ia, ua, ib, ub in cases]
    assert got == want


class _GenericOnly:
    """A controller without the fused methods."""

    def __init__(self, ctrl):
        self._c = ctrl

    def __getattr__(self, name):
        if name in ("predict_select", "warmstart_select"):
            raise AttributeError(name)
        return getattr(self._c, name)


def test_annotator_fused_episode_equals_generic(sams, monkeypatch):
    """Click rounds (warm start, then 2 clicks) and a box round through the
    fused controller and through the generic ``predict`` path."""
    rng = np.random.default_rng(3)
    im = rng.uniform(-1, 1, (*HW, 3)).astype(np.float32)
    gt = np.zeros(HW, np.float32)
    gt[18:42, 25:65] = 1.0
    pred = np.roll(gt, (4, 7), axis=(0, 1)).astype(bool)
    monkeypatch.setattr(annot_mod, "SIMILAR_IOU_THRESHOLD", 0.3)
    for kind in ("click", "bbox"):
        episodes = []
        for ctrl, fused in (
                (SAMController(SamPredictor(sams[2], max_points=64)), True),
                (_GenericOnly(SAMController(SamPredictor(
                    sams[2], max_points=64))), False)):
            episodes.append(annot_mod.Annotator(
                ctrl, device_warmstart=fused).get_mask(
                annotation_type=kind, num_prompts=2, gt_mask=gt, im=im,
                mivos_mask=pred, cache_key=0))
        (m1, c1, q1, l1, cl1, lb1, bb1), (m2, c2, q2, l2, cl2, lb2, bb2) = \
            episodes
        assert c1 == c2 and q1 == q2
        np.testing.assert_array_equal(np.asarray(m1, bool),
                                      np.asarray(m2, bool))
        assert (cl1 is None) == (cl2 is None)
        if cl1 is not None:
            np.testing.assert_array_equal(cl1, cl2)
            np.testing.assert_array_equal(lb1, lb2)
        np.testing.assert_array_equal(np.asarray(bb1), np.asarray(bb2))
        np.testing.assert_array_equal(torch.as_tensor(l1).numpy(),
                                      torch.as_tensor(l2).numpy())


def _ring_target():
    """A frame-wide ring: the random tiny SAM's near-full masks start at
    IoU 0.3-0.4 against it and refinement clicks move them (on image 11:
    0.335, 0.551, 0.570, 0.572; on image 14: 0.324, 0.516)."""
    t = np.zeros(HW, bool)
    t[6:56, 8:88] = True
    t[20:40, 40:60] = False
    return t


@pytest.mark.parametrize("threshold,max_tries,seed", [
    (0.3, 6, 11),    # a stop at the middle click's decode
    (0.5, 6, 14),    # a stop after one refinement
    (0.56, 6, 11),   # a stop after two refinements (a negative click)
    (0.95, 4, 13),   # giving up
])
def test_warmstart_chain_equals_host_loop_and_jax(predictors, monkeypatch,
                                                  threshold, max_tries, seed):
    jp, pp = predictors
    ctrl = SAMController(pp)
    img = _image(seed)
    ctrl.set_image(img)
    pred = _ring_target()
    monkeypatch.setattr(annot_mod, "SIMILAR_IOU_THRESHOLD", threshold)
    monkeypatch.setattr(annot_mod, "MAX_WARMSTART_TRIES", max_tries)
    f_log, f_mask, f_clicks, f_labels = annot_mod.Annotator(
        ctrl, device_warmstart=True).create_similar_samlogits(pred)

    def not_called(*args, **kwargs):
        raise AssertionError("the default warm start is the host loop")

    monkeypatch.setattr(ctrl, "warmstart_select", not_called)
    h_log, h_mask, h_clicks, h_labels = annot_mod.Annotator(
        ctrl).create_similar_samlogits(pred)
    jp.set_image(img)
    j_ok, _, _, j_clicks, j_labels = jp.warmstart_select(
        pred, threshold=threshold, max_tries=max_tries)
    assert (h_log is None) == (f_log is None) == (not j_ok)
    if h_log is None:
        assert f_mask is None and f_clicks is None
        return
    np.testing.assert_array_equal(f_clicks, np.asarray(h_clicks, np.float64))
    np.testing.assert_array_equal(f_labels, np.asarray(h_labels, np.int64))
    np.testing.assert_array_equal(np.asarray(f_mask, bool).squeeze(),
                                  np.asarray(h_mask, bool).squeeze())
    np.testing.assert_array_equal(torch.as_tensor(f_log).numpy().squeeze(),
                                  torch.as_tensor(h_log).numpy().squeeze())
    np.testing.assert_array_equal(f_clicks, j_clicks)
    np.testing.assert_array_equal(f_labels, j_labels)
