"""The port's policy loops against the JAX package's, on the CPU, in fp32.

Setup of ``tests/test_interactions.py``: a T=5, 48x64 synthetic video (seed
11), resnet18/resnet18 STCN with top_k 8 and mem_freq 2, FusionNet, 3
rounds.  Both engines get the same random weights, carried across with
``eva_vos_tpu_torch.utils.weight_convert``; the JAX engine reads its memory
with the plain 'gather' strategy, the port's with 'auto' (the plain read on
the CPU).  Every loop runs on both sides and is held round for round:

* exactly: the frames chosen, the annotation times, the actions, the
  interaction types and the empty-gt handling;
* to the engine test's rule: each round's generated masks agree on at
  least 99.9% of pixels (a pixel whose two top probabilities lie within
  1e-4 may flip), and each round's per-frame metrics within 1e-2 (one
  pixel at 48x64 moves J by up to ~3e-3).

The policies' models are callables here: one numpy function serves both
sides, wrapped for each side's array type.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu import interactions as jx
from eva_vos_tpu.annotator import Annotator as JxAnnotator
from eva_vos_tpu.annotator import FakeSAMController as JxFakeSAM
from eva_vos_tpu.engine.propagation import EngineConfig as JxConfig
from eva_vos_tpu.engine.propagation import InferenceEngine as JxEngine
from eva_vos_tpu.interactions import eval as jx_eval
from eva_vos_tpu.interactions import mask as jx_mask
from eva_vos_tpu.interactions import multiple as jx_multiple
from eva_vos_tpu.models import FusionNet as JxFusion
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu_torch import interactions as pt
from eva_vos_tpu_torch.annotator import Annotator, FakeSAMController
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
from eva_vos_tpu_torch.interactions import eval as pt_eval
from eva_vos_tpu_torch.interactions import mask as pt_mask
from eva_vos_tpu_torch.interactions import multiple as pt_multiple
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.utils import (ANNOTATION_COSTS,
                                     fusion_state_dict_from_flax,
                                     stcn_state_dict_from_flax)
from test_torch_port_engine import _random_variables

T, H, W = 5, 48, 64
ROUNDS = 3
MASK_AGREE, METRIC_ATOL = 0.999, 1e-2


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with the same random weights."""
    rng = np.random.default_rng(11)
    jstcn = JxSTCN(key_arch="resnet18", value_arch="resnet18", top_k=8)
    jfusion = JxFusion()
    sp = _random_variables(jax.eval_shape(lambda: jstcn.init(
        jax.random.PRNGKey(0), jnp.zeros((H, W, 3)), jnp.zeros((1, H, W)),
        method="init_all")), rng)
    fp = _random_variables(jax.eval_shape(lambda: jfusion.init(
        jax.random.PRNGKey(1), jnp.zeros((H, W, 3)), jnp.zeros((H, W)),
        jnp.zeros((H, W)), jnp.zeros((H, W, 2)), jnp.zeros((2,)))), rng)
    jcfg = JxConfig(mem_freq=2, top_k=8, max_interactions=8, feature_chunk=5,
                    readout_strategy="gather")
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    stcn.load_state_dict(stcn_state_dict_from_flax(sp, "resnet18", "resnet18"))
    fusion = FusionNet()
    fusion.load_state_dict(fusion_state_dict_from_flax(fp))
    cfg = EngineConfig(mem_freq=2, top_k=8, max_interactions=8,
                       feature_chunk=5)
    return (JxEngine(jstcn, jfusion, sp, fp, jcfg),
            InferenceEngine(stcn, fusion, cfg, device="cpu"))


def _samples(empty_frame=None):
    images, masks = synthetic_video(T, H, W, num_objects=1, seed=11)
    if empty_frame is not None:
        masks = masks.copy()
        masks[0, empty_frame] = 0
    return (jx.VideoSample(name="synth__1", images01=images, gt=masks),
            pt.VideoSample(name="synth__1", images01=images, gt=masks))


@pytest.fixture(scope="module")
def samples():
    return _samples()


@pytest.fixture(scope="module")
def samples_with_empty_frame():
    return _samples(empty_frame=2)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recorded(monkeypatch, modules, fn, *args, **kwargs):
    """Run a loop with each round's evaluation recorded: returns (result,
    [(gen_masks, frame_quality_all) per round], the loop's session)."""
    log = []
    for module in modules:
        orig = module.eval_session_metric

        def rec(session, metric="j", orig=orig):
            out = orig(session, metric)
            log.append((_host(out[1]).copy(), list(out[3])))
            return out

        monkeypatch.setattr(module, "eval_session_metric", rec)
    result = fn(*args, **kwargs)
    monkeypatch.undo()
    return result, log


def _assert_rounds(got_log, want_log):
    assert len(got_log) == len(want_log) > 0
    for r, ((gm, gq), (wm, wq)) in enumerate(zip(got_log, want_log)):
        assert gm.shape == wm.shape == (T, H, W)
        agree = np.mean(gm == wm)
        assert agree >= MASK_AGREE, f"round {r + 1}: masks agree on {agree}"
        # the empty-gt token exactly, the metrics within the tolerance
        assert [q == pt.EMPTY_GT_TOKEN for q in gq] == \
            [q == jx.EMPTY_GT_TOKEN for q in wq]
        np.testing.assert_allclose(gq, wq, rtol=0, atol=METRIC_ATOL,
                                   err_msg=f"round {r + 1}")


def _assert_sessions(got, want):
    """The loops' own sessions: frames, times, interaction types."""
    assert got.frames_list == [int(f) for f in want.frames_list]
    assert got.annotation_times == want.annotation_times
    np.testing.assert_array_equal(got.frame_interaction_type,
                                  want.frame_interaction_type)
    np.testing.assert_allclose(got.mu_metrics, want.mu_metrics, rtol=0,
                               atol=METRIC_ATOL)


def _run_both(monkeypatch, jx_modules, pt_modules, jx_call, pt_call):
    want, want_log = _recorded(monkeypatch, jx_modules, jx_call)
    want_session = jx_eval.LAST_SESSION
    got, got_log = _recorded(monkeypatch, pt_modules, pt_call)
    got_session = pt_eval.LAST_SESSION
    _assert_rounds(got_log, want_log)
    _assert_sessions(got_session, want_session)
    return got, want


def _assert_results(got, want, exact):
    """Loop results: the entries named in ``exact`` (by position) equal,
    the others (metrics) within the tolerance."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in exact:
            assert g == w, f"result {i}: {g} != {w}"
        else:
            np.testing.assert_allclose(np.asarray(g, float),
                                       np.asarray(w, float), rtol=0,
                                       atol=METRIC_ATOL)


# ---------------------------------------------------------------------------
# models as callables: one numpy function each, wrapped for each side
# ---------------------------------------------------------------------------

def _pool(x, k):
    t, h, w, c = x.shape
    return x.reshape(t, h // k, k, w // k, k, c).mean(axis=(2, 4))


def _qnet_features(frames224, masks224):
    """[T, 224, 224, 3] twice -> [T, D]: pooled masks, lightly the frames."""
    m = _pool(masks224[..., :1], 28).reshape(len(masks224), -1)
    f = _pool(frames224, 56).reshape(len(frames224), -1)
    return np.concatenate([m, 1e-3 * f], axis=1).astype(np.float32)


def _encoder_features(images01):
    return np.asarray(images01).reshape(len(images01), -1)[:, ::97]


def _jx_qnet(frames224, masks224):
    return jnp.asarray(_qnet_features(np.asarray(frames224),
                                      np.asarray(masks224)))


def _pt_qnet(frames224, masks224):
    assert isinstance(frames224, torch.Tensor)
    assert isinstance(masks224, torch.Tensor)
    return torch.as_tensor(_qnet_features(frames224.cpu().numpy(),
                                          masks224.cpu().numpy()))


def _rl_agent():
    """A deterministic agent: it alternates '3clicks' and 'mask' and
    values the mask's foreground share."""
    calls = []

    def act(emb, mask224):
        assert np.asarray(emb).shape == (1, 64, 64, 256)
        calls.append(1)
        return len(calls) % 2, float(_host(mask224).mean())

    return act


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

def test_session_and_metrics_match_jax(engines, samples_with_empty_frame):
    jengine, engine = engines
    jsample, sample = samples_with_empty_frame
    js, s = jx.initialize(jengine, jsample), pt.initialize(engine, sample)
    assert s.frames_list == [0] and s.frame_interaction_type[0] == 1
    assert s.annotation_times == [ANNOTATION_COSTS["mask"]]
    assert s.donate and s.state.prob.device.type == "cpu"
    for sess in (js, s):
        sess.interact(sess.gt_mask(0), 0)
        sess.frame_interaction_type[0] = 1
        sess.frames_list.append(3)
        sess.frame_interaction_type[3] = 2       # a SAM mask on frame 3
        sess.masks_from_sam[3] = sess.sample.gt[0, 1].astype(np.float32)
        sess.sam_dirty.add(3)
    for metric in ("j", "j_and_f"):
        mu, gen, fq, fq_all = pt.eval_session_metric(s, metric)
        jmu, jgen, jfq, jfq_all = jx.eval_session_metric(js, metric)
        assert isinstance(gen, torch.Tensor) and gen.dtype == torch.float32
        assert np.mean(gen.numpy() == np.asarray(jgen)) >= MASK_AGREE
        assert fq_all[2] == jfq_all[2] == pt.EMPTY_GT_TOKEN
        assert len(fq) == len(jfq) == T - 1
        assert fq_all[0] == 1.0
        np.testing.assert_array_equal(gen[0].numpy(), sample.gt[0, 0])
        np.testing.assert_array_equal(gen[3].numpy(), sample.gt[0, 1])
        np.testing.assert_allclose(fq_all, jfq_all, rtol=0, atol=METRIC_ATOL)
        assert abs(mu - jmu) <= METRIC_ATOL
    assert s.timers.counts["propagate"] == 1
    assert s.timers.counts["eval[j]"] == s.timers.counts["eval[j_and_f]"] == 1
    assert pt.not_avail_frames([1.0, 20, 0.5], [0, 2], 3) is True
    assert pt.not_avail_frames([1.0, 0.3, 0.5], [0], 3) is False


@pytest.mark.parametrize("metric", ["j", "j_and_f"])
def test_host_metrics_path_is_bit_equal(engines, samples, monkeypatch,
                                        metric):
    """EVAVOS_HOST_METRICS (the per-frame host loop) gives the device
    path's masks and qualities bit for bit."""
    s = pt.initialize(engines[1], samples[1])
    s.interact(s.gt_mask(0), 0)
    s.frames_list.append(2)
    s.frame_interaction_type[2] = 2
    s.masks_from_sam[2] = np.roll(samples[1].gt[0, 2], 3, axis=1)[None]
    s.sam_dirty.add(2)
    mu, gen, _, fq_all = pt.eval_session_metric(s, metric)
    monkeypatch.setenv("EVAVOS_HOST_METRICS", "1")
    hmu, hgen, _, hfq_all = pt.eval_session_metric(s, metric)
    assert isinstance(hgen, np.ndarray)
    np.testing.assert_array_equal(gen.numpy(), hgen)
    assert fq_all == hfq_all and mu == hmu


def test_clone_lookahead_leaves_the_parent(engines, samples):
    s = pt.initialize(engines[1], samples[1])
    s.interact(s.gt_mask(0), 0)
    prob, bank_k = s.state.prob.clone(), s.state.bank_k.clone()
    look = s.clone()
    assert not look.donate and look.state.prob is s.state.prob
    look.frame_interaction_type[3] = 1
    look.interact(look.gt_mask(3), 3)
    assert torch.equal(s.state.prob, prob)
    assert torch.equal(s.state.bank_k, bank_k)
    assert not torch.equal(look.state.prob, prob)
    assert s.state.certain_count == 1 and look.state.certain_count == 2
    assert s.frame_interaction_type[3] == 0


def test_clone_sam_store_leaves_the_parent(engines, samples):
    """A clone's SAM mask lands in its own device mirror, never in the
    parent's, also on a frame the parent holds as type 2."""
    s = pt.initialize(engines[1], samples[1])
    s.interact(s.gt_mask(0), 0)
    s.frames_list.append(2)
    s.frame_interaction_type[2] = 2
    s.masks_from_sam[2] = samples[1].gt[0, 2][None].astype(np.float32)
    s.sam_dirty.add(2)
    _, gen, _, fq_all = pt.eval_session_metric(s, "j")
    sam_dev = s.sam_dev.clone()
    look = s.clone()
    look.masks_from_sam[2] = np.roll(samples[1].gt[0, 2], 5, axis=1)[None]
    look.masks_from_sam[4] = samples[1].gt[0, 4][None].astype(np.float32)
    look.frames_list.append(4)
    look.frame_interaction_type[4] = 2
    look.sam_dirty.update((2, 4))
    _, lgen, _, _ = pt.eval_session_metric(look, "j")
    assert torch.equal(s.sam_dev, sam_dev)
    np.testing.assert_array_equal(lgen[2].numpy(),
                                  look.masks_from_sam[2][0])
    np.testing.assert_array_equal(lgen[4].numpy(), samples[1].gt[0, 4])
    _, gen2, _, fq_all2 = pt.eval_session_metric(s, "j")
    assert torch.equal(gen2, gen) and fq_all2 == fq_all


def test_feature_cache_reuses_features(engines, samples):
    s1 = pt.initialize(engines[1], samples[1])
    s2 = pt.initialize(engines[1], samples[1])
    assert s1.feats is s2.feats and s1.state is not s2.state
    assert s1.feats.k16.dtype == engines[1].stcn.dtype == torch.float32


def test_farthest_point_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((7, 4)).astype(np.float32)
    cases = [[0], [0, 2], [3, 3, 1], [6, 5, 4, 3, 2, 1, 0, 0]]
    for frames in cases:
        assert (pt.farthest_point_selection(feats, frames) ==
                jx.farthest_point_selection(feats, frames))
        assert (pt.farthest_point_selection(torch.from_numpy(feats), frames)
                == jx.farthest_point_selection(feats, frames))
    ties = np.array([[0.0], [1.0], [-1.0]], np.float32)   # first max wins
    assert pt.farthest_point_selection(ties, [0]) == 1


# ---------------------------------------------------------------------------
# the mask loops
# ---------------------------------------------------------------------------

def test_oracle_mask_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    for metric in ("j", "j_and_f"):
        got, want = _run_both(
            monkeypatch, [jx_mask], [pt_mask],
            lambda: jx.oracle_mask(ROUNDS, jengine, jsample, metric),
            lambda: pt.oracle_mask(ROUNDS, engine, sample, metric))
        _assert_results(got, want, exact={1})
        assert len(got[0]) == ROUNDS and got[1][0] == ANNOTATION_COSTS["mask"]


@pytest.mark.parametrize("loop", ["oracle_mask", "rand_mask"])
def test_empty_frame_matches_jax(engines, samples_with_empty_frame,
                                 monkeypatch, loop):
    """Every frame in turn: the empty one is recorded at the no-object
    cost when it is chosen (the random loop chooses it), on both sides."""
    (jengine, engine), (jsample, sample) = engines, samples_with_empty_frame
    def kw():
        return {"rng": np.random.default_rng(0)} if loop == "rand_mask" else {}

    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: getattr(jx, loop)(T - 1, jengine, jsample, "j", **kw()),
        lambda: getattr(pt, loop)(T - 1, engine, sample, "j", **kw()))
    _assert_results(got, want, exact={1})
    frames = pt_eval.LAST_SESSION.frames_list
    assert (ANNOTATION_COSTS["no_object"] in got[1]) == (2 in frames[1:-1])
    if loop == "rand_mask":
        assert ANNOTATION_COSTS["no_object"] in got[1]


def test_rand_mask_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: jx.rand_mask(T - 1, jengine, jsample, "j",
                             rng=np.random.default_rng(0)),
        lambda: pt.rand_mask(T - 1, engine, sample, "j",
                             rng=np.random.default_rng(0)))
    _assert_results(got, want, exact={1})
    frames = pt_eval.LAST_SESSION.frames_list
    assert len(set(frames)) == len(frames)


def test_oracle_mask_dataset_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: jx.oracle_mask_dataset(ROUNDS, jengine, jsample, "j"),
        lambda: pt.oracle_mask_dataset(ROUNDS, engine, sample, "j"))
    gen, frames, metrics, times = got
    assert frames == want[1] and times == want[3]
    assert len(gen) == ROUNDS
    for g, w, gm, wm in zip(gen, want[0], metrics, want[2]):
        assert isinstance(g, np.ndarray) and g.shape == (T, H, W)
        assert np.mean(g == np.asarray(w)) >= MASK_AGREE
        np.testing.assert_allclose(gm, wm, rtol=0, atol=METRIC_ATOL)


def test_upper_bound_mask_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: jx.upper_bound_mask(2, jengine, jsample, "j"),
        lambda: pt.upper_bound_mask(2, engine, sample, "j"))
    _assert_results(got, want, exact={1})


def test_l2_mask_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: jx.l2_mask(lambda x: jnp.asarray(_encoder_features(x)),
                           ROUNDS, jengine, jsample, "j"),
        lambda: pt.l2_mask(lambda x: torch.as_tensor(_encoder_features(x)),
                           ROUNDS, engine, sample, "j"))
    _assert_results(got, want, exact={1})


def test_qnet_mask_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: jx.qnet_mask(_jx_qnet, ROUNDS, jengine, jsample, "j"),
        lambda: pt.qnet_mask(_pt_qnet, ROUNDS, engine, sample, "j"))
    _assert_results(got, want, exact={1})


def test_qnet_inputs_match_jax(samples):
    """The QNet's inputs: bicubic 224 frames (within 1e-5) and nearest 224
    masks (exactly), from float and from uint8 frames."""
    from eva_vos_tpu.interactions import policies as jx_policies
    from eva_vos_tpu_torch.interactions import policies as pt_policies

    images = samples[1].images01
    for x in (images, (images * 255).astype(np.uint8)):
        got = pt_policies.frames_to_224(x, device="cpu")
        assert got.shape == (T, 224, 224, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jx_policies.frames_to_224(x)), rtol=0,
            atol=1e-5)
    m = samples[1].gt[0].astype(np.float32)
    want = np.asarray(jx_policies.masks_to_224_3ch(m))
    np.testing.assert_array_equal(
        pt_policies.masks_to_224_3ch(m, device="cpu").numpy(), want)
    np.testing.assert_array_equal(
        pt_policies.masks_to_224_3ch(torch.from_numpy(m)).numpy(), want)


# ---------------------------------------------------------------------------
# the multi-type loops on the fake SAM
# ---------------------------------------------------------------------------

def _annotators():
    return JxAnnotator(JxFakeSAM()), Annotator(FakeSAMController())


def test_oracle_oracle_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    jann, ann = _annotators()
    types = ("click", "bbox", "3clicks", "mask")
    got, want = _run_both(
        monkeypatch, [jx_multiple], [pt_multiple],
        lambda: jx.oracle_oracle(ROUNDS + 1, jengine, jsample, jann,
                                 annotation_types=types, eval_metric="j"),
        lambda: pt.oracle_oracle(ROUNDS + 1, engine, sample, ann,
                                 annotation_types=types, eval_metric="j"))
    _assert_results(got[:3] + got[4:], want[:3] + want[4:], exact={1, 2, 3})
    for g, w in zip(got[3], want[3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=METRIC_ATOL)
    assert got[2][0] == "mask"


def test_rand_type_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    jann, ann = _annotators()
    got, want = _run_both(
        monkeypatch, [jx_multiple], [pt_multiple],
        lambda: jx.rand_type(5, jengine, jsample, jann, "3clicks", "j",
                             rng=np.random.default_rng(7)),
        lambda: pt.rand_type(5, engine, sample, ann, "3clicks", "j",
                             rng=np.random.default_rng(7)))
    _assert_results(got, want, exact={1, 2})
    assert len(ann._embed_cache) == len(jann._embed_cache) > 0


@pytest.mark.parametrize("metric", ["j", "j_and_f"])
def test_rand_rand_matches_jax(engines, samples, monkeypatch, metric):
    (jengine, engine), (jsample, sample) = engines, samples
    jann, ann = _annotators()
    types = ("3clicks", "mask")
    got, want = _run_both(
        monkeypatch, [jx_multiple], [pt_multiple],
        lambda: jx.rand_rand(ROUNDS + 2, jengine, jsample, jann, types,
                             metric, rng=np.random.default_rng(2)),
        lambda: pt.rand_rand(ROUNDS + 2, engine, sample, ann, types, metric,
                             rng=np.random.default_rng(2)))
    _assert_results(got, want, exact={1, 2})
    # a frame with a full mask is never picked again
    s = pt_eval.LAST_SESSION
    masked = [f for f, a in zip(s.frames_list, got[2]) if a == "mask"]
    assert len(set(masked)) == len(masked)


def test_eva_vos_matches_jax(engines, samples, monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    jann, ann = _annotators()
    got, want = _run_both(
        monkeypatch, [jx_multiple], [pt_multiple],
        lambda: jx.eva_vos(_jx_qnet, _rl_agent(), ROUNDS + 1, jengine,
                           jsample, jann, eval_metric="j"),
        lambda: pt.eva_vos(_pt_qnet, _rl_agent(), ROUNDS + 1, engine, sample,
                           ann, eval_metric="j"))
    mus, times, values, actions, round_metrics, frames = got
    _assert_results([mus, times, values, actions, frames],
                    [want[0], want[1], want[2], want[3], want[5]],
                    exact={1, 3, 4})
    assert values[0] == -2 and actions[0] == "mask"
    assert set(actions[1:]) <= {"3clicks", "mask"} and len(set(actions)) == 2
