"""The port's propagation engine against the JAX engine, on the CPU, in fp32.

Both engines get the same random weights (carried across with
``eva_vos_tpu_torch.utils.weight_convert``) and the same synthetic video
(T=6, 48x64, mem_freq=2, top_k=8), and interact with frame 0 and then
frame 4, so that the second interaction's backward pass fuses through
FusionNet.  The JAX engine reads its memory with the plain 'gather'
strategy; the port's engine takes 'auto', which is the plain read on the
CPU.

Tolerance: the probability volume goes through about 40 fp32 convolutions
per frame, summed in different orders by XLA and oneDNN, and through
memory reads whose inputs carry those differences: atol 1e-4 holds it.
The argmax masks must agree on at least 99.9% of pixels (a pixel whose two
top probabilities are within the tolerance may flip).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.engine.propagation import EngineConfig as JxConfig
from eva_vos_tpu.engine.propagation import InferenceEngine as JxEngine
from eva_vos_tpu.engine.propagation import pad_mask as jx_pad_mask
from eva_vos_tpu.engine.propagation import prepare_video as jx_prepare
from eva_vos_tpu.models import FusionNet as JxFusion
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine, pad_mask,
                                      prepare_video)
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.utils import (fusion_state_dict_from_flax,
                                     stcn_state_dict_from_flax)

T, H, W = 6, 48, 64
MEM_FREQ, TOP_K = 2, 8
ROUNDS = (0, 4)


def _random_variables(shapes, rng, path=()):
    if hasattr(shapes, "items"):
        return {k: _random_variables(v, rng, (*path, k))
                for k, v in shapes.items()}
    shape, name = shapes.shape, path[-1]
    if name == "kernel":
        x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    elif name == "var":
        x = rng.uniform(0.5, 2.0, shape)
    elif name == "scale":
        x = rng.uniform(0.5, 1.5, shape)
    else:
        x = 0.1 * rng.standard_normal(shape)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(11)
    jstcn = JxSTCN(key_arch="resnet18", value_arch="resnet18", top_k=TOP_K)
    jfusion = JxFusion()
    sp = _random_variables(jax.eval_shape(lambda: jstcn.init(
        jax.random.PRNGKey(0), jnp.zeros((H, W, 3)), jnp.zeros((1, H, W)),
        method="init_all")), rng)
    fp = _random_variables(jax.eval_shape(lambda: jfusion.init(
        jax.random.PRNGKey(1), jnp.zeros((H, W, 3)), jnp.zeros((H, W)),
        jnp.zeros((H, W)), jnp.zeros((H, W, 2)), jnp.zeros((2,)))), rng)
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    stcn.load_state_dict(stcn_state_dict_from_flax(sp, "resnet18", "resnet18"))
    fusion = FusionNet()
    fusion.load_state_dict(fusion_state_dict_from_flax(fp))
    return (jstcn, jfusion, sp, fp), (stcn, fusion)


def _port_engine(nets, block_frames, strategy="auto", max_interactions=4):
    stcn, fusion = nets[1]
    cfg = EngineConfig(mem_freq=MEM_FREQ, top_k=TOP_K,
                       max_interactions=max_interactions, feature_chunk=2,
                       block_frames=block_frames, readout_strategy=strategy)
    return InferenceEngine(stcn, fusion, cfg, device="cpu")


def _port_session(engine, images, masks):
    padded, pad = prepare_video(images, device="cpu")
    feats = engine.precompute_features(padded)
    state = engine.init_state(feats, masks.shape[0])
    probs = []
    for idx in ROUNDS:
        state = engine.interact(
            state, feats, pad_mask(masks[:, idx], pad, device="cpu"), idx)
        probs.append(state.prob.numpy().copy())
    return probs, state, pad


@pytest.mark.parametrize("k_objects", [1, 2])
@pytest.mark.parametrize("block_frames", [True, False])
def test_engine_matches_jax(nets, k_objects, block_frames):
    jstcn, jfusion, sp, fp = nets[0]
    images, masks = synthetic_video(T, H, W, num_objects=k_objects, seed=3)

    jcfg = JxConfig(mem_freq=MEM_FREQ, top_k=TOP_K, max_interactions=4,
                    feature_chunk=2, block_frames=block_frames,
                    readout_strategy="gather")
    jengine = JxEngine(jstcn, jfusion, sp, fp, jcfg)
    jpadded, jpad = jx_prepare(images)
    jfeats = jengine.precompute_features(jpadded)
    jstate = jengine.init_state(jfeats, k_objects)
    ref = []
    for idx in ROUNDS:
        jstate = jengine.interact(
            jstate, jfeats, jx_pad_mask(masks[:, idx].astype(np.float32), jpad),
            idx)
        ref.append(np.asarray(jstate.prob))

    engine = _port_engine(nets, block_frames)
    assert engine.config.readout_strategy == "gather"
    probs, state, pad = _port_session(engine, images, masks)
    assert pad == jpad
    for idx, got, want in zip(ROUNDS, probs, ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"after interacting frame {idx}")
    ours = engine.masks_from_prob(state.prob, pad)
    theirs = JxEngine.masks_from_prob(jstate.prob, jpad)
    assert ours.shape == (T, H, W) and ours.dtype == np.uint8
    assert np.mean(ours == theirs) >= 0.999
    assert state.certain_count == int(jstate.certain_count) == len(ROUNDS)
    np.testing.assert_array_equal(state.interacted,
                                  np.asarray(jstate.interacted))


@pytest.mark.parametrize("strategy", ["fused", "scatter"])
def test_readout_strategies_agree(nets, strategy):
    """The kernels' plain versions ('fused' on the CPU) and the scatter read
    drive the engine to the plain gather read's result."""
    images, masks = synthetic_video(T, H, W, num_objects=2, seed=5)
    want, _, _ = _port_session(_port_engine(nets, True), images, masks)
    got, _, _ = _port_session(_port_engine(nets, True, strategy), images,
                              masks)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_donate_and_default_leave_the_right_state(nets):
    images, masks = synthetic_video(T, H, W, num_objects=1, seed=7)
    engine = _port_engine(nets, True)
    padded, pad = prepare_video(images, device="cpu")
    feats = engine.precompute_features(padded)
    s0 = engine.init_state(feats, 1)
    m0 = pad_mask(masks[:, 0], pad, device="cpu")
    kept = engine.interact(s0, feats, m0, 0)
    assert s0.certain_count == 0 and not s0.interacted.any()
    assert torch.all(s0.bank_k == 0) and torch.all(s0.prob[1:] == 0)
    donated = engine.interact(s0, feats, m0, 0, donate=True)
    assert donated.prob is s0.prob
    assert torch.equal(donated.prob, kept.prob)
    assert torch.equal(donated.bank_v, kept.bank_v)


def test_capacity_guard(nets):
    images, masks = synthetic_video(T, H, W, num_objects=1, seed=7)
    engine = _port_engine(nets, True, max_interactions=1)
    padded, pad = prepare_video(images, device="cpu")
    feats = engine.precompute_features(padded)
    state = engine.init_state(feats, 1)
    state = engine.interact(state, feats, pad_mask(masks[:, 0], pad,
                                                   device="cpu"), 0)
    with pytest.raises(ValueError, match="capacity"):
        engine.interact(state, feats, pad_mask(masks[:, 3], pad,
                                               device="cpu"), 3)
