"""The engine's folded encoder trunks (``models/fused_trunk.py``): the engine
folds the key and value encoders' BatchNorms into their convolutions once a
weight load, runs the folds in ``precompute_features`` and ``_store``, and
leaves the network it was given as it was.

The engine is built first and its network loaded afterwards, as the
benchmark's ``program.build`` does, with random weights, non-trivial
BatchNorm statistics, scales and shifts, and biases.  Each output is held
to an unfused copy of the network at the models tests' tolerance (atol 1e-4
times the output's largest magnitude).  The test marked ``cuda`` runs the
trunks at 480x864 on the card with cuDNN's epilogues in TF32, as the engine
does there.
"""

import copy

import numpy as np
import pytest
import torch

from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine, pad_mask,
                                      prepare_video)
from eva_vos_tpu_torch.models import PropagationNetwork, ResNetTrunk
from eva_vos_tpu_torch.models.fused_trunk import FusedTrunk
from eva_vos_tpu_torch.utils.profiling import TRACE

T, H, W = 6, 48, 64
ARCHS = dict(key_arch="resnet18", value_arch="resnet18")
BN_PER_FOLD = 30          # two resnet18 trunks to layer3: 15 BatchNorms each


def _close(ours, ref):
    atol = 1e-4 * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(ours, ref, rtol=0, atol=atol)


def _random_state(net, seed):
    """A state dict in ``net``'s layout: conv weights ~ N(0, 1/fan_in),
    norm scales U(0.5, 1.5), running variances U(0.5, 2), means and
    biases N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v.clone()
        elif k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=g)
        elif v.dim() == 1 and k.endswith("weight"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif v.dim() == 1:
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
        else:
            sd[k] = torch.randn(v.shape, generator=g) / np.sqrt(v[0].numel())
    return sd


@pytest.fixture
def video():
    """Padded, normalised frames and the object mask of frame 3."""
    images, masks = synthetic_video(T, H, W, num_objects=1, seed=5)
    frames, pad = prepare_video(images, device="cpu")
    return frames, pad_mask(masks[:, 3], pad, device="cpu")


def _engine():
    return InferenceEngine(PropagationNetwork(**ARCHS), None,
                           EngineConfig(top_k=8, max_interactions=4,
                                        feature_chunk=4), device="cpu")


def _unfused_features(net, images):
    f = net.encode_key(images)
    skip8, skip4 = net.encode_skips(f.f8, f.f4)
    return {"k16": f.k16.flatten(1, 2), "f16_thin": f.f16_thin, "f16": f.f16,
            "f8": skip8, "f4": skip4}


def test_engine_follows_each_weight_load(video):
    images, mask = video
    engine = _engine()
    TRACE.reset()
    for load in (1, 2):
        sd = _random_state(engine.stcn, seed=load)
        engine.stcn.load_state_dict(sd, strict=True)
        ref = copy.deepcopy(engine.stcn)
        feats = engine.precompute_features(images)
        engine.precompute_features(images)
        with torch.no_grad():
            want = _unfused_features(ref, images)
        for name, value in want.items():
            _close(getattr(feats, name), value)

        state = engine.init_state(feats, num_objects=1)
        with torch.no_grad():
            engine._store(feats, state, 0, 3, mask)
            value = ref.encode_value(feats.images[3], feats.f16[3], mask)
        _close(state.bank_v[:, 0], value.flatten(1, 2))

        # one fold a load, not one a call
        assert TRACE.counters["trunk_folds"] == load
        assert TRACE.counters["bn_folded"] == load * BN_PER_FOLD
        # the caller's network keeps its keys and values
        after = engine.stcn.state_dict()
        assert list(after) == list(sd)
        for k, v in sd.items():
            torch.testing.assert_close(after[k], v, rtol=0, atol=0)
        PropagationNetwork(**ARCHS).load_state_dict(after, strict=True)


def test_engine_in_train_mode_uses_batch_statistics(video):
    images, _ = video
    images = images[:4]                     # one feature_chunk
    engine = _engine()
    engine.stcn.load_state_dict(_random_state(engine.stcn, seed=3))
    TRACE.reset()
    engine.precompute_features(images)
    assert TRACE.counters["trunk_folds"] == 1

    engine.stcn.train()
    ref = copy.deepcopy(engine.stcn)
    feats = engine.precompute_features(images)
    with torch.no_grad():
        want = _unfused_features(ref, images)
    for name, value in want.items():
        _close(getattr(feats, name), value)
    assert TRACE.counters["trunk_folds"] == 1

    # the batch statistics moved the running ones: back in eval mode the
    # trunks fold again, from the new statistics
    engine.stcn.eval()
    ref.eval()
    feats = engine.precompute_features(images)
    assert TRACE.counters["trunk_folds"] == 2
    with torch.no_grad():
        want = _unfused_features(ref, images)
    _close(feats.f16, want["f16"])


def test_bn_folded_counts_the_default_trunks():
    """43 BatchNorms in the ResNet-50 key trunk and 15 in the ResNet-18
    value trunk: 58 a fold."""
    engine = InferenceEngine(PropagationNetwork(), None, device="cpu")
    images = torch.zeros((1, 32, 32, 3))
    TRACE.reset()
    engine.precompute_features(images)
    assert TRACE.counters["bn_folded"] == 58
    assert TRACE.counters["trunk_folds"] == 1


@pytest.mark.cuda
def test_fused_trunks_on_the_card():
    """Each trunk at 480x864 against the module it was folded from, both in
    TF32 (``cudnn.allow_tf32``, the program's precision): every ReLU
    convolution and every block's last convolution takes cuDNN's fused
    epilogue, and no BatchNorm runs."""
    if not torch.cuda.is_available():
        pytest.skip("cuDNN's fused convolutions run only on an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        net = PropagationNetwork().eval()
        net.load_state_dict(_random_state(net, seed=7))
        net.cuda()
        g = torch.Generator(device="cuda").manual_seed(0)
        for module, shape, convs in (
                (net.key_encoder, (4, 3, 480, 864), (27, 13)),
                (net.value_encoder, (1, 5, 480, 864), (7, 6))):
            x = torch.randn(shape, device="cuda", generator=g).contiguous(
                memory_format=torch.channels_last)
            with torch.no_grad():
                want = ResNetTrunk.forward(module, x)
            fused = FusedTrunk(module)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                got = fused(x)
                torch.cuda.synchronize()
            ops = {e.key: e.count for e in prof.key_averages()}
            assert (ops.get("aten::cudnn_convolution_relu", 0),
                    ops.get("aten::cudnn_convolution_add_relu", 0)) == convs
            assert not any("batch_norm" in k for k in ops), ops
            for a, b in zip(got, want):
                atol = 5e-3 * float(b.abs().max())
                torch.testing.assert_close(a, b, rtol=0, atol=atol)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
