"""The port's networks against the JAX package's, on the CPU, in fp32.

JAX parameter trees of random, non-trivial values (BatchNorm statistics
and scales, biases: the weight mapping is exercised, not identities and
zeros) are carried across with
``eva_vos_tpu_torch.utils.weight_convert``; the port's modules load them
with ``strict=True``.  Then each ``PropagationNetwork`` method and FusionNet
run on the same numpy inputs at 48x64 frames with a resnet18 key encoder,
and a resnet50 trunk at 32x32.

Tolerance: XLA's and oneDNN's fp32 convolutions sum in different orders, and
a ResNet stacks 20-50 of them, so outputs agree to ~1e-6 relative per conv
and a few 1e-5 after the trunk: atol 1e-4 times the output's largest
magnitude (at least 1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.models import FusionNet as JxFusion
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu.models.resnet import ResNetTrunk as JxTrunk
from eva_vos_tpu.utils.weight_convert import invert_fusion, invert_stcn
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork, ResNetTrunk
from eva_vos_tpu_torch.models.fused_trunk import FusedTrunk
from eva_vos_tpu_torch.utils import weight_convert as wc

H, W, K = 48, 64, 2


def _close(ours, theirs):
    ref = np.asarray(theirs, np.float32)
    atol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0, atol=atol)


def _random_variables(shapes, rng, path=()):
    """Random flax variables of the given shape tree (from
    ``jax.eval_shape`` of ``init``, which traces without compiling): conv and
    dense kernels ~ N(0, 1/fan_in), non-trivial BatchNorm statistics and
    scales, and non-zero biases, so the weight mapping is exercised."""
    if hasattr(shapes, "items"):
        return {k: _random_variables(v, rng, (*path, k))
                for k, v in shapes.items()}
    shape, name = shapes.shape, path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        x = rng.standard_normal(shape) / np.sqrt(fan_in)
    elif name == "var":
        x = rng.uniform(0.5, 2.0, shape)
    elif name == "scale":
        x = rng.uniform(0.5, 1.5, shape)
    else:  # bias, mean
        x = 0.1 * rng.standard_normal(shape)
    return x.astype(np.float32)


def _init(module, rng, *args, **kwargs):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return _random_variables(shapes, rng)


@pytest.fixture(scope="module")
def stcn_pair():
    jx = JxSTCN(key_arch="resnet18", value_arch="resnet18")
    variables = _init(jx, np.random.default_rng(7), jnp.zeros((H, W, 3)),
                      jnp.zeros((K, H, W)), method="init_all")
    ours = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    ours.load_state_dict(
        wc.stcn_state_dict_from_flax(variables, "resnet18", "resnet18"),
        strict=True)
    return jx, variables, ours.eval()


def _fusion_variables(rng):
    return _init(JxFusion(), rng, jnp.zeros((H, W, 3)), jnp.zeros((H, W)),
                 jnp.zeros((H, W)), jnp.zeros((H, W, 2)), jnp.zeros((2,)))


def test_stcn_state_dict_matches_jax_inverse():
    """The production widths (resnet50 key, resnet18 value encoder), key for
    key against the JAX package's inverse converter, and a strict load."""
    jx = JxSTCN(key_arch="resnet50", value_arch="resnet18")
    variables = _init(jx, np.random.default_rng(5), jnp.zeros((32, 32, 3)),
                      jnp.zeros((1, 32, 32)), method="init_all")
    ours = wc.stcn_state_dict_from_flax(variables, "resnet50", "resnet18")
    ref = invert_stcn(variables, key_arch="resnet50", value_arch="resnet18")
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value),
                                      err_msg=key)
    PropagationNetwork().load_state_dict(ours, strict=True)


def test_fusion_state_dict_matches_jax_inverse():
    variables = _fusion_variables(np.random.default_rng(3))
    ours = wc.fusion_state_dict_from_flax(variables)
    ref = invert_fusion(variables)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value))


def test_encode_key(stcn_pair, rng):
    jx, variables, ours = stcn_pair
    frames = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    ref = jx.apply(variables, jnp.asarray(frames), method="encode_key")
    with torch.no_grad():
        got = ours.encode_key(torch.from_numpy(frames))
    for name in ("k16", "f16_thin", "f16", "f8", "f4"):
        assert getattr(got, name).shape == getattr(ref, name).shape, name
        _close(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("k", [1, K])
def test_encode_value(stcn_pair, rng, k):
    jx, variables, ours = stcn_pair
    frame = rng.standard_normal((H, W, 3)).astype(np.float32)
    kf16 = rng.standard_normal((H // 16, W // 16, 256)).astype(np.float32)
    masks = (rng.uniform(0, 1, (k, H, W)) > 0.5).astype(np.float32)
    ref = jx.apply(variables, jnp.asarray(frame), jnp.asarray(kf16),
                   jnp.asarray(masks), method="encode_value")
    with torch.no_grad():
        got = ours.encode_value(torch.from_numpy(frame),
                                torch.from_numpy(kf16), torch.from_numpy(masks))
    assert got.shape == ref.shape
    _close(got, ref)


def test_decode_with_readout_and_skips(stcn_pair, rng):
    jx, variables, ours = stcn_pair
    h, w = H // 16, W // 16
    readout = rng.standard_normal((K, h, w, 512)).astype(np.float32)
    qv16 = rng.standard_normal((h, w, 512)).astype(np.float32)
    qf8 = rng.standard_normal((2 * h, 2 * w, 128)).astype(np.float32)
    qf4 = rng.standard_normal((4 * h, 4 * w, 64)).astype(np.float32)
    args = [jnp.asarray(a) for a in (readout, qv16, qf8, qf4)]
    targs = [torch.from_numpy(a) for a in (readout, qv16, qf8, qf4)]
    ref = jx.apply(variables, *args, method="decode_with_readout")
    ref_s8, ref_s4 = jx.apply(variables, args[2], args[3],
                              method="encode_skips")
    with torch.no_grad():
        got = ours.decode_with_readout(*targs)
        s8, s4 = ours.encode_skips(targs[2], targs[3])
        hoisted = ours.decode_with_readout(targs[0], targs[1], s8, s4,
                                           skips_precomputed=True)
        logits = ours.decode_with_readout(*targs, return_logits=True)
    ref_logits = jx.apply(variables, *args, return_logits=True,
                          method="decode_with_readout")
    assert got.shape == (K, H, W)
    _close(got, ref)
    _close(s8, ref_s8)
    _close(s4, ref_s4)
    _close(hoisted, ref)
    _close(logits, ref_logits)


def test_get_attention(stcn_pair, rng):
    jx, variables, ours = stcn_pair
    h, w = H // 16, W // 16
    mk16 = rng.standard_normal((h, w, 64)).astype(np.float32)
    qk16 = rng.standard_normal((h, w, 64)).astype(np.float32)
    pos = rng.uniform(0, 1, (K, H, W)).astype(np.float32)
    neg = rng.uniform(0, 1, (K, H, W)).astype(np.float32)
    ref = jx.apply(variables, *(jnp.asarray(a) for a in (mk16, pos, neg, qk16)),
                   method="get_attention")
    got = ours.get_attention(*(torch.from_numpy(a) for a in (mk16, pos, neg,
                                                             qk16)))
    assert got.shape == (K, H, W, 2)
    _close(got, ref)


def test_fusion_net(rng):
    jx = JxFusion()
    variables = _fusion_variables(rng)
    ours = FusionNet()
    ours.load_state_dict(wc.fusion_state_dict_from_flax(variables), strict=True)
    im = rng.standard_normal((H, W, 3)).astype(np.float32)
    seg1, seg2 = rng.uniform(0, 1, (2, K, H, W)).astype(np.float32)
    attn = rng.uniform(0, 1, (K, H, W, 2)).astype(np.float32)
    time = np.asarray([0.25, 0.75], np.float32)
    with torch.no_grad():
        got = ours(*(torch.from_numpy(a) for a in (im, seg1, seg2, attn, time)))
    for k in range(K):   # the JAX engine maps the net over objects
        ref = jx.apply(variables, jnp.asarray(im), jnp.asarray(seg1[k]),
                       jnp.asarray(seg2[k]), jnp.asarray(attn[k]),
                       jnp.asarray(time))
        _close(got[k], ref)


def test_resnet50_trunk(rng):
    jx = JxTrunk(arch="resnet50", num_stages=3, conv_bias=False)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    variables = _init(jx, rng, jnp.asarray(x))
    walker = wc._Walker(variables)
    wc._trunk(walker, (), "m", "resnet50", 3, False,
              ["layer1", "layer2", "layer3"])
    ours = ResNetTrunk("resnet50", num_stages=3, conv_bias=False)
    ours.load_state_dict({k[2:]: v for k, v in walker.sd.items()}, strict=True)
    ref = jx.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r)


@pytest.mark.parametrize("arch, num_stages, conv_bias, in_chans", [
    ("resnet50", 3, False, 3),    # the key encoder's trunk
    ("resnet18", 3, True, 5),     # the value encoder's trunk
    ("resnet50", 2, True, 5),     # biased bottleneck downsamples: their
    #                               bias joins the block's last epilogue
], ids=["key_resnet50", "value_resnet18", "biased_downsample"])
def test_fused_trunk(rng, arch, num_stages, conv_bias, in_chans):
    """The engine's folded trunk against the trunk it was folded from and
    the JAX trunk, with non-trivial BatchNorm statistics and biases."""
    jx = JxTrunk(arch=arch, num_stages=num_stages, conv_bias=conv_bias)
    x = rng.standard_normal((2, 32, 48, in_chans)).astype(np.float32)
    variables = _init(jx, rng, jnp.asarray(x))
    walker = wc._Walker(variables)
    wc._trunk(walker, (), "m", arch, num_stages, conv_bias)
    ours = ResNetTrunk(arch, num_stages=num_stages, conv_bias=conv_bias,
                       in_chans=in_chans)
    ours.load_state_dict({k[2:]: v for k, v in walker.sd.items()}, strict=True)
    ours.eval()
    fused = FusedTrunk(ours)
    assert fused.bn_folded == sum(
        isinstance(m, torch.nn.BatchNorm2d) for m in ours.modules())
    ref = jx.apply(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        unfused = ours(xt)
    got = fused(xt)
    assert len(got) == num_stages
    for g, u, r in zip(got, unfused, ref):
        _close(g, u.numpy())
        _close(g.permute(0, 2, 3, 1), r)
