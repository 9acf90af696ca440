"""The port's decision models and feature extractors against the JAX
package's, on the CPU, in fp32.

Random, non-trivial JAX parameter trees (``test_torch_port_models``) cross
over through ``eva_vos_tpu_torch.utils.weight_convert``; each mapping is
also held against the JAX converter that reads its layout, which must give
the original tree back leaf for leaf.  Inputs are numpy from a seed.
Tolerance: atol 1e-4 times the output's largest magnitude (at least 1) and
rtol 1e-4 (XLA's and oneDNN's fp32 convolutions sum in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.models.qnet import QualityNet as JxQNet
from eva_vos_tpu.models.resnet import ResNetTrunk as JxTrunk
from eva_vos_tpu.models.rl_agent import ActorCritic as JxActorCritic
from eva_vos_tpu.models.vit import ViTEncoder as JxViT
from eva_vos_tpu.models import feature_extractors as jx_fe
from eva_vos_tpu.train.ppo.agent import PPOAgent as JxPPOAgent
from eva_vos_tpu.utils import weight_convert as jwc
from eva_vos_tpu_torch.models import ActorCritic, QualityNet, ViTEncoder
from eva_vos_tpu_torch.models import feature_extractors as fe
from eva_vos_tpu_torch.train.ppo import PPOAgent
from eva_vos_tpu_torch.utils import weight_convert as wc
from test_torch_port_models import _init

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: its many small torch ops slow
    down in a thread pool that spins while the suite's workers share the
    cores (a module's results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, theirs):
    ref = np.asarray(theirs, np.float32)
    got = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    atol = TOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=atol)


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_round_trip(converted, original):
    """A JAX converter's output equals the original tree, leaf for leaf."""
    for coll in ("params", "batch_stats"):
        assert not jwc.check_tree_matches(original, converted, coll), coll
        want = jax.tree_util.tree_flatten_with_path(original.get(coll, {}))[0]
        got = dict(jax.tree_util.tree_flatten_with_path(
            converted.get(coll, {}))[0])
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

VIT = dict(patch_size=8, dim=32, depth=2, num_heads=4, img_size=32)


@pytest.mark.parametrize("layerscale", [False, True])
def test_vit_matches_jax(layerscale, rng):
    jx = JxViT(layerscale=layerscale, **VIT)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = _init(jx, np.random.default_rng(1), jnp.asarray(x))
    heads, depth = VIT["num_heads"], VIT["depth"]
    if layerscale:
        sd = wc.dinov2_state_dict_from_flax(variables)
        back = jwc.convert_dinov2(_numpy_sd(sd), depth=depth, heads=heads)
    else:
        sd = wc.tv_vit_state_dict_from_flax(variables)
        back = jwc.convert_tv_vit(_numpy_sd(sd), depth=depth, heads=heads)
    _assert_round_trip(back, variables)
    ours = _load(ViTEncoder(layerscale=layerscale, **VIT), sd)
    cls_ref, patches_ref = jx.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        cls, patches = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(cls, cls_ref)
    _close(patches, patches_ref)


# ---------------------------------------------------------------------------
# QNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,merge", [("resnet18", "cat"),
                                        ("resnet18", "add"),
                                        ("resnet18", "attn"),
                                        ("small", "cat")])
def test_qnet_matches_jax(arch, merge, rng):
    jx = JxQNet(arch=arch, merge_strategy=merge)
    rgb = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 1)) > 0.5).repeat(3, -1).astype(np.float32)
    variables = _init(jx, np.random.default_rng(2), jnp.asarray(rgb),
                      jnp.asarray(mask))
    sd = wc.qnet_state_dict_from_flax(variables, arch=arch)
    if merge != "attn":   # the JAX converter has no attn merge
        _assert_round_trip(jwc.convert_qnet(_numpy_sd(sd), arch=arch),
                           variables)
    ours = _load(QualityNet(arch=arch, merge_strategy=merge), sd)
    args = (jnp.asarray(rgb), jnp.asarray(mask))
    with torch.no_grad():
        logits = ours(torch.from_numpy(rgb), torch.from_numpy(mask))
    feats = ours.extract_features(torch.from_numpy(rgb),
                                  torch.from_numpy(mask))
    _close(logits, jx.apply(variables, *args))
    _close(feats, jx.apply(variables, *args, method="extract_features"))


# ---------------------------------------------------------------------------
# ActorCritic and the PPO agent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,use_cost,mask_hw", [("resnet18", False, 64),
                                                    ("resnet18", True, 64),
                                                    ("vit_b_32", False, 224)])
def test_actor_critic_matches_jax(arch, use_cost, mask_hw, rng):
    jx = JxActorCritic(out_dim=3, arch=arch, use_cost=use_cost)
    emb = rng.standard_normal((2, 8, 8, 256)).astype(np.float32)
    mask = rng.random((2, mask_hw, mask_hw, 3)).astype(np.float32)
    cost = rng.random((2, 1)).astype(np.float32) if use_cost else None
    jargs = [jnp.asarray(emb), jnp.asarray(mask)]
    if use_cost:
        jargs.append(jnp.asarray(cost))
    variables = _init(jx, np.random.default_rng(3), *jargs)
    sd = wc.actor_critic_state_dict_from_flax(variables, arch=arch)
    if "vit" not in arch:   # the JAX converter reads the ResNet branch only
        _assert_round_trip(
            jwc.convert_actor_critic(_numpy_sd(sd), arch=arch), variables)
    ours = _load(ActorCritic(out_dim=3, arch=arch, use_cost=use_cost), sd)
    p_ref, v_ref = jx.apply(variables, *jargs)
    with torch.no_grad():
        p, v = ours(torch.from_numpy(emb), torch.from_numpy(mask),
                    None if cost is None else torch.from_numpy(cost))
    _close(p, p_ref)
    _close(v, v_ref)


def test_ppo_agent_logits_and_values_match_jax(rng):
    """Logits and values equal the JAX agent's; the sampled action comes
    from the port's own seeded generator (a difference by design)."""
    jx = JxActorCritic(out_dim=2, arch="resnet18", dropout=0.0)
    emb = rng.standard_normal((1, 64, 64, 256)).astype(np.float32)
    mask = rng.random((1, 64, 64, 3)).astype(np.float32)
    variables = _init(jx, np.random.default_rng(4), jnp.asarray(emb),
                      jnp.asarray(mask))
    sd = wc.actor_critic_state_dict_from_flax(variables)
    jagent = JxPPOAgent(2, "resnet18", variables, return_logits=True)
    agent = PPOAgent(2, "resnet18", sd, return_logits=True, device="cpu")
    logits, value = agent.act(emb, mask)
    jlogits, jvalue = jagent.act(emb, mask)
    _close(logits, jlogits)
    _close(value, jvalue)
    sampler = PPOAgent(2, "resnet18", sd, seed=5, device="cpu")
    actions = [sampler.act_fn()(emb, torch.from_numpy(mask))[0]
               for _ in range(4)]
    again = PPOAgent(2, "resnet18", sd, seed=5, device="cpu")
    assert actions == [again.act(emb, mask)[0] for _ in range(4)]
    assert set(actions) <= {0, 1}
    _close(np.asarray([sampler.act(emb, mask)[1]]), jvalue.reshape(-1))


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("uint8", [False, True])
def test_eval_transform_matches_jax(method, uint8, rng):
    x = rng.uniform(0, 1, (2, 300, 400, 3)).astype(np.float32)
    if uint8:
        x = (x * 255).astype(np.uint8)
    got = fe.eval_transform(x, method=method, device="cpu")
    assert got.shape == (2, 224, 224, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jx_fe.eval_transform(x, method=method)),
        rtol=0, atol=1e-4)


def test_resnet_state_dict_round_trip(rng):
    variables = _init(JxTrunk(arch="resnet50", num_stages=4),
                      np.random.default_rng(6), jnp.zeros((1, 32, 32, 3)))
    sd = wc.tv_resnet_state_dict_from_flax(variables, arch="resnet50")
    _assert_round_trip(jwc.convert_tv_resnet(_numpy_sd(sd), arch="resnet50"),
                       variables)


@pytest.mark.parametrize("name", ["resnet18", "dino_small"])
def test_feature_extractor_matches_jax(name, tmp_path, monkeypatch, rng):
    """One checkpoint in the torchvision / DINOv2 layout, written from a
    random JAX tree: the JAX extractor reads it through its converter, the
    port's loads it as it is; both give the same features."""
    if name.startswith("resnet"):
        jx = JxTrunk(arch=name, num_stages=4)
        variables = _init(jx, np.random.default_rng(8),
                          jnp.zeros((1, 224, 224, 3)))
        sd = wc.tv_resnet_state_dict_from_flax(variables, arch=name)
    else:
        jx = JxViT(img_size=224, layerscale=True, **fe.VIT_CONFIGS[name])
        variables = _init(jx, np.random.default_rng(8),
                          jnp.zeros((1, 224, 224, 3)))
        sd = wc.dinov2_state_dict_from_flax(variables)
    (tmp_path / "feature_extractors").mkdir()
    torch.save(sd, tmp_path / "feature_extractors" / f"{name}.pth")
    monkeypatch.setenv("EVAVOS_WEIGHTS_ROOT", str(tmp_path))
    images = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    got = fe.build_feature_extractor(name, device="cpu")(images)
    want = jx_fe.build_feature_extractor(name)(images)
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    _close(got, want)


def test_feature_extractor_needs_weights_or_allow_random(tmp_path,
                                                         monkeypatch, rng):
    monkeypatch.setenv("EVAVOS_WEIGHTS_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        fe.build_feature_extractor("resnet18", device="cpu")
    with pytest.raises(AttributeError):
        fe.build_feature_extractor("alexnet", allow_random=True, device="cpu")
    extract = fe.build_feature_extractor("resnet18", allow_random=True,
                                         device="cpu", seed=3)
    images = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    a = extract(images)
    b = fe.build_feature_extractor("resnet18", allow_random=True,
                                   device="cpu", seed=3)(images)
    assert a.shape == (2, 512 * 7 * 7) and torch.isfinite(a).all()
    assert torch.equal(a, b)
