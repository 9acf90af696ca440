"""The whole slice on the CPU: ``eva_vos`` with the port's QNet,
ActorCritic and ``tiny`` SAM against the JAX loop with the same weights.

The engines, the synthetic video (T=5, 48x64) and the round-for-round
checks are ``tests/test_torch_port_interactions.py``'s.  Random JAX trees of
a resnet18 QNet (``cat`` merge), a resnet18 ActorCritic (2 actions, on the
tiny SAM's 32-channel embedding) and the tiny SAM cross over through the
port's mappings.  Both agents are wrapped in an argmax of their logits, as
the sampled actions differ by design.  Each round must choose the same
frame and annotation type, with per-frame J within the interactions test's
tolerance.  Both annotators take the fused select; the warm start is the
JAX package's device chain against the port's default, the host loop.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from eva_vos_tpu import interactions as jx
from eva_vos_tpu.annotator import Annotator as JxAnnotator
from eva_vos_tpu.interactions import multiple as jx_multiple
from eva_vos_tpu.models.qnet import QualityNet as JxQNet
from eva_vos_tpu.models.rl_agent import ActorCritic as JxActorCritic
from eva_vos_tpu.models.sam import SAMController as JxController
from eva_vos_tpu.models.sam import SamPredictor as JxPredictor
from eva_vos_tpu.models.sam.build import PRESETS as JX_PRESETS
from eva_vos_tpu.models.sam.build import Sam as JxSam
from eva_vos_tpu.train.ppo.agent import PPOAgent as JxPPOAgent
from eva_vos_tpu_torch import interactions as pt
from eva_vos_tpu_torch.annotator import Annotator
from eva_vos_tpu_torch.interactions import multiple as pt_multiple
from eva_vos_tpu_torch.models import QualityNet
from eva_vos_tpu_torch.models.sam import Sam, SAMController, SamPredictor
from eva_vos_tpu_torch.models.sam.build import PRESETS
from eva_vos_tpu_torch.train.ppo import PPOAgent
from eva_vos_tpu_torch.utils import (actor_critic_state_dict_from_flax,
                                     qnet_state_dict_from_flax,
                                     sam_state_dict_from_flax)
from test_torch_port_interactions import (ROUNDS, _assert_results, _run_both,
                                          engines, samples)  # noqa: F401
from test_torch_port_models import _init
from test_torch_port_decision import one_thread  # noqa: F401

CFG = PRESETS["tiny"]


@pytest.fixture(scope="module")
def models():
    """((JAX qnet_extract, act, annotator), (the port's)), one seed each."""
    x = jnp.zeros((1, 32, 32, 3))
    jq = JxQNet(arch="resnet18")
    qv = _init(jq, np.random.default_rng(31), x, x)
    qnet = QualityNet(arch="resnet18")
    qnet.load_state_dict(qnet_state_dict_from_flax(qv), strict=True)
    qnet.eval()

    emb = jnp.zeros((1, CFG.grid, CFG.grid, CFG.prompt_embed_dim))
    jac = JxActorCritic(out_dim=2, arch="resnet18", dropout=0.0)
    av = _init(jac, np.random.default_rng(32), emb, jnp.zeros((1, 64, 64, 3)))

    jsam = JxSam(config=JX_PRESETS["tiny"])
    lr = CFG.low_res
    sv = _init(jsam, np.random.default_rng(33),
               jnp.zeros((1, CFG.img_size, CFG.img_size, 3)),
               jnp.zeros((4, 2)), jnp.full((4,), -2, jnp.int32),
               jnp.zeros((lr, lr)), False)
    sam = Sam(CFG)
    sam.load_state_dict(sam_state_dict_from_flax(sv), strict=True)

    jextract = jax.jit(lambda i, m: jq.apply(qv, i, m,
                                             method="extract_features"))
    jagent = JxPPOAgent(2, "resnet18", av, return_logits=True)
    agent = PPOAgent(2, "resnet18", actor_critic_state_dict_from_flax(av),
                     return_logits=True, device="cpu")
    actions = {"jax": [], "port": []}

    def argmax_act(a, side):
        def act(e, m):
            logits, value = a.act(e, m)
            actions[side].append(int(np.argmax(logits[0])))
            return actions[side][-1], float(np.asarray(value).reshape(-1)[0])
        return act

    return ((jextract, argmax_act(jagent, "jax"),
             lambda: JxAnnotator(JxController(JxPredictor(jsam, sv)))),
            (qnet.extract_features, argmax_act(agent, "port"),
             lambda: Annotator(SAMController(SamPredictor(sam.eval())))),
            actions)


def test_eva_vos_with_ported_models_matches_jax(engines, samples, models,
                                                monkeypatch):
    (jengine, engine), (jsample, sample) = engines, samples
    (jq, jact, jann), (q, act, ann), actions = models
    rounds = ROUNDS + 2
    got, want = _run_both(
        monkeypatch, [jx_multiple], [pt_multiple],
        lambda: jx.eva_vos(jq, jact, rounds, jengine, jsample, jann(),
                           eval_metric="j"),
        lambda: pt.eva_vos(q, act, rounds, engine, sample, ann(),
                           eval_metric="j"))
    mus, times, values, chosen, round_metrics, frames = got
    _assert_results([mus, times, values, chosen, frames],
                    [want[0], want[1], want[2], want[3], want[5]],
                    exact={1, 3, 4})
    assert actions["port"] == actions["jax"]
    assert chosen[0] == "mask" and len(chosen) >= ROUNDS
    # the agent chose SAM's clicks at least once: the SAM path ran
    assert "3clicks" in chosen


def test_qnet_mask_with_ported_qnet_matches_jax(engines, samples, models,
                                                monkeypatch):
    from eva_vos_tpu.interactions import mask as jx_mask
    from eva_vos_tpu_torch.interactions import mask as pt_mask

    (jengine, engine), (jsample, sample) = engines, samples
    (jq, _, _), (q, _, _), _ = models
    got, want = _run_both(
        monkeypatch, [jx_mask], [pt_mask],
        lambda: jx.qnet_mask(jq, ROUNDS, jengine, jsample, "j"),
        lambda: pt.qnet_mask(q, ROUNDS, engine, sample, "j"))
    _assert_results(got, want, exact={1})
