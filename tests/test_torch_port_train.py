"""The port's trainers, PPO environments and training CLIs against the JAX
package's, on the CPU.

Small sizes: resnet18 at 64x64 inputs, batch 4, the fake SAM, tiny STCNs
(``EVAVOS_TINY=1``).  JAX parameter trees cross over through the port's
``qnet_state_dict_from_flax`` / ``actor_critic_state_dict_from_flax`` with
random, non-trivial BatchNorm statistics (``test_torch_port_models``);
dropout is 0 on both sides (the JAX trainer's ``net`` is replaced before
its first, tracing, step).  Inputs are numpy from a seed.

The optimizer steps are compared in float64 on both sides (the JAX
trainers with ``dtype=float64`` under ``jax.enable_x64``, the port's
networks ``.double()``); both still take their losses on fp32 logits.  In
fp32 the two differ at single elements: where a max-pool window or a ReLU
holds a near-tie, fp32 rounding sends the gradient another way (measured
on these batches: up to 7e-2 of a leaf's largest gradient, in either
package against float64, and 3e-2 between them).  In float64, after one
step: the loss (relative, or 1e-6, its fp32 logits' rounding), the
BatchNorm statistics and every parameter's change within STEP_TOL = 1e-5
of the leaf's largest.  AdamW's first change, lr * (g / (|g| + eps) + 1e-4
p), follows the gradient's last bits where |g| is near eps: it is held
within 1e-5 lr where |g| > 1e-4 (nearly every element), and not compared
elsewhere.  The optimizers' later steps (SGD's momentum, Adam's moments)
are held to optax's on the same gradients
(``test_optimizers_match_optax``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from eva_vos_tpu.annotator import FakeSAMController as JxFakeSAM
from eva_vos_tpu.models.qnet import QualityNet as JxQNet
from eva_vos_tpu.models.rl_agent import ActorCritic as JxActorCritic
from eva_vos_tpu.parallel import make_mesh
from eva_vos_tpu.train.qnet import QNetTrainer as JxQNetTrainer
from eva_vos_tpu.train.qnet import QNetTrainState as JxQNetState
from eva_vos_tpu.train import ppo as jppo
from eva_vos_tpu.train.ppo.trainer import PPOTrainState as JxPPOState
from eva_vos_tpu.utils import weight_convert as jwc
from eva_vos_tpu_torch.annotator import FakeSAMController
from eva_vos_tpu_torch.cli import generate_fq_dataset as gen_fq
from eva_vos_tpu_torch.models.sam import SAMController, SamPredictor, build_sam
from eva_vos_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
from eva_vos_tpu_torch.train import QNetTrainer
from eva_vos_tpu_torch.train import ppo
from eva_vos_tpu_torch.train.common import flax_batch_stats_, make_optimizer
from eva_vos_tpu_torch.utils import weight_convert as wc
from test_torch_port_models import _init
from test_vector_env import make_items

S = 64          # QNet / ActorCritic mask size in the parity steps
B = 4           # QNet batch
STEP_TOL = 1e-5
LOSS_ATOL = 1e-6     # both losses are taken on fp32 logits
ADAM_BIG_GRAD = 1e-4
ADAM_BIG_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_sd(sd):
    return {k: v.detach().double().numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _grads(net):
    return {k: p.grad.numpy().copy() for k, p in net.named_parameters()}


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _step_ref(convert, new, params):
    """The JAX step in the port's layout: each parameter's change from
    ``params`` (taken in float64, before the layout's fp32 copy) and the
    running statistics.  (The JAX steps donate their input state.)"""
    changes = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b, float),
                           new.params, params)
    return _np_sd(convert({"params": changes,
                           "batch_stats": new.batch_stats}))


def _assert_step(before, after_ours, ref, optim, lr, grads):
    """A step's running statistics and parameter changes, float64, against
    the JAX step's (see the module docstring)."""
    for k, want in ref.items():
        got = after_ours[k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=STEP_TOL * np.abs(want).max(),
                                       err_msg=k)
            continue
        d_got = got - before[k]
        assert np.abs(want).max() > 0, k
        if optim == "SGD":
            np.testing.assert_allclose(d_got, want, rtol=0,
                                       atol=STEP_TOL * np.abs(want).max(),
                                       err_msg=k)
            continue
        big = np.abs(grads[k]) > ADAM_BIG_GRAD
        np.testing.assert_allclose(d_got[big], want[big], rtol=0,
                                   atol=ADAM_BIG_TOL * lr, err_msg=k)


# ---------------------------------------------------------------------------
# BatchNorm's running variance
# ---------------------------------------------------------------------------

def test_flax_batch_stats_take_the_biased_variance(rng):
    bn = flax_batch_stats_(torch.nn.BatchNorm2d(3))
    x = torch.as_tensor(rng.standard_normal((4, 3, 2, 2)).astype(np.float32))
    bn.train()
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))
    bn.eval()
    before = bn.running_var.clone()
    bn(x)
    torch.testing.assert_close(bn.running_var, before)


@pytest.mark.parametrize("optim", ["SGD", "Adam"])
def test_optimizers_match_optax(optim):
    """Three steps of ``make_optimizer`` against optax's ``sgd(lr,
    momentum=0.9)`` / ``adamw(lr)`` (weight decay 1e-4) on the same float64
    gradients."""
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((5, 7))
    grads = [rng.standard_normal((5, 7)) * 10.0 ** -k for k in range(3)]
    tx = (optax.sgd(0.05, momentum=0.9) if optim == "SGD"
          else optax.adamw(0.05))
    p = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = make_optimizer([p], optim, 0.05)
    with jax.enable_x64(True):
        want, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, want)
            want = optax.apply_updates(want, upd)
            p.grad = torch.as_tensor(g)
            opt.step()
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# QNet
# ---------------------------------------------------------------------------

def _discs(rng, n, size=S):
    """n soft discs [n, size, size] of random centres and radii, with a
    tenth of uniform noise: no plateau of equal values to tie in the max
    pool."""
    yy, xx = np.mgrid[:size, :size]
    c = rng.uniform(size / 5, size * 4 / 5, (n, 2))
    r = rng.uniform(size / 10, size / 3, n)
    d = np.hypot(yy - c[:, :1, None], xx - c[:, 1:, None])
    disc = 1 / (1 + np.exp((d - r[:, None, None]) / 2))
    return (0.9 * disc + 0.1 * rng.random(disc.shape)).astype(np.float32)


def _qnet_batch(rng, n=B):
    return {"img": rng.standard_normal((n, S, S, 3)).astype(np.float32),
            "mask": _discs(rng, n),
            "label": rng.integers(0, 20, n).astype(np.int32)}


@pytest.fixture(scope="module")
def qnet_variables():
    x = jnp.zeros((1, S, S, 3))
    return _init(JxQNet(arch="resnet18"), np.random.default_rng(3), x, x)


@pytest.mark.parametrize("optim,lr", [("SGD", 0.05), ("Adam", 1e-4)])
def test_qnet_train_step_matches_jax(optim, lr, qnet_variables):
    batch = _qnet_batch(np.random.default_rng(11))
    batch64 = dict(batch, img=batch["img"].astype(np.float64),
                   mask=batch["mask"].astype(np.float64))
    sd = wc.qnet_state_dict_from_flax(qnet_variables)
    before = _np_sd(sd)

    with jax.enable_x64(True):
        jx = JxQNetTrainer(arch="resnet18", lr=lr, optim=optim,
                           mesh=make_mesh(1), dtype=jnp.float64)
        jx.net = JxQNet(arch="resnet18", dropout=0.0, dtype=jnp.float64)
        params = _f64(qnet_variables["params"])
        new = JxQNetState(params=params,
                          batch_stats=_f64(qnet_variables["batch_stats"]),
                          opt_state=jx.tx.init(params),
                          step=jnp.zeros((), jnp.int32))
        new, m_ref = jx.train_step(new, batch64, jax.random.PRNGKey(0))
        after_ref = _step_ref(wc.qnet_state_dict_from_flax, new,
                              qnet_variables["params"])
        ev_ref = jx.eval_step(new, batch64)
        masks3 = jnp.repeat(jnp.asarray(batch64["mask"])[..., None], 3, -1)
        f_ref = np.asarray(jx.extract_fn(new)(jnp.asarray(batch64["img"]),
                                              masks3))

    ours = QNetTrainer(arch="resnet18", lr=lr, optim=optim, dropout=0.0,
                       device="cpu")
    st = ours.init(state_dict=sd)
    st.net.double()
    st, m = ours.train_step(st, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=STEP_TOL, atol=LOSS_ATOL)
    assert float(m["acc"]) == float(m_ref["acc"])
    assert st.step == 1
    _assert_step(before, _np_sd(st.net.state_dict()), after_ref, optim, lr,
                  _grads(st.net))

    # eval_step and extract_fn on the stepped weights
    ev = ours.eval_step(st, batch)
    np.testing.assert_allclose(float(ev["loss"]), float(ev_ref["loss"]),
                               rtol=STEP_TOL, atol=LOSS_ATOL)
    f = ours.extract_fn(st)(torch.as_tensor(batch64["img"]),
                            torch.as_tensor(np.asarray(masks3))).numpy()
    np.testing.assert_allclose(f, f_ref, rtol=0,
                               atol=STEP_TOL * np.abs(f_ref).max())


def test_qnet_dropout_follows_its_generator():
    rng = np.random.default_rng(5)
    batch = _qnet_batch(rng)
    losses = []
    for seed in (0, 0, 1):
        tr = QNetTrainer(arch="resnet18", lr=0.0, dropout=0.5, device="cpu")
        st = tr.init(seed=7)
        st.net.drop.generator.manual_seed(seed)
        losses.append(float(tr.train_step(st, batch)[1]["loss"]))
    assert losses[0] == losses[1] != losses[2]


# ---------------------------------------------------------------------------
# PPO: storage, returns, the update
# ---------------------------------------------------------------------------

def _fill(storage, rng, lengths):
    for e, steps in enumerate(lengths):
        m = np.repeat(_discs(rng, steps, storage.masks.shape[2])[..., None],
                      3, -1)
        emb = rng.standard_normal(storage.img_embeddings.shape[1:]).astype(
            np.float32)
        storage.insert(
            e, masks=m, img_embedding=emb,
            actions=rng.integers(0, 2, steps).astype(np.int32),
            log_probs=np.log(rng.uniform(0.2, 0.8, steps)).astype(np.float32),
            values=rng.standard_normal(steps).astype(np.float32),
            rewards=rng.standard_normal(steps).astype(np.float32),
            returns=rng.standard_normal(steps).astype(np.float32),
            paddings=np.zeros(steps, bool),
            advantages=rng.standard_normal(steps).astype(np.float32))


def _storages(lengths, num_mini_batch, obs=(S, S), embed=(8, 8, 256)):
    kw = dict(num_envs=len(lengths), num_steps=max(lengths), obs_hw=obs,
              embed_shape=embed, num_mini_batch=num_mini_batch)
    ref, ours = jppo.RolloutStorage(**kw), ppo.RolloutStorage(**kw,
                                                               device="cpu")
    _fill(ref, np.random.default_rng(9), lengths)
    _fill(ours, np.random.default_rng(9), lengths)
    return ref, ours


def test_storage_minibatches_match_jax():
    ref, ours = _storages([3, 1, 2, 3, 2, 1], num_mini_batch=3,
                          obs=(8, 8), embed=(4, 4, 16))
    assert ours.mean_valid_reward() == ref.mean_valid_reward()
    got = list(ours.data_generator(np.random.default_rng(4)))
    want = list(ref.data_generator(np.random.default_rng(4)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def test_returns_and_gaes_match_jax(rng):
    r = rng.standard_normal(5).astype(np.float32)
    v = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(ppo.compute_returns(r, 0.95),
                                  jppo.compute_returns(r, 0.95))
    np.testing.assert_array_equal(ppo.calculate_gaes(r, v),
                                  jppo.calculate_gaes(r, v))
    np.testing.assert_array_equal(ppo.calculate_gaes(r, v, 0.9, 0.8),
                                  jppo.calculate_gaes(r, v, 0.9, 0.8))


@pytest.fixture(scope="module")
def ac_variables():
    return _init(JxActorCritic(out_dim=2, arch="resnet18"),
                 np.random.default_rng(4), jnp.zeros((1, 8, 8, 256)),
                 jnp.zeros((1, S, S, 3)))


@pytest.fixture(scope="module")
def jx_ppo():
    """The JAX PPO trainer in float64 (its constructor initialises a
    resnet18 at 224 px eagerly: once for the module)."""
    return jppo.PPOTrainer(action_space=2, ppo_epochs=1, clip_param=0.2,
                           value_loss_coef=0.5, entropy_coef=0.01,
                           target_kl_div=None, lr=0.0, optim_str="SGD",
                           arch="resnet18", dropout=0.0, dtype=jnp.float64)


@pytest.mark.parametrize("optim,lr", [("SGD", 0.05), ("Adam", 1e-4)])
def test_ppo_update_matches_jax(optim, lr, ac_variables, jx_ppo):
    """One update on a fixed minibatch with weight-0 padding slots:
    BatchNorm's batch statistics include them on both sides."""
    ref, ours = _storages([2, 1, 3], num_mini_batch=1)
    (w_batch,) = ref.data_generator(np.random.default_rng(0))
    (batch,) = ours.data_generator(np.random.default_rng(0))
    assert (w_batch["weights"] == 0).sum() == 3      # 6 valid of 9 slots
    sd = wc.actor_critic_state_dict_from_flax(ac_variables)
    before = _np_sd(sd)

    jx = jx_ppo
    # the constructor's choice of optimizer, for this case; the update is
    # traced again with it
    jx.tx = optax.adamw(lr) if optim == "Adam" else optax.sgd(lr, momentum=0.9)
    jx._update = jax.jit(jx._update_impl, donate_argnums=(0,))
    with jax.enable_x64(True):
        params = _f64(ac_variables["params"])
        new = JxPPOState(params, _f64(ac_variables["batch_stats"]),
                         jx.tx.init(params))
        jbatch = {k: jnp.asarray(v, jnp.float64) if v.dtype == np.float32
                  else jnp.asarray(v) for k, v in w_batch.items()}
        new, loss_ref, kl_ref = jx._update(new, jbatch, jax.random.PRNGKey(0))
        after_ref = _step_ref(wc.actor_critic_state_dict_from_flax, new,
                              ac_variables["params"])
        logits_ref, values_ref = jx._fwd(new, jbatch["embeddings"],
                                         jbatch["masks"])

    tr = ppo.PPOTrainer(action_space=2, ppo_epochs=1, clip_param=0.2,
                        value_loss_coef=0.5, entropy_coef=0.01,
                        target_kl_div=None, lr=lr, optim_str=optim,
                        arch="resnet18", dropout=0.0, device="cpu")
    tr.net.load_state_dict(sd)
    tr.net.double()
    batch64 = {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items()}
    loss, kl = tr._update(batch64)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=STEP_TOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(float(kl), float(kl_ref), rtol=STEP_TOL,
                               atol=1e-9)
    _assert_step(before, _np_sd(tr.net.state_dict()), after_ref, optim, lr,
                  _grads(tr.net))

    # act / act_batch run the running statistics: the JAX forward's values
    actions, lp, values = tr.act_batch(batch64["embeddings"],
                                       batch64["masks"])
    np.testing.assert_allclose(values, np.asarray(values_ref)[:, 0],
                               rtol=STEP_TOL, atol=STEP_TOL)
    lp_ref = jax.nn.log_softmax(np.asarray(logits_ref))[
        np.arange(len(actions)), actions]
    np.testing.assert_allclose(lp, np.asarray(lp_ref), rtol=STEP_TOL,
                               atol=STEP_TOL)


def test_kl_stop_breaks_only_the_epoch(monkeypatch):
    """Each epoch's first minibatch reaches the target: one update an epoch."""
    _, ours = _storages([2, 1, 2, 2], num_mini_batch=4, obs=(8, 8),
                        embed=(4, 4, 16))
    tr = ppo.PPOTrainer(action_space=2, ppo_epochs=3, clip_param=0.2,
                        value_loss_coef=0.5, entropy_coef=0.0,
                        target_kl_div=0.02, lr=0.0, optim_str="SGD",
                        arch="resnet18", dropout=0.0, device="cpu")
    calls = []
    monkeypatch.setattr(tr, "_update", lambda b: (
        calls.append(1) or torch.tensor(1.0), torch.tensor(0.5)))
    assert tr.optimize(ours, np.random.default_rng(0)) == 1.0
    assert len(calls) == 3
    tr.target_kl_div = None
    calls.clear()
    tr.optimize(ours, np.random.default_rng(0))
    assert len(calls) == 12


# ---------------------------------------------------------------------------
# Environments, on the fake SAM
# ---------------------------------------------------------------------------

def _assert_states_equal(ours, ref):
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.cpu().numpy(), np.asarray(r))


@pytest.mark.parametrize("actions", [[0, 0, 0], [0, 1], [0, 2], [2], [1]])
def test_env_matches_jax(actions):
    images, gts, inits = make_items(1, seed=2)
    ours = ppo.AnnotationEnv(FakeSAMController(), images[0], gts[0],
                             inits[0], max_steps=3, device="cpu")
    ref = jppo.AnnotationEnv(JxFakeSAM(), images[0], gts[0], inits[0],
                             max_steps=3)
    assert ours.init_iou == ref.init_iou
    _assert_states_equal(ours.state, ref.state)
    for a in actions:
        r, s, d = ours.step(a)
        r_ref, s_ref, d_ref = ref.step(a)
        assert (r, d) == (r_ref, d_ref)
        assert ours.iou == ref.iou
        assert ours.annotation_cost == ref.annotation_cost
        _assert_states_equal(s, s_ref)
    if actions == [2]:          # 'stop' first: zero cost, reward 0
        assert r == 0.0 and ours.annotation_cost == 0


@pytest.mark.parametrize("actions_per_step", [
    [[0, 0], [0, 0], [0, 0]],     # all clicks to max steps
    [[1, 0], [2, 0], [2, 1]],     # mask/stop mixes
    [[2, 2]],                     # stop first
])
def test_vector_env_matches_jax_and_sequential(actions_per_step):
    images, gts, inits = make_items(2)
    vec = ppo.VectorizedAnnotationEnvs(FakeSAMController(), images, gts,
                                       inits, max_steps=3, device="cpu")
    ref = jppo.VectorizedAnnotationEnvs(JxFakeSAM(), images, gts, inits,
                                        max_steps=3)
    seq = [ppo.AnnotationEnv(FakeSAMController(), images[e], gts[e],
                             inits[e], max_steps=3, device="cpu")
           for e in range(2)]
    _assert_states_equal(vec.states(), ref.states())
    seq_done = [False, False]
    for step_actions in actions_per_step:
        r, d = vec.step(np.asarray(step_actions))
        r_ref, d_ref = ref.step(np.asarray(step_actions))
        np.testing.assert_array_equal(r, r_ref)
        np.testing.assert_array_equal(d, d_ref)
        _assert_states_equal(vec.states(), ref.states())
        for e in range(2):
            if not seq_done[e]:
                sr, _, seq_done[e] = seq[e].step(step_actions[e])
                np.testing.assert_allclose(r[e], sr, rtol=1e-6, atol=1e-8)
    for e in range(2):
        assert vec.env_state[e]["cost"] == ref.env_state[e]["cost"] \
            == seq[e].annotation_cost
        assert vec.env_state[e]["iou"] == ref.env_state[e]["iou"]
        assert vec.env_state[e]["iou"] == pytest.approx(seq[e].iou)


def test_warm_start_matches_jax():
    images, gts, inits = make_items(3, seed=4)
    vec = ppo.VectorizedAnnotationEnvs(FakeSAMController(), images, gts,
                                       inits, max_steps=3, device="cpu")
    ref = jppo.VectorizedAnnotationEnvs(JxFakeSAM(), images, gts, inits,
                                        max_steps=3)
    for e in range(3):
        env = ppo.AnnotationEnv(FakeSAMController(), images[e], gts[e],
                                inits[e], max_steps=3, device="cpu")
        np.testing.assert_array_equal(vec.env_state[e]["sam_mask"],
                                      ref.env_state[e]["sam_mask"])
        np.testing.assert_array_equal(vec.env_state[e]["sam_mask"],
                                      env.sam_mask)
        assert vec.env_state[e]["init_iou"] == ref.env_state[e]["init_iou"]


class _ScriptedTrainer:
    """act_batch returns the next row of a script; act the next action."""

    def __init__(self, script):
        self.script = list(script)

    def act_batch(self, embs, masks):
        a = np.asarray(self.script.pop(0))
        return a, np.full(len(a), -0.5, np.float32), np.zeros(len(a),
                                                              np.float32)

    def act(self, emb, mask, x_cost=None, rng=None):
        return int(self.script.pop(0)), -0.5, 0.25


def test_batched_rollouts_step_dead_envs_with_stop(monkeypatch):
    images, gts, inits = make_items(2)
    seen = []
    step = ppo.VectorizedAnnotationEnvs.step
    monkeypatch.setattr(ppo.VectorizedAnnotationEnvs, "step",
                        lambda self, a: seen.append(list(a)) or step(self, a))
    storage = ppo.RolloutStorage(num_envs=2, num_steps=3, num_mini_batch=1,
                                 device="cpu")
    ppo.batched_rollouts(_ScriptedTrainer([[1, 0], [0, 0], [1, 1]]),
                         FakeSAMController(), images, gts, inits, storage,
                         num_steps=3, gamma=0.95, advantages="gae", rng=None)
    assert seen[:2] == [[1, 0], [2, 0]]
    np.testing.assert_array_equal(storage.paddings[0], [False, True, True])
    assert not storage.paddings[1].any()


def test_rollout_gae_ignores_the_config_gamma():
    images, gts, inits = make_items(1)
    storage = ppo.RolloutStorage(num_envs=1, num_steps=3, num_mini_batch=1,
                                 device="cpu")
    steps = ppo.rollout(_ScriptedTrainer([0, 0, 0]), FakeSAMController(),
                        images[0], gts[0], inits[0], 0, storage, 3, 0.5,
                        "gae", None)
    r, v = storage.rewards[0, :steps], storage.value_preds[0, :steps]
    # the storage keeps fp32 copies of the episode's float64 sums
    np.testing.assert_allclose(storage.advantages[0, :steps],
                               ppo.calculate_gaes(r, v), rtol=1e-6)  # 0.99
    np.testing.assert_allclose(storage.returns[0, :steps],
                               ppo.compute_returns(r, 0.5), rtol=1e-6)
    assert not np.array_equal(ppo.calculate_gaes(r, v),
                              ppo.calculate_gaes(r, v, gamma=0.5))


def test_batched_rollouts_and_optimize_on_the_fake_sam():
    images, gts, inits = make_items(4, seed=7)
    tr = ppo.PPOTrainer(action_space=2, ppo_epochs=2, clip_param=0.2,
                        value_loss_coef=0.5, entropy_coef=1e-4,
                        target_kl_div=None, lr=1e-4, optim_str="Adam",
                        arch="resnet18", dropout=0.5, device="cpu")
    storage = ppo.RolloutStorage(num_envs=4, num_steps=3, num_mini_batch=2,
                                 device="cpu")
    rng = np.random.default_rng(0)
    ppo.batched_rollouts(tr, FakeSAMController(), images, gts, inits, storage,
                         num_steps=3, gamma=0.95, advantages="gae", rng=rng)
    assert (~storage.paddings).any(axis=1).all()
    assert np.isfinite(tr.optimize(storage, rng))


# ---------------------------------------------------------------------------
# The FQ generator's consistency filter; SAM's chunked encode
# ---------------------------------------------------------------------------

def test_fq_generator_keeps_consistent_states(monkeypatch, tmp_path):
    from eva_vos_tpu_torch.data.datasets import make_synthetic_sample

    sample = make_synthetic_sample(t=3, h=16, w=16)
    gen = np.zeros((3, 16, 16), np.float32)
    # round 1 records frame 1, the argmin; round 2 records frame 0, not it
    out = ([gen, gen], [1, 0], [[1.0, 0.2, 0.5], [1.0, 0.9, 0.4]], [80, 80])
    monkeypatch.setattr(gen_fq, "oracle_mask_dataset", lambda *a: out)

    class _Engine:
        device = torch.device("cpu")

    rows = gen_fq.generate_sample(2, _Engine(), sample, "j", tmp_path)
    assert [r["state_name"] for r in rows] == ["synthetic_0__1_round_1"]
    assert not (tmp_path / "Annotations" / "224"
                / "synthetic_0__1_round_2").exists()


def test_fleet_goes_size_by_size_on_sam():
    """Frames of two sizes (a MOSE batch's widths differ): the fleet encodes
    and decodes them size by size on the predictor, and each env equals
    the sequential env, warm start and steps."""
    pred = SamPredictor(build_sam("tiny", seed=0, device="cpu"))
    rng = np.random.default_rng(3)
    images, gts, inits = [], [], []
    for h, w in ((40, 56), (48, 40), (40, 56)):
        images.append((rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
                       - IMAGENET_MEAN) / IMAGENET_STD)
        gt = np.zeros((h, w), np.float32)
        gt[8:30, 10:34] = 1
        gts.append(gt)
        inits.append(np.roll(gt, 3, axis=1))
    vec = ppo.VectorizedAnnotationEnvs(SAMController(pred), images, gts,
                                       inits, max_steps=2, device="cpu")
    rewards = [vec.step(np.zeros(3, int))[0] for _ in range(2)]
    for e in range(3):
        env = ppo.AnnotationEnv(SAMController(pred), images[e], gts[e],
                                inits[e], max_steps=2, device="cpu")
        torch.testing.assert_close(vec.batch.embeddings[e],
                                   env.img_embedding, rtol=0, atol=0)
        assert env.init_iou == vec.env_state[e]["init_iou"]
        for r in rewards:
            assert np.float32(env.step(0)[0]) == r[e]
        np.testing.assert_array_equal(env.sam_mask,
                                      vec.env_state[e]["sam_mask"])


def test_chunked_encode_equals_one_pass():
    pred = SamPredictor(build_sam("tiny", seed=0, device="cpu"))
    rng = np.random.default_rng(1)
    imgs = [(rng.uniform(0, 1, (40, 56, 3)) * 255).astype(np.uint8)
            for _ in range(3)]
    one_pass = pred.encode_images(imgs, chunk=3)
    for chunk in (1, 2):
        torch.testing.assert_close(pred.encode_images(imgs, chunk=chunk),
                                   one_pass, rtol=1e-6, atol=1e-6)
    pred.set_image(imgs[1])
    torch.testing.assert_close(pred.encode_images(imgs)[1], pred.features,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The training CLIs end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """An FQ tree and an AnnotDB tree (with its MOSE gt) from the port's
    generators, tiny, on the CPU."""
    from eva_vos_tpu_torch.cli import generate_annotation_dataset as gen_an
    from eva_vos_tpu_torch.data._png import write_png
    from eva_vos_tpu_torch.data.datasets import make_synthetic_sample

    root = tmp_path_factory.mktemp("data")
    mp = pytest.MonkeyPatch()
    mp.setenv("EVAVOS_TINY", "1")
    try:
        gen_fq.main(["--synthetic", "1", "--rounds", "2", "--imset", "train",
                     "--allow-random", "--out", str(root / "FQ_DB"),
                     "--device", "cpu"])
        (root / "FQ_DB" / "res_val.csv").write_bytes(
            (root / "FQ_DB" / "res_train.csv").read_bytes())
        gen_an.main(["--synthetic", "1", "--rounds", "3", "--imset", "train",
                     "--sam", "fake", "--allow-random", "--out",
                     str(root / "AnnotDB"), "--device", "cpu"])
    finally:
        mp.undo()
    sample = make_synthetic_sample(t=6, h=64, w=96, seed=0)
    ann = root / "MOSE" / "Annotations" / "480p" / "synthetic_0"
    ann.mkdir(parents=True)
    for f in range(sample.gt.shape[1]):
        write_png(ann / f"{f:05d}.png", sample.gt[0, f],
                  palette=[[0, 0, 0], [255, 0, 0]])
    return root


def test_train_qnet_cli_checkpoint_loads_in_both_zoos(data_root, tmp_path,
                                                      monkeypatch):
    from eva_vos_tpu_torch.cli import train_qnet
    from eva_vos_tpu_torch.models import QualityNet
    from eva_vos_tpu_torch.utils.model_zoo import load_qnet

    monkeypatch.setenv("EVAVOS_DATA_ROOT", str(data_root))
    monkeypatch.chdir(tmp_path)
    state = train_qnet.main(["--epochs", "1", "--batch-size", "8",
                             "--train-set", "train", "--lr", "1e-3",
                             "--out", "out", "--device", "cpu"])
    ckpt = tmp_path / "out" / "qnet_ckpt"
    assert state.step >= 1 and ckpt.exists()
    assert list((tmp_path / "logs").glob("qnet_*.csv"))

    sd = jwc.load_torch_state_dict(ckpt)
    x = jnp.zeros((1, S, S, 3))
    template = JxQNet(arch="resnet18").init(jax.random.PRNGKey(0), x, x)
    variables = jwc.convert_qnet(sd, arch="resnet18", template=template)
    for coll in ("params", "batch_stats"):
        assert not jwc.check_tree_matches(template, variables, coll)

    (tmp_path / "w" / "qnet").mkdir(parents=True)
    (tmp_path / "w" / "qnet" / "qnet.pth").write_bytes(ckpt.read_bytes())
    net, _ = load_qnet(weights_root=tmp_path / "w", device="cpu")
    assert isinstance(net, QualityNet)
    xs = torch.as_tensor(np.random.default_rng(0).random(
        (2, S, S, 3)).astype(np.float32))
    state.net.eval()
    with torch.no_grad():
        torch.testing.assert_close(net(xs, xs), state.net(xs, xs),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("extra", [[], ["--sequential"]])
def test_train_rl_agent_cli_checkpoints(extra, data_root, tmp_path,
                                        monkeypatch):
    from eva_vos_tpu_torch.cli import train_rl_agent
    from eva_vos_tpu_torch.utils.checkpoint import restore_checkpoint

    monkeypatch.setenv("EVAVOS_DATA_ROOT", str(data_root))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rl"
    train_rl_agent.main(["--rollouts", "4", "--num-envs", "2", "--num-steps",
                         "2", "--mini-batch", "1", "--ppo-epochs", "1",
                         "--sam", "fake", "--imset", "train", "--no-sample",
                         "--out", str(out), "--device", "cpu"] + extra)
    assert (out / "model").exists()
    _, meta = restore_checkpoint(out / "_checkpoint")
    assert meta["iters"] >= 4 and np.isfinite(meta["max_reward"])

    template = JxActorCritic(out_dim=2, arch="resnet18").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 256)),
        jnp.zeros((1, S, S, 3)))
    for name in ("model", "_checkpoint"):
        variables = jwc.convert_actor_critic(
            jwc.load_torch_state_dict(out / name), arch="resnet18",
            template=template)
        for coll in ("params", "batch_stats"):
            assert not jwc.check_tree_matches(template, variables, coll)

    # --resume takes the iteration count and the weights back
    train_rl_agent.main(["--rollouts", "6", "--num-envs", "2", "--num-steps",
                         "2", "--mini-batch", "1", "--ppo-epochs", "1",
                         "--sam", "fake", "--imset", "train", "--no-sample",
                         "--out", str(out), "--device", "cpu", "--resume"]
                        + extra)
    assert restore_checkpoint(out / "_checkpoint")[1]["iters"] == 6
