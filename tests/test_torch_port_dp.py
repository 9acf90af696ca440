"""The port's data-parallel trainers (``QNetTrainer(mesh=)``,
``PPOTrainer(mesh=)``) and global-batch BatchNorm against the JAX
trainers on a 2-device mesh and against the port's one-process step on the
global batch, on the CPU.

The port's steps run in 2 gloo processes (``torch_port_workers``: one
torch thread each, 120 s each, started once for the module), each on its
rows of the global batch, or on its own rollouts; the JAX steps run in
this process on ``make_mesh(2)`` of ``conftest.py``'s virtual devices.  Both sides step in float64, as ``test_torch_port_train`` steps
them (the losses on fp32 logits, as in JAX).  Against the JAX steps dropout
is 0 on both sides (the JAX trainer's ``net`` is replaced before its first,
tracing, step); against the port's one-process step it is on, drawn from
the same generator.

Tolerances.  The port's data-parallel step against its one-process step:
each parameter's change, gradient and running statistic within STEP_TOL =
1e-7 of the leaf's largest change (gradient, magnitude); the losses within
LOSS_TOL = 1e-6 (relative), since both are taken on fp32 logits.  Against
the JAX mesh step the parameters are held to JAX_STEP_TOL = 1e-5, the
tolerance of ``test_torch_port_train``'s one-device steps: the gradient
of the loss leaves the fp32 logits one fp32 rounding apart in the two
packages, which moves a leaf's change by up to ~5e-7 of its largest
(measured here), whatever the float64 around it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.models.qnet import QualityNet as JxQNet
from eva_vos_tpu.models.rl_agent import ActorCritic as JxActorCritic
from eva_vos_tpu.parallel import make_mesh as jx_make_mesh
from eva_vos_tpu.train import ppo as jppo
from eva_vos_tpu.train.ppo.trainer import PPOTrainState as JxPPOState
from eva_vos_tpu.train.qnet import QNetTrainer as JxQNetTrainer
from eva_vos_tpu.train.qnet import QNetTrainState as JxQNetState
from eva_vos_tpu_torch.parallel import dryrun_multichip
from eva_vos_tpu_torch.parallel.dryrun import ppo_batch
from eva_vos_tpu_torch.train import QNetTrainer
from eva_vos_tpu_torch.train import ppo
from eva_vos_tpu_torch.train.common import flax_batch_stats_
from eva_vos_tpu_torch.utils import weight_convert as wc
from test_torch_port_models import _init
from test_torch_port_train import _step_ref
from torch_port_workers import ppo_trainer, qnet_batch, rollout_storage, run

STEP_TOL = 1e-7
JAX_STEP_TOL = 1e-5
LOSS_TOL = 1e-6
S = 64            # QNet / ActorCritic mask size
ROWS = 8          # the global batch: 4 rows a rank
LR = 0.05
# optimize over each rank's own rollouts (rollout_seed + rank)
PPO_OPTIMIZE = dict(lr=LR, optim="SGD", dropout=0.5, seed=2, epochs=2,
                    size=S, rollout_seed=20, rng_seed=7)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qnet_variables():
    x = jnp.zeros((1, S, S, 3))
    return _init(JxQNet(arch="resnet18"), np.random.default_rng(3), x, x)


@pytest.fixture(scope="module")
def ac_variables():
    return _init(JxActorCritic(out_dim=2, arch="resnet18"),
                 np.random.default_rng(4), jnp.zeros((1, 8, 8, 256)),
                 jnp.zeros((1, S, S, 3)))


def _bn_input():
    rng = np.random.default_rng(6)
    # a large mean: the statistics must not cancel
    return torch.as_tensor(rng.standard_normal((ROWS, 3, 5, 4)) * 0.5 + 4.0)


@pytest.fixture(scope="module")
def ranks(qnet_variables, ac_variables, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    torch.save(wc.qnet_state_dict_from_flax(qnet_variables), tmp / "qnet.pt")
    torch.save(wc.actor_critic_state_dict_from_flax(ac_variables),
               tmp / "ac.pt")
    batch = {k: torch.as_tensor(v) for k, v in ppo_batch(ROWS, 8, S).items()}
    torch.save({k: v.double() if v.is_floating_point() else v
                for k, v in batch.items()}, tmp / "ppo_batch.pt")
    torch.save(_bn_input(), tmp / "bn_x.pt")
    common = dict(rows=ROWS, size=S, batch_seed=11, lr=LR, optim="SGD")
    jobs = [
        dict(common, name="qnet_jax", kind="qnet", dropout=0.0, seed=0,
             weights=str(tmp / "qnet.pt")),
        dict(common, name="qnet_dropout", kind="qnet", dropout=0.5, seed=3,
             grads=True),
        dict(common, name="qnet_adam", kind="qnet", dropout=0.5, seed=3,
             optim="Adam", lr=1e-4, grads=True),
        dict(name="ppo_jax", kind="ppo", lr=LR, optim="SGD", dropout=0.0,
             seed=0, weights=str(tmp / "ac.pt"),
             batch=str(tmp / "ppo_batch.pt")),
        dict(name="ppo_dropout", kind="ppo", lr=LR, optim="SGD", dropout=0.5,
             seed=2, batch=str(tmp / "ppo_batch.pt")),
        dict(PPO_OPTIMIZE, name="ppo_optimize", kind="ppo_optimize"),
        dict(name="ppo_uneven", kind="ppo_uneven"),
        dict(name="batch_norm", kind="batch_norm", x=str(tmp / "bn_x.pt")),
    ]
    return run(jobs, 2, tmp)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _assert_states(got, want, before, tol=STEP_TOL, steps=1):
    """Each parameter's change within ``tol`` of the leaf's largest change,
    each running statistic within ``tol`` of its largest magnitude (the
    step counts of the torch layout equal to ``steps``, where ``want`` has
    them)."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w) == steps, k
            continue
        g = got[k].double().numpy()
        w = w.double().numpy() if torch.is_tensor(w) else w
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(), err_msg=k)
            continue
        change = w - before[k]
        assert np.abs(change).max() > 0, k
        np.testing.assert_allclose(g - before[k], change, rtol=0,
                                   atol=tol * np.abs(change).max(), err_msg=k)


def _assert_jax_step(got, ref, before):
    """The port's stepped state against ``_step_ref``'s JAX step (each
    parameter's change, the running statistics) within JAX_STEP_TOL."""
    for k, want in ref.items():
        g = got[k].double().numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, want, rtol=0, err_msg=k,
                                       atol=JAX_STEP_TOL * np.abs(want).max())
            continue
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(g - before[k], want, rtol=0, err_msg=k,
                                   atol=JAX_STEP_TOL * np.abs(want).max())


def _before(sd):
    return {k: v.detach().double().numpy().copy() for k, v in sd.items()
            if v.is_floating_point()}


def _assert_ranks_equal(outs):
    assert set(outs[0]["digest"]) == set(outs[0]["state"])
    for k, v in outs[0]["digest"].items():
        assert outs[1]["digest"][k] == v, k


# ---------------------------------------------------------------------------
# QNet
# ---------------------------------------------------------------------------

def test_qnet_dp_step_matches_jax_mesh_step(ranks, qnet_variables):
    outs = [r["qnet_jax"] for r in ranks]
    _assert_ranks_equal(outs)
    batch = qnet_batch(11, ROWS, S)
    batch64 = dict(batch, img=batch["img"].astype(np.float64),
                   mask=batch["mask"].astype(np.float64))
    sd = wc.qnet_state_dict_from_flax(qnet_variables)
    with jax.enable_x64(True):
        jx = JxQNetTrainer(arch="resnet18", lr=LR, optim="SGD",
                           mesh=jx_make_mesh(2), dtype=jnp.float64)
        jx.net = JxQNet(arch="resnet18", dropout=0.0, dtype=jnp.float64)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              qnet_variables["params"])
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             qnet_variables["batch_stats"])
        new, m_ref = jx.train_step(
            JxQNetState(params=params, batch_stats=stats,
                        opt_state=jx.tx.init(params),
                        step=jnp.zeros((), jnp.int32)),
            batch64, jax.random.PRNGKey(0))
        ev_ref = jx.eval_step(new, batch64)
        ref = _step_ref(wc.qnet_state_dict_from_flax, new,
                        qnet_variables["params"])
    _assert_jax_step(outs[0]["state"], ref, _before(sd))
    assert _rel(outs[0]["loss"], m_ref["loss"]) <= LOSS_TOL
    assert float(outs[0]["acc"]) == float(m_ref["acc"])
    assert _rel(outs[0]["eval_loss"], ev_ref["loss"]) <= LOSS_TOL
    assert float(outs[0]["eval_acc"]) == float(ev_ref["acc"])


@pytest.mark.parametrize("job", ["qnet_dropout", "qnet_adam"])
def test_qnet_dp_step_is_the_one_process_step(ranks, job):
    outs = [r[job] for r in ranks]
    _assert_ranks_equal(outs)
    adam = job == "qnet_adam"
    tr = QNetTrainer(arch="resnet18", lr=1e-4 if adam else LR,
                     optim="Adam" if adam else "SGD", dropout=0.5,
                     device="cpu")
    st = tr.init(seed=3)
    st.net.double()
    before = _before(st.net.state_dict())
    batch = qnet_batch(11, ROWS, S)
    st, m = tr.train_step(st, batch)
    ev = tr.eval_step(st, batch)
    _assert_states(outs[0]["state"], st.net.state_dict(), before)
    # the gradients, summed across the ranks, are the one-process ones
    for k, p in st.net.named_parameters():
        np.testing.assert_allclose(
            outs[0]["grads"][k].numpy(), p.grad.numpy(), rtol=0,
            atol=STEP_TOL * np.abs(p.grad.numpy()).max(), err_msg=k)
    assert _rel(outs[0]["loss"], m["loss"]) <= LOSS_TOL
    assert float(outs[0]["acc"]) == float(m["acc"])
    assert _rel(outs[0]["eval_loss"], ev["loss"]) <= LOSS_TOL


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def test_ppo_dp_update_matches_jax_mesh_update(ranks, ac_variables):
    outs = [r["ppo_jax"] for r in ranks]
    _assert_ranks_equal(outs)
    sd = wc.actor_critic_state_dict_from_flax(ac_variables)
    with jax.enable_x64(True):
        jx = jppo.PPOTrainer(action_space=2, ppo_epochs=1, clip_param=0.2,
                             value_loss_coef=0.5, entropy_coef=0.01,
                             target_kl_div=None, lr=LR, optim_str="SGD",
                             arch="resnet18", dropout=0.0, dtype=jnp.float64,
                             mesh=jx_make_mesh(2))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              ac_variables["params"])
        stats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             ac_variables["batch_stats"])
        jbatch = {k: jnp.asarray(v, jnp.float64) if v.dtype == np.float32
                  else jnp.asarray(v, jnp.int32)
                  for k, v in ppo_batch(ROWS, 8, S).items()}
        new, loss_ref, kl_ref = jx._update(
            JxPPOState(params, stats, jx.tx.init(params)), jbatch,
            jax.random.PRNGKey(0))
        ref = _step_ref(wc.actor_critic_state_dict_from_flax, new,
                        ac_variables["params"])
    _assert_jax_step(outs[0]["state"], ref, _before(sd))
    assert _rel(outs[0]["loss"], loss_ref) <= LOSS_TOL
    assert abs(float(outs[0]["kl"]) - float(kl_ref)) <= LOSS_TOL * max(
        abs(float(kl_ref)), 1e-3)


def test_ppo_dp_update_is_the_one_process_update(ranks):
    outs = [r["ppo_dropout"] for r in ranks]
    _assert_ranks_equal(outs)
    tr = ppo.PPOTrainer(action_space=2, ppo_epochs=1, clip_param=0.2,
                        value_loss_coef=0.5, entropy_coef=0.01,
                        target_kl_div=None, lr=LR, optim_str="SGD",
                        arch="resnet18", dropout=0.5, seed=2, device="cpu")
    tr.net.double()
    before = _before(tr.net.state_dict())
    batch = {k: torch.as_tensor(v) for k, v in ppo_batch(ROWS, 8, S).items()}
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    loss, kl = tr._update(batch)
    _assert_states(outs[0]["state"], tr.net.state_dict(), before)
    assert _rel(outs[0]["loss"], loss) <= LOSS_TOL
    assert _rel(outs[0]["kl"], kl) <= LOSS_TOL


def test_ppo_dp_optimize_over_per_rank_rollouts(ranks):
    """Each rank's ``optimize`` over its own rollouts (other episodes, other
    padding) is the one-process update, minibatch by minibatch, on the
    ranks' minibatches concatenated in rank order."""
    outs = [r["ppo_optimize"] for r in ranks]
    _assert_ranks_equal(outs)
    tr = ppo_trainer(PPO_OPTIMIZE, device="cpu")
    before = _before(tr.net.state_dict())
    stores = [rollout_storage(PPO_OPTIMIZE["rollout_seed"] + r, S)
              for r in range(2)]
    rngs = [np.random.default_rng(PPO_OPTIMIZE["rng_seed"]) for _ in stores]
    losses = []
    for _ in range(PPO_OPTIMIZE["epochs"]):
        for parts in zip(*(st.data_generator(g)
                           for st, g in zip(stores, rngs))):
            loss, _ = tr._update({k: torch.cat([p[k] for p in parts])
                                  for k in parts[0]})
            losses.append(float(loss))
    assert len(losses) == 4
    _assert_states(outs[0]["state"], tr.net.state_dict(), before, steps=4)
    assert _rel(outs[0]["loss"], np.mean(losses)) <= LOSS_TOL


def test_ppo_dp_update_raises_on_unequal_shares(ranks):
    """Shares of 3 and 5 rows raise on both ranks, before any forward."""
    for r in ranks:
        assert "the ranks hold [3, 5] rows" in r["ppo_uneven"]


# ---------------------------------------------------------------------------
# global-batch BatchNorm, and the dry run
# ---------------------------------------------------------------------------

def test_global_batch_norm_is_the_one_process_batch_norm(ranks):
    """Two training steps of a BatchNorm2d on each rank's rows against
    ``flax_batch_stats_``'s one-process BatchNorm2d on the whole batch:
    outputs, input and parameter gradients, running statistics."""
    outs = [r["batch_norm"] for r in ranks]
    x = _bn_input()
    per = ROWS // 2
    bn = flax_batch_stats_(torch.nn.BatchNorm2d(x.shape[1]).double())
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    bn.train()
    for step in range(2):
        xs = x.clone().requires_grad_()
        y = bn(xs + step)
        w = torch.cat([torch.linspace(-1, 2, y[:per].numel(), dtype=y.dtype)
                       .view_as(y[:per])] * 2)
        (y * w).sum().backward()
        for rank, out in enumerate(outs):
            rows = slice(rank * per, (rank + 1) * per)
            got = out["steps"][step]
            torch.testing.assert_close(got["y"], y[rows].detach(), rtol=0,
                                       atol=STEP_TOL)
            torch.testing.assert_close(got["x_grad"], xs.grad[rows], rtol=0,
                                       atol=STEP_TOL * xs.grad.abs().max())
    for name in ("running_mean", "running_var"):
        want = getattr(bn, name)
        for out in outs:
            torch.testing.assert_close(out[name], want, rtol=STEP_TOL, atol=0)
    for name in ("weight_grad", "bias_grad"):
        want = getattr(bn, name.split("_")[0]).grad
        torch.testing.assert_close(outs[0][name] + outs[1][name], want,
                                   rtol=STEP_TOL, atol=0)


def test_dryrun_multichip_on_the_cpu(capsys):
    out = dryrun_multichip(2, device="cpu")
    # the two-process multi-host rehearsal ran first, on the CPU over gloo
    said = capsys.readouterr().out
    assert 0 <= said.find("dryrun_multihost(2, 'cpu'): ") < said.find(
        "dryrun_multichip(2, 'gloo', 'cpu'): ")
    assert out["multihost"]["backend"] == "gloo"
    assert len(out["multihost"]["lines"]) == 2
    assert out["rank"] == 0
    assert out["qnet"]["param_err"] <= STEP_TOL
    assert out["ppo"]["param_err"] <= STEP_TOL
    assert out["readout"]["bytes"]["total_bytes"] <= 4 * out["readout"][
        "model_bytes"]
    # the episode's bank is sharded: half the slots here
    assert 2 * out["episode"]["bank_slots"] == out["episode"][
        "bank_slots_single"]


# ---------------------------------------------------------------------------
# train_qnet launched as a group
# ---------------------------------------------------------------------------

def _fq_tree(root, frames=8, size=48):
    """A tiny FQ_DB tree: one video, one state, ``frames`` frames; the val
    split lists them four times and the first once more (33 rows: a batch
    of 32, then one of a single row)."""
    from eva_vos_tpu_torch.data._png import write_png
    from eva_vos_tpu_torch.data.datasets import write_csv_rows

    rng = np.random.default_rng(12)
    img_dir = root / "FQ_DB" / "RGBFrames" / "224" / "v"
    mask_dir = root / "FQ_DB" / "Annotations" / "224" / "v__s0"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    for f in range(frames):
        write_png(img_dir / f"{f:05d}.png",
                  rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
        write_png(mask_dir / f"{f:05d}.png",
                  (rng.random((size, size)) > 0.5).astype(np.uint8),
                  palette=[[0, 0, 0], [255, 255, 255]])
    ious = [round(float(x), 3) for x in rng.uniform(0.05, 0.95, frames)]
    write_csv_rows(root / "FQ_DB" / "res_train.csv",
                   [{"state_name": "v__s0", "ious": str(ious)}])
    write_csv_rows(root / "FQ_DB" / "res_val.csv",
                   [{"state_name": "v__s0", "ious": str(ious)}] * 4
                   + [{"state_name": "v__s0", "ious": str(ious[:1])}])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_qnet_cli_as_a_group(tmp_path, monkeypatch):
    """Two processes of ``train_qnet`` over gloo: rank 0 alone writes the
    logs and the checkpoint, and they are a one-process run's on the same
    batches (each process loading only its rows; the last val batch's
    single row goes to rank 0, an empty share to rank 1).  The CLI trains in fp32, where a data-parallel step moves
    single elements at max-pool and ReLU near-ties (one step at 96 px:
    up to 0.18 of a leaf's largest change; float64: 2e-12): the logged
    metrics within 1e-4, the running statistics within 1e-3 of their
    largest magnitude, and each parameter's change within 0.1 of its L2
    norm (measured: 0.03)."""
    import csv

    from eva_vos_tpu_torch.cli import train_qnet
    from eva_vos_tpu_torch.parallel.dryrun import spawn

    _fq_tree(tmp_path)
    args = ["--epochs", "1", "--batch-size", "4", "--train-set", "train",
            "--lr", "1e-3", "--out", "out", "--device", "cpu"]
    for r in range(2):
        (tmp_path / f"rank{r}").mkdir()
    code = ("import os, sys; rank, n = sys.argv[-2:]; "
            "os.environ.update(EVAVOS_PROCESS_ID=rank, "
            "EVAVOS_NUM_PROCESSES=n); os.chdir(sys.argv[1] + '/rank' + rank)"
            "; import torch; torch.set_num_threads(1); "
            "from eva_vos_tpu_torch.cli import train_qnet; "
            f"train_qnet.main({args!r})")
    monkeypatch.setenv("EVAVOS_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("EVAVOS_COORDINATOR", f"localhost:{_free_port()}")
    spawn(2, ["-c", code, tmp_path], 120)
    assert (tmp_path / "rank0" / "out" / "qnet_ckpt").exists()
    assert list((tmp_path / "rank0" / "logs").glob("qnet_*.csv"))
    assert not (tmp_path / "rank1" / "out").exists()
    assert not (tmp_path / "rank1" / "logs").exists()

    monkeypatch.delenv("EVAVOS_COORDINATOR")
    monkeypatch.setenv("EVAVOS_NUM_PROCESSES", "1")
    (tmp_path / "one").mkdir()
    monkeypatch.chdir(tmp_path / "one")
    train_qnet.main(args)
    group = torch.load(tmp_path / "rank0" / "out" / "qnet_ckpt")
    one = torch.load(tmp_path / "one" / "out" / "qnet_ckpt")
    init = QNetTrainer(arch="resnet18", device="cpu").init(seed=0)
    init = init.net.state_dict()
    for k, v in one.items():
        if not v.is_floating_point():
            assert torch.equal(group[k], v), k
        elif "running" in k:
            torch.testing.assert_close(group[k], v, rtol=0, msg=k,
                                       atol=1e-3 * v.abs().max().item())
        else:
            change = v - init[k]
            assert (group[k] - v).norm() <= 0.1 * change.norm(), k

    def logged(d):
        (path,) = (d / "logs").glob("qnet_*.csv")
        with open(path, newline="") as fh:
            return [{k: float(v) for k, v in row.items()}
                    for row in csv.DictReader(fh)]

    for g, o in zip(logged(tmp_path / "rank0"), logged(tmp_path / "one")):
        for k in o:
            assert abs(g[k] - o[k]) <= 1e-4 * max(abs(o[k]), 1.0), k
