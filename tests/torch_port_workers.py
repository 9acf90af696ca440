"""Worker processes of the port's multi-process tests (imports the port,
never JAX).

``run(jobs, n, tmp)`` writes the job list, starts ``n`` processes on one
gloo group (a ``file://`` store in ``tmp``; one torch thread each, 120 s
each) and returns each rank's outputs.  Each rank runs every job in order
on its mesh and saves ``{job name: output}`` with ``torch.save``.  The
input generators are shared with the tests, which compute the references.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

TIMEOUT_S = 120


# ---------------------------------------------------------------------------
# inputs, shared with the tests
# ---------------------------------------------------------------------------

def readout_inputs(case: dict):
    """(mk [M, CK], qk [N, CK], mv [K, M, CV]) float32 of a readout case.
    ``int_keys``: small-integer keys, whose scores are exact, so that ties
    are exact too; ``dup``: the bank's second half repeats the first half's
    keys (with other values), so that every tie crosses the shards."""
    rng = np.random.default_rng(case["seed"])
    m, n, ck, cv = case["m"], case["n"], case["ck"], case["cv"]
    if case.get("int_keys"):
        mk = rng.integers(-2, 3, (m, ck)).astype(np.float32)
        qk = rng.integers(-2, 3, (n, ck)).astype(np.float32)
    else:
        mk = rng.standard_normal((m, ck)).astype(np.float32)
        qk = rng.standard_normal((n, ck)).astype(np.float32)
    if case.get("dup"):
        mk[m // 2:] = mk[:m // 2]
    mv = rng.standard_normal((case["k_obj"], m, cv)).astype(np.float32)
    return mk, qk, mv


def rollout_storage(seed: int, size: int, envs: int = 4, steps: int = 2,
                    minibatches: int = 2):
    """A float64 ``RolloutStorage`` of random episodes on the CPU, each of
    1 to ``steps`` valid steps (the rest padding)."""
    from eva_vos_tpu_torch.train.ppo.storage import RolloutStorage

    rng = np.random.default_rng(seed)
    st = RolloutStorage(envs, steps, obs_hw=(size, size),
                        embed_shape=(8, 8, 256), num_mini_batch=minibatches,
                        device="cpu")
    st.masks, st.img_embeddings = st.masks.double(), st.img_embeddings.double()
    for e in range(envs):
        n = int(rng.integers(1, steps + 1))
        st.insert(e, rng.uniform(size=(n, size, size, 3)),
                  rng.standard_normal((8, 8, 256)), rng.integers(0, 2, n),
                  -np.abs(rng.standard_normal(n)), rng.standard_normal(n),
                  rng.standard_normal(n), rng.standard_normal(n),
                  np.zeros(n, bool), rng.standard_normal(n))
    return st


def qnet_batch(seed: int, rows: int, size: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal((rows, size, size, 3)).astype(np.float32),
            "mask": rng.uniform(size=(rows, size, size)).astype(np.float32),
            "label": rng.integers(0, 20, rows).astype(np.int32)}


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def _readout(mesh, job):
    from eva_vos_tpu_torch.parallel import sharded_memory_readout

    mk, qk, mv = readout_inputs(job)
    per = job["m"] // mesh.size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    return sharded_memory_readout(
        torch.from_numpy(mk[lo:hi]), torch.from_numpy(qk),
        torch.from_numpy(np.ascontiguousarray(mv[:, lo:hi])), job["top_k"],
        mesh, valid_tokens=job.get("valid"))


def _bytes(mesh, job):
    from eva_vos_tpu_torch.parallel import (collective_bytes,
                                            sharded_memory_readout)

    out = {}
    for per in job["m_per_rank"]:
        mk = torch.zeros((per, job["ck"]))
        qk = torch.zeros((job["n"], job["ck"]))
        mv = torch.zeros((1, per, job["cv"]))
        out[per] = collective_bytes(sharded_memory_readout, mesh, mk, qk, mv,
                                    job["top_k"], mesh)
    return out


def _episode(mesh, job):
    from eva_vos_tpu_torch.data import synthetic_video
    from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine,
                                          pad_mask, prepare_video)
    from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork

    weights = torch.load(job["weights"])
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    stcn.load_state_dict(weights["stcn"])
    fusion = FusionNet()
    fusion.load_state_dict(weights["fusion"])
    cfg = EngineConfig(mem_freq=job["mem_freq"], top_k=job["top_k"],
                       max_interactions=job["max_interactions"],
                       feature_chunk=2, readout_strategy="sharded")
    engine = InferenceEngine(stcn, fusion, cfg, mesh=mesh)
    t = job["t"]
    images, gt = synthetic_video(t, job["h"], job["w"], num_objects=1,
                                 seed=job["seed"])
    padded, pad = prepare_video(images, device="cpu")
    feats = engine.precompute_features(padded)
    state = engine.init_state(feats, 1)
    probs = []
    for idx in job["rounds"]:
        state = engine.interact(state, feats, pad_mask(
            gt[:, idx].astype(np.float32), pad, device="cpu"), idx)
        probs.append(state.prob.clone())
    return {"probs": probs, "bank_k": state.bank_k, "bank_v": state.bank_v}


def _shard(mesh, job):
    from eva_vos_tpu_torch.parallel import shard_batch

    rows = job["rows"]
    batch = {"x": np.arange(rows * 3).reshape(rows, 3),
             "y": torch.arange(rows)}
    return shard_batch(batch, mesh)


def _train_state(mesh, net, grads: bool = False) -> dict:
    """A stepped network: every rank's digest of its state (the ranks must
    hold the same bytes); rank 0's state too, and with ``grads`` its
    gradients (one copy is enough to compare, and a float64 state is
    ~180 MB)."""
    import hashlib

    sd = net.state_dict()
    out = {"digest": {k: hashlib.sha256(v.detach().cpu().numpy().tobytes())
                      .hexdigest() for k, v in sd.items()}}
    if mesh.rank == 0:
        out["state"] = {k: v.detach().clone() for k, v in sd.items()}
        if grads:
            out["grads"] = {k: p.grad.clone()
                            for k, p in net.named_parameters()}
    return out


def _qnet(mesh, job):
    """A step and an evaluation on this rank's rows of the global batch."""
    from eva_vos_tpu_torch.parallel import shard_batch
    from eva_vos_tpu_torch.train import QNetTrainer

    tr = QNetTrainer(arch="resnet18", lr=job["lr"], optim=job["optim"],
                     dropout=job["dropout"], mesh=mesh)
    st = tr.init(seed=job["seed"], state_dict=(
        torch.load(job["weights"]) if job.get("weights") else None))
    st.net.double()
    batch = shard_batch(qnet_batch(job["batch_seed"], job["rows"],
                                   job["size"]), mesh)
    st, metrics = tr.train_step(st, batch)
    ev = tr.eval_step(st, batch)
    return {**_train_state(mesh, st.net, job.get("grads", False)),
            "loss": metrics["loss"], "acc": metrics["acc"],
            "eval_loss": ev["loss"], "eval_acc": ev["acc"]}


def ppo_trainer(job, mesh=None, device=None):
    from eva_vos_tpu_torch.train.ppo import PPOTrainer

    tr = PPOTrainer(action_space=2, ppo_epochs=job.get("epochs", 1),
                    clip_param=0.2, value_loss_coef=0.5, entropy_coef=0.01,
                    target_kl_div=job.get("target_kl"), lr=job["lr"],
                    optim_str=job["optim"], arch="resnet18",
                    dropout=job["dropout"], seed=job["seed"], mesh=mesh,
                    device=device)
    if job.get("weights"):
        tr.net.load_state_dict(torch.load(job["weights"]))
    tr.net.double()
    return tr


def _ppo(mesh, job):
    """An update on this rank's rows of the global minibatch."""
    from eva_vos_tpu_torch.parallel import shard_batch

    tr = ppo_trainer(job, mesh)
    loss, kl = tr._update(shard_batch(torch.load(job["batch"]), mesh))
    return {**_train_state(mesh, tr.net), "loss": loss, "kl": kl}


def _ppo_optimize(mesh, job):
    """``optimize`` over this rank's own rollouts (seeded by its rank)."""
    tr = ppo_trainer(job, mesh)
    loss = tr.optimize(rollout_storage(job["rollout_seed"] + mesh.rank,
                                       job["size"]),
                       np.random.default_rng(job["rng_seed"]))
    return {**_train_state(mesh, tr.net), "loss": loss}


def _ppo_uneven(mesh, job):
    """An update on shares of 3 and 5 rows: the text of what it raises."""
    from eva_vos_tpu_torch.parallel.dryrun import ppo_batch

    tr = ppo_trainer(dict(lr=0.01, optim="SGD", dropout=0.0, seed=0), mesh)
    batch = {k: torch.as_tensor(v).double() if v.dtype == np.float32
             else torch.as_tensor(v)
             for k, v in ppo_batch(3 + 2 * mesh.rank, 8, 16).items()}
    try:
        tr._update(batch)
    except ValueError as e:
        return str(e)
    return "no error"


def _batch_norm(mesh, job):
    from eva_vos_tpu_torch.train.common import flax_batch_stats_

    x = torch.load(job["x"])
    per = x.shape[0] // mesh.size
    bn = flax_batch_stats_(torch.nn.BatchNorm2d(x.shape[1]).double(), mesh)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        bn.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
    bn.train()
    outs = []
    for step in range(2):
        xs = x[mesh.rank * per:(mesh.rank + 1) * per].clone().requires_grad_()
        y = bn(xs + step)
        (y * torch.linspace(-1, 2, y.numel(), dtype=y.dtype).view_as(y)
         ).sum().backward()
        outs.append({"y": y.detach(), "x_grad": xs.grad})
    return {"steps": outs, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


JOBS = {"readout": _readout, "bytes": _bytes, "episode": _episode,
        "shard": _shard, "qnet": _qnet, "ppo": _ppo,
        "ppo_optimize": _ppo_optimize, "ppo_uneven": _ppo_uneven,
        "batch_norm": _batch_norm}


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def worker(jobs_path: str, rank: int, size: int) -> None:
    import torch.distributed as dist

    from eva_vos_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    tmp = Path(jobs_path).parent
    dist.init_process_group("gloo", init_method=(tmp / "store").as_uri(),
                            world_size=size, rank=rank)
    try:
        mesh = make_mesh(size, device="cpu")
        out = {job["name"]: JOBS[job["kind"]](mesh, job)
               for job in json.loads(Path(jobs_path).read_text())}
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run(jobs: list, n: int, tmp: Path) -> list:
    """Run ``jobs`` on ``n`` gloo ranks; -> each rank's {name: output}."""
    from eva_vos_tpu_torch.parallel.dryrun import spawn

    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    spawn(n, [Path(__file__).resolve(), tmp / "jobs.json"], TIMEOUT_S)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(n)]


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
