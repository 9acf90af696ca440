"""The multi-process dry run (counterpart of ``__graft_entry__``'s
``dryrun_multichip`` and ``dryrun_multihost``): first the two-process
rehearsal of the eval CLI's ``--multihost`` path
(``_multihost_rehearsal``), then every data-parallel and bank-sharded
path of the port, in ``n`` processes, each against its one-process
result.  Both run on the card unless the caller passes ``device='cpu'``.

Each process of the dry run proper runs, on its mesh rank:

* a data-parallel QNet step against the one-process step on the global
  batch (float64, dropout on);
* the sharded memory readout against the plain ``memory_readout``;
* a data-parallel PPO update against the one-process update (float64);
* a three-round sharded-bank episode (interacts at frames 0, T-1 and 1)
  against the one-process engine;
* the readout's collective bytes at two bank sizes: equal, and at most
  4x ``comm_model_bytes``.

Usage (one process per card over NCCL, or processes sharing a card over
gloo; ``device="cpu"``: gloo on the CPU)::

    python -c "from eva_vos_tpu_torch.parallel import dryrun_multichip;
               dryrun_multichip(2)"
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .mesh import group_backend

STEP_TOL = 1e-7            # data-parallel step against one process, float64
LOSS_TOL = 1e-6            # its metrics, taken on fp32 logits as in JAX
RTOL, ATOL = 1e-4, 1e-5    # sharded reads against the single-device read
REPO = Path(__file__).resolve().parents[2]


def _state_errors(one, other, before) -> dict:
    """Largest difference of two stepped networks' state, over the leaves:
    of a parameter, over the one-process step's largest change of it
    (``param_err``) and in L2 over that change's L2 norm
    (``param_l2_err``); of a running statistic, over its largest
    magnitude."""
    a, b = one.state_dict(), other.state_dict()
    params = {n for n, _ in one.named_parameters()}
    param_err, param_l2_err, stat_err = 0.0, 0.0, 0.0
    for k, want in a.items():
        if not want.is_floating_point():
            continue
        diff = b[k] - want
        if k in params:
            change = want - before[k]
            param_err = max(param_err, diff.abs().max().item()
                            / max(change.abs().max().item(), 1e-30))
            param_l2_err = max(param_l2_err, diff.norm().item()
                               / max(change.norm().item(), 1e-30))
        else:
            stat_err = max(stat_err, diff.abs().max().item()
                           / max(want.abs().max().item(), 1e-30))
    return {"param_err": param_err, "param_l2_err": param_l2_err,
            "stat_err": stat_err}


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def qnet_step_check(mesh, rows: int, size: int, dtype=torch.float64,
                    dropout: float = 0.5, seed: int = 0) -> dict:
    """One data-parallel QNet step (SGD, resnet18) on this rank's rows of
    a global batch against the one-process step on all of it: the state's
    and metrics' errors."""
    from ..train import QNetTrainer
    from .mesh import shard_batch

    rng = np.random.default_rng(seed)
    batch = {"img": rng.standard_normal((rows, size, size, 3)).astype(np.float32),
             "mask": rng.uniform(size=(rows, size, size)).astype(np.float32),
             "label": rng.integers(0, 20, rows).astype(np.int32)}
    trainers = [QNetTrainer(arch="resnet18", lr=1e-2, optim="SGD",
                            dropout=dropout, device=mesh.device, mesh=m)
                for m in (None, mesh)]
    states = [tr.init(seed=seed) for tr in trainers]
    for st in states:
        st.net.to(dtype)
    before = {k: v.clone() for k, v in states[0].net.state_dict().items()}
    batches = [batch, shard_batch(batch, mesh)]
    metrics = []
    for i, tr in enumerate(trainers):
        states[i], m = tr.train_step(states[i], batches[i])
        metrics.append(m)
    out = _state_errors(states[0].net, states[1].net, before)
    out["loss_err"] = _rel(metrics[1]["loss"], metrics[0]["loss"])
    out["acc_err"] = _rel(metrics[1]["acc"], metrics[0]["acc"])
    evals = [tr.eval_step(st, b)
             for tr, st, b in zip(trainers, states, batches)]
    out["eval_loss_err"] = _rel(evals[1]["loss"], evals[0]["loss"])
    out["loss"] = float(metrics[1]["loss"])
    return out


def ppo_batch(rows: int, emb_hw: int, mask_hw: int, seed: int = 0) -> dict:
    """A PPO minibatch of host arrays, weight 0 on its last quarter."""
    rng = np.random.default_rng(seed)
    w = np.ones(rows, np.float32)
    w[rows - rows // 4:] = 0.0
    return {
        "embeddings": rng.standard_normal((rows, emb_hw, emb_hw, 256)).astype(
            np.float32),
        "masks": rng.uniform(size=(rows, mask_hw, mask_hw, 3)).astype(
            np.float32),
        "actions": rng.integers(0, 2, rows).astype(np.int64),
        "old_log_probs": -np.abs(rng.standard_normal(rows)).astype(np.float32),
        "advantages": rng.standard_normal(rows).astype(np.float32),
        "returns": rng.standard_normal(rows).astype(np.float32),
        "weights": w}


def ppo_update_check(mesh, rows: int, emb_hw: int = 8, mask_hw: int = 64,
                     dtype=torch.float64, dropout: float = 0.5,
                     seed: int = 0) -> dict:
    """One data-parallel PPO update on this rank's rows of a global
    minibatch against the one-process update on all of it: the state's,
    loss's and KL's errors."""
    from ..train.ppo import PPOTrainer
    from .mesh import shard_batch

    kw = dict(action_space=2, ppo_epochs=1, clip_param=0.2,
              value_loss_coef=0.5, entropy_coef=0.01, target_kl_div=None,
              lr=1e-2, optim_str="SGD", arch="resnet18", dropout=dropout,
              seed=seed, device=mesh.device)
    trainers = [PPOTrainer(**kw, mesh=m) for m in (None, mesh)]
    for tr in trainers:
        tr.net.to(dtype)
    before = {k: v.clone() for k, v in trainers[0].net.state_dict().items()}
    batch = {k: torch.as_tensor(v, device=mesh.device)
             for k, v in ppo_batch(rows, emb_hw, mask_hw, seed).items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    (loss1, kl1), (loss2, kl2) = (tr._update(b) for tr, b in zip(
        trainers, (batch, shard_batch(batch, mesh))))
    out = _state_errors(trainers[0].net, trainers[1].net, before)
    out.update(loss_err=_rel(loss2, loss1), kl_err=_rel(kl2, kl1),
               loss=float(loss2))
    return out


def readout_check(mesh, m_per_rank: int = 16, n: int = 12, cv: int = 24,
                  top_k: int = 7, seed: int = 0) -> dict:
    """The sharded readout of a random bank against ``memory_readout`` on
    the whole bank, and its collective bytes at two bank sizes."""
    from ..ops.memory_attention import memory_readout
    from .sharded_attention import (collective_bytes, comm_model_bytes,
                                    sharded_memory_readout)

    ck = 64   # the selection kernels' key width
    rng = np.random.default_rng(seed)
    m = m_per_rank * mesh.size
    dev = mesh.device
    mk = torch.as_tensor(rng.standard_normal((m, ck)), dtype=torch.float32,
                         device=dev)
    qk = torch.as_tensor(rng.standard_normal((n, ck)), dtype=torch.float32,
                         device=dev)
    mv = torch.as_tensor(rng.standard_normal((1, m, cv)), dtype=torch.float32,
                         device=dev)
    lo, hi = mesh.rank * m_per_rank, (mesh.rank + 1) * m_per_rank
    out = sharded_memory_readout(mk[lo:hi], qk, mv[:, lo:hi], top_k, mesh)
    ref = memory_readout(mk, qk, mv, top_k=top_k)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)

    def measured(per_rank):
        mk_ = torch.zeros((per_rank, ck), device=dev)
        mv_ = torch.zeros((1, per_rank, cv), device=dev)
        return collective_bytes(sharded_memory_readout, mesh, mk_, qk, mv_,
                                top_k, mesh)

    small, big = measured(m_per_rank), measured(4 * m_per_rank)
    model = comm_model_bytes(n, top_k, cv, 1, mesh.size)
    if small != big:
        raise RuntimeError(f"collective bytes depend on the bank size: "
                           f"{small} vs {big}")
    if small["total_bytes"] > 4 * model["total_bytes"]:
        raise RuntimeError(f"collective bytes {small} exceed 4x the model "
                           f"{model}")
    return {"max_abs_err": (out - ref).abs().max().item(), "bytes": small,
            "model_bytes": model["total_bytes"]}


def episode_check(mesh, t: int = 6, h: int = 48, w: int = 64,
                  max_interactions: int = 3, seed: int = 5) -> dict:
    """A three-round episode (frames 0, T-1, 1) of the sharded-bank engine
    against the one-process engine ('gather', the plain read) on the same
    seeded weights.  At the default sizes the second round's backward pass
    admits its memories past the first rank's slots."""
    from ..data import synthetic_video
    from ..engine import EngineConfig, InferenceEngine, pad_mask, prepare_video
    from ..models import FusionNet, PropagationNetwork
    from ..models.init import make_generator, seeded_init_

    dev = mesh.device
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    fusion = FusionNet()
    seeded_init_(stcn, make_generator(seed, "cpu"))
    seeded_init_(fusion, make_generator(seed + 1, "cpu"))
    cfg = EngineConfig(mem_freq=2, top_k=8,
                       max_interactions=max_interactions, feature_chunk=2,
                       readout_strategy="sharded")
    sharded = InferenceEngine(stcn, fusion, cfg, mesh=mesh)
    single = InferenceEngine(stcn, fusion,
                             cfg._replace(readout_strategy="gather"),
                             device=dev)
    images, gt = synthetic_video(t, h, w, num_objects=1, seed=0)
    padded, pad = prepare_video(images, device=dev)
    feats = single.precompute_features(padded)
    st, st_ref = sharded.init_state(feats, 1), single.init_state(feats, 1)
    for idx in (0, t - 1, 1):
        m = pad_mask(gt[:, idx].astype(np.float32), pad, device=dev)
        st = sharded.interact(st, feats, m, idx)
        st_ref = single.interact(st_ref, feats, m, idx)
    if not torch.isfinite(st.prob).all():
        raise RuntimeError("sharded episode: non-finite probabilities")
    torch.testing.assert_close(st.prob, st_ref.prob, rtol=RTOL, atol=ATOL)
    return {"max_abs_err": (st.prob - st_ref.prob).abs().max().item(),
            "bank_slots": st.bank_k.shape[0],
            "bank_slots_single": st_ref.bank_k.shape[0],
            "slots_written": int((st.bank_k.flatten(1).abs().sum(1) > 0)
                                 .sum())}


def _check_step(name: str, errs: dict) -> None:
    bad = {k: v for k, v in errs.items() if k.endswith("_err") and not v <= (
        STEP_TOL if k in ("param_err", "param_l2_err", "stat_err")
        else LOSS_TOL)}
    if bad:
        raise RuntimeError(f"{name}: data-parallel step off the one-process "
                           f"step: {bad}")


def worker(rank: int, size: int, init_method: str, backend: str,
           device: str, out_path: str) -> dict:
    """One process of the dry run: join the group, run every check on this
    rank, write the results as JSON to ``out_path``."""
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank)
    try:
        mesh = make_mesh(size, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        qnet = qnet_step_check(mesh, rows=2 * size, size=32)
        _check_step("qnet", qnet)
        readout = readout_check(mesh)
        ppo = ppo_update_check(mesh, rows=2 * size)
        _check_step("ppo", ppo)
        episode = episode_check(mesh)
        out = {"rank": rank, "qnet": qnet, "readout": readout, "ppo": ppo,
               "episode": episode}
        Path(out_path).write_text(json.dumps(out))
        return out
    finally:
        dist.destroy_process_group()


def spawn(n: int, argv, timeout: float) -> list:
    """Run ``python <argv...> <rank> <n>`` in ``n`` processes at once, from
    the repository root with it on the path, each bounded by ``timeout``
    seconds; a failed or late rank raises with its output.  Returns each
    rank's output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, *map(str, argv), str(rank), str(n)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(n)]
    outs, failed = [], []
    try:
        for rank, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
                failed.append(f"rank {rank}: timed out after {timeout} s")
                continue
            if p.returncode != 0:
                failed.append(f"rank {rank}: exit {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        logs = "\n".join(f"--- rank {r} ---\n{o[-4000:]}"
                         for r, o in enumerate(outs))
        raise RuntimeError(f"{argv[:2]}: " + "; ".join(failed) + "\n"
                           + logs)
    return outs


def dryrun_multihost(n_procs: int = 2, device: str = "cuda",
                     timeout: float = 120.0) -> dict:
    """The multi-host rehearsal (counterpart of ``__graft_entry__``'s
    ``dryrun_multihost``): ``n_procs`` processes of
    ``parallel._multihost_rehearsal`` on a free local port, each joining
    the group through ``init_distributed``, checking its
    ``host_shard_range`` and one cross-process ``all_reduce``, on
    ``device`` ('cuda': process p on card p modulo the card count, over
    NCCL when each has its own card, else gloo; 'cpu': gloo).  A failed
    or late process raises with its output."""
    import socket

    backend = group_backend(n_procs, device)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("import sys; from eva_vos_tpu_torch.parallel._multihost_rehearsal"
            " import main; main(int(sys.argv[3]), int(sys.argv[4]), "
            "sys.argv[1], sys.argv[2])")
    outs = spawn(n_procs, ["-c", code, port, device], timeout)
    lines = [line for out in outs for line in out.splitlines()
             if line.startswith("[multihost-rehearsal]")]
    print(f"dryrun_multihost({n_procs}, {device!r}): init_distributed over "
          f"{backend} + host_shard_range + cross-process all_reduce OK",
          flush=True)
    return {"n_procs": n_procs, "backend": backend, "device": device,
            "lines": lines}


def dryrun_multichip(n: int, backend: str | None = None, device: str = "cuda",
                     timeout: float = 300.0) -> dict:
    """The multi-host rehearsal (:func:`dryrun_multihost`, two processes on
    ``device``), then the dry run in ``n`` processes over ``backend`` on
    ``device`` (rank r on card r modulo the card count).  ``backend=None``
    is 'nccl' when ``n`` fits on the cards and 'gloo' otherwise, or on
    the CPU.  Without a CUDA device it raises unless ``device='cpu'``; a
    failed rank raises.  Returns rank 0's results, with the rehearsal's
    under "multihost"."""
    backend = backend or group_backend(n, device)
    multihost = dryrun_multihost(2, device, timeout)
    with tempfile.TemporaryDirectory() as tmp:
        code = ("import sys; from eva_vos_tpu_torch.parallel.dryrun import "
                "main; main(sys.argv[1:])")
        spawn(n, ["-c", code, Path(tmp, "store").as_uri(), backend, device,
                  tmp], timeout)
        results = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                   for r in range(n)]
    out = dict(results[0], multihost=multihost)
    print(f"dryrun_multichip({n}, {backend!r}, {device!r}): dp qnet step "
          f"(param err {out['qnet']['param_err']:.2e}) + dp ppo update "
          f"(param err {out['ppo']['param_err']:.2e}) + sharded readout "
          f"(max |d| {out['readout']['max_abs_err']:.2e}) + 3-round "
          f"sharded-bank episode (max |d| {out['episode']['max_abs_err']:.2e})"
          f" == one process; collectives {out['readout']['bytes']['total_bytes']}"
          f" B a read, bank-size independent, model "
          f"{out['readout']['model_bytes']} B: OK", flush=True)
    return out


def main(argv) -> None:
    """A spawned rank: ``<store uri> <backend> <device> <dir> <rank> <n>``."""
    store, backend, device, tmp, rank, size = argv
    worker(int(rank), int(size), store, backend, device,
           str(Path(tmp, f"rank{rank}.json")))
