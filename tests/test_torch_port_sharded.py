"""The port's bank-sharded memory read (``eva_vos_tpu_torch.parallel``) and
the engine's ``readout_strategy="sharded"`` against the JAX package's, on
the CPU.

The port's sharded paths run in 2 and 4 gloo processes
(``torch_port_workers``: one torch thread each, 120 s each, started once
for the module); the JAX references run in this process on the virtual
CPU devices of ``conftest.py``, ``make_mesh(2)`` / ``make_mesh(4)``.  The
tolerance is the JAX sharding tests' own, ``rtol=1e-4, atol=1e-5``, against
the JAX sharded read and against the port's single-process read.
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
from eva_vos_tpu.parallel import comm_model_bytes as jx_comm_model_bytes
from eva_vos_tpu.parallel import make_mesh as jx_make_mesh
from eva_vos_tpu.parallel import shard_batch as jx_shard_batch
from eva_vos_tpu.parallel import sharded_memory_readout as jx_sharded_readout
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine, pad_mask,
                                      prepare_video)
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.ops.memory_attention import memory_readout
from eva_vos_tpu_torch.parallel import (comm_model_bytes, make_mesh,
                                        shard_batch, sharded_memory_readout)
from eva_vos_tpu_torch.utils import (fusion_state_dict_from_flax,
                                     stcn_state_dict_from_flax)
from test_torch_port_engine import _random_variables
from torch_port_workers import readout_inputs, run

RTOL, ATOL = 1e-4, 1e-5

# (name, case): the JAX tests' sizes and ``valid``; top_k above every
# shard's size; exact ties inside and across the shards
READOUT_CASES = {
    "all_valid": dict(seed=1, m=128, n=32, ck=16, cv=24, k_obj=2, top_k=10),
    "valid96": dict(seed=2, m=128, n=32, ck=16, cv=24, k_obj=2, top_k=10,
                    valid=96),
    "top_k_over_shard": dict(seed=3, m=16, n=8, ck=8, cv=16, k_obj=1,
                             top_k=12),
    "dup_keys": dict(seed=4, m=64, n=16, ck=16, cv=8, k_obj=2, top_k=9,
                     int_keys=True, dup=True),
}
BYTES_JOB = dict(name="bytes", kind="bytes", n=12, ck=16, cv=24, top_k=7,
                 m_per_rank=[16, 64])
# the JAX sharding test's episode (T=4), held to the JAX sharded engine
# too, and one whose second round admits memories past the first rank's
# slots (T=6, 3 certain slots), held to the port's one-process engine (a
# second JAX engine would compile for another ~45 s)
EPISODES = {
    "jax_sizes": dict(t=4, max_interactions=4),
    "past_first_shard": dict(t=6, max_interactions=3),
}
EPISODE_COMMON = dict(h=48, w=64, mem_freq=2, top_k=8, seed=21)


def _rounds(t):
    return [0, t - 1, 1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(11)
    h, w = EPISODE_COMMON["h"], EPISODE_COMMON["w"]
    jstcn = JxSTCN(key_arch="resnet18", value_arch="resnet18",
                   top_k=EPISODE_COMMON["top_k"])
    jfusion = JxFusion()
    sp = _random_variables(jax.eval_shape(lambda: jstcn.init(
        jax.random.PRNGKey(0), jnp.zeros((h, w, 3)), jnp.zeros((1, h, w)),
        method="init_all")), rng)
    fp = _random_variables(jax.eval_shape(lambda: jfusion.init(
        jax.random.PRNGKey(1), jnp.zeros((h, w, 3)), jnp.zeros((h, w)),
        jnp.zeros((h, w)), jnp.zeros((h, w, 2)), jnp.zeros((2,)))), rng)
    weights = {"stcn": stcn_state_dict_from_flax(sp, "resnet18", "resnet18"),
               "fusion": fusion_state_dict_from_flax(fp)}
    return (jstcn, jfusion, sp, fp), weights


@pytest.fixture(scope="module")
def ranks(nets, tmp_path_factory):
    """{2: [rank outputs], 4: [...]}: every readout case on 2 and 4 ranks;
    the collective bytes, the batch shards and the episodes on 2."""
    tmp = tmp_path_factory.mktemp("sharded")
    torch.save(nets[1], tmp / "weights.pt")
    readouts = [dict(case, name=name, kind="readout")
                for name, case in READOUT_CASES.items()]
    episodes = [dict(EPISODE_COMMON, **ep, name=name, kind="episode",
                     rounds=_rounds(ep["t"]), weights=str(tmp / "weights.pt"))
                for name, ep in EPISODES.items()]
    shard = dict(name="shard", kind="shard", rows=6)
    return {2: run(readouts + [BYTES_JOB, shard] + episodes, 2, tmp / "n2"),
            4: run(readouts + [BYTES_JOB], 4, tmp / "n4")}


# ---------------------------------------------------------------------------
# the sharded readout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("name", list(READOUT_CASES))
def test_sharded_readout_matches_jax(ranks, nproc, name):
    case = READOUT_CASES[name]
    mk, qk, mv = readout_inputs(case)
    valid = case.get("valid")
    want = np.asarray(jx_sharded_readout(
        jnp.asarray(mk), jnp.asarray(qk), jnp.asarray(mv),
        top_k=case["top_k"], mesh=jx_make_mesh(nproc), valid_tokens=valid))
    single = memory_readout(torch.from_numpy(mk), torch.from_numpy(qk),
                            torch.from_numpy(mv), top_k=case["top_k"],
                            valid_tokens=valid).numpy()
    outs = [r[name] for r in ranks[nproc]]
    assert outs[0].shape == (case["k_obj"], case["n"], case["cv"])
    assert outs[0].dtype == torch.float32
    for out in outs[1:]:                      # replicated on every rank
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[0].numpy(), single, rtol=RTOL, atol=ATOL)


def test_one_rank_is_the_single_device_read():
    """A mesh of one process (no group): the plain read, bf16 in and out."""
    mk, qk, mv = readout_inputs(READOUT_CASES["valid96"])
    mk, qk, mv = (torch.from_numpy(a).to(torch.bfloat16) for a in (mk, qk, mv))
    mesh = make_mesh(device="cpu")
    out = sharded_memory_readout(mk, qk, mv, 10, mesh, valid_tokens=96)
    assert out.dtype == torch.bfloat16
    want = memory_readout(mk, qk, mv, top_k=10, valid_tokens=96)
    torch.testing.assert_close(out, want, rtol=2 ** -7, atol=1e-2)
    assert mesh.collective_bytes == {"all-gather": 0, "all-reduce": 0}


@pytest.mark.parametrize("nproc", [2, 4])
def test_collective_bytes_are_bank_size_independent(ranks, nproc):
    j = BYTES_JOB
    model = comm_model_bytes(j["n"], j["top_k"], j["cv"], 1, nproc)
    for r in ranks[nproc]:
        small, big = (r["bytes"][m] for m in j["m_per_rank"])
        assert small == big
        # scores and ids of every rank's candidates, and the fp32 partial
        assert small["all-gather"] == 2 * 4 * nproc * j["n"] * j["top_k"]
        assert small["all-reduce"] == 4 * j["n"] * j["cv"]
        assert 0 < small["total_bytes"] <= 4 * model["total_bytes"]


@pytest.mark.parametrize("args", [(12, 7, 24, 1, 8), (8100, 50, 512, 1, 2),
                                  (1620, 50, 512, 3, 4)])
def test_comm_model_bytes_matches_jax(args):
    assert comm_model_bytes(*args) == jx_comm_model_bytes(*args)


# ---------------------------------------------------------------------------
# the mesh and the batch shards
# ---------------------------------------------------------------------------

def test_make_mesh_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis, mesh.group) == (1, 0, "data",
                                                             None)
    assert mesh.device == torch.device("cpu")
    assert make_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(2, device="cpu")


def test_shard_batch_rows(ranks):
    got = [r["shard"] for r in ranks[2]]
    x = np.arange(18).reshape(6, 3)
    for rank, shard in enumerate(got):
        assert shard["x"].device == torch.device("cpu")
        np.testing.assert_array_equal(shard["x"].numpy(),
                                      x[rank * 3:(rank + 1) * 3])
        np.testing.assert_array_equal(shard["y"].numpy(),
                                      np.arange(rank * 3, (rank + 1) * 3))
    # one process takes the whole batch
    whole = shard_batch({"x": x}, make_mesh(device="cpu"))["x"]
    np.testing.assert_array_equal(whole.numpy(), x)


def test_uneven_batch_raises_as_jax_does():
    """A leading axis that does not divide by the mesh size: the JAX
    sharded placement raises ValueError, and so does the port."""
    with pytest.raises(ValueError, match="divisible"):
        jx_shard_batch({"x": np.zeros((3, 4), np.float32)}, jx_make_mesh(2))

    class TwoRanks:      # rank 0 of a 2-process mesh, without a group
        size, rank, device = 2, 0, torch.device("cpu")

    with pytest.raises(ValueError, match="divisible"):
        shard_batch({"x": np.zeros((3, 4), np.float32)}, TwoRanks())
    assert shard_batch({"x": np.zeros((4, 4))}, TwoRanks())["x"].shape == (2, 4)


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------

def test_sharded_strategy_needs_a_mesh(nets):
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    cfg = EngineConfig(readout_strategy="sharded")
    with pytest.raises(ValueError, match="needs a mesh"):
        InferenceEngine(stcn, FusionNet(), cfg, device="cpu")
    # 'auto' never resolves to the sharded read
    eng = InferenceEngine(stcn, FusionNet(), EngineConfig(), device="cpu",
                          mesh=make_mesh(device="cpu"))
    assert eng.config.readout_strategy == "gather"


def _jx_episode(nets, ep, strategy, mesh=None):
    jstcn, jfusion, sp, fp = nets[0]
    t = ep["t"]
    images, gt = synthetic_video(t, ep["h"], ep["w"], num_objects=1,
                                 seed=ep["seed"])
    cfg = JxConfig(mem_freq=ep["mem_freq"], top_k=ep["top_k"],
                   max_interactions=ep["max_interactions"], feature_chunk=2,
                   readout_strategy=strategy)
    eng = JxEngine(jstcn, jfusion, sp, fp, cfg,
                   **({} if mesh is None else {"mesh": mesh}))
    padded, pad = jx_prepare(images)
    feats = eng.precompute_features(padded)
    state = eng.init_state(feats, 1)
    probs = []
    for idx in _rounds(t):
        state = eng.interact(state, feats, jx_pad_mask(
            gt[:, idx].astype(np.float32), pad), idx)
        probs.append(np.asarray(state.prob))
    return probs


def _port_episode(nets, ep):
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    stcn.load_state_dict(nets[1]["stcn"])
    fusion = FusionNet()
    fusion.load_state_dict(nets[1]["fusion"])
    cfg = EngineConfig(mem_freq=ep["mem_freq"], top_k=ep["top_k"],
                       max_interactions=ep["max_interactions"],
                       feature_chunk=2)
    eng = InferenceEngine(stcn, fusion, cfg, device="cpu")
    t = ep["t"]
    images, gt = synthetic_video(t, ep["h"], ep["w"], num_objects=1,
                                 seed=ep["seed"])
    padded, pad = prepare_video(images, device="cpu")
    feats = eng.precompute_features(padded)
    state = eng.init_state(feats, 1)
    probs = []
    for idx in _rounds(t):
        state = eng.interact(state, feats, pad_mask(
            gt[:, idx].astype(np.float32), pad, device="cpu"), idx)
        probs.append(state.prob.numpy().copy())
    return probs, state


@pytest.mark.parametrize("episode", list(EPISODES))
def test_sharded_episode_matches_jax_and_one_process(nets, ranks, episode):
    ep = dict(EPISODE_COMMON, **EPISODES[episode])
    outs = [r[episode] for r in ranks[2]]
    single, single_state = _port_episode(nets, ep)
    jx_sharded = (_jx_episode(nets, ep, "sharded", mesh=jx_make_mesh(2))
                  if episode == "jax_sizes" else [None] * len(single))
    # each rank allocates half the bank's slots, and holds its own
    slots = single_state.bank_k.shape[0]
    assert slots % 2 == 0
    for rank, out in enumerate(outs):
        assert out["bank_k"].shape[0] == slots // 2
        assert out["bank_v"].shape[1] == slots // 2
        torch.testing.assert_close(
            out["bank_k"], single_state.bank_k[rank * slots // 2:
                                               (rank + 1) * slots // 2],
            rtol=RTOL, atol=ATOL)
    if episode == "past_first_shard":
        assert outs[1]["bank_k"].abs().sum() > 0
    for r, (want_jx, want_one) in enumerate(zip(jx_sharded, single)):
        got = outs[0]["probs"][r]
        torch.testing.assert_close(outs[1]["probs"][r], got, rtol=0, atol=0)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want_one, rtol=RTOL,
                                   atol=ATOL)
        if want_jx is not None:
            np.testing.assert_allclose(got.numpy(), want_jx, rtol=RTOL,
                                       atol=ATOL)
