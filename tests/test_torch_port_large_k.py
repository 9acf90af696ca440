"""The memory read above top_k = 256, on the CPU: the port against the JAX
package.

On the card the default read (#1 ``topk_select`` chained into #2
``topk_readout``) takes any top_k in [1, M]; above 256 #1 runs a radix
select whose rules ``kernels.memory_topk`` states (``radix_threshold``: the
11-bit digits of the 64-bit keys, the final bin of each query, its
candidates up to a cap and the passes over the bank; ``radix_lists``: the
selection).  Here:

* (a) those rules against a numpy oracle (``lexsort`` by (-score, id)) and
  the JAX ``memory_affinity_topk``: top_k 257, 300, 1,000 and M, fp32 and
  bf16-rounded keys, ``valid_tokens`` below top_k, identical keys and
  exact ties at the threshold across bank blocks; bins that overflow the
  cap (small caps, so that the rules go down the score digits into the id
  digits) and kk == valid (every live token, one pass);
* (b) the port's ``memory_readout`` ('gather', 'scatter', and 'fused',
  which runs the kernels' plain versions on the CPU) against the JAX
  ``memory_readout`` ('scatter' and 'gather') at top_k 300 and 1,000;
* (c) the port's engine at top_k 300 against the JAX engine (as
  ``tests/test_torch_port_engine.py``), K = 1 and 2, 128x192 frames (96
  tokens a frame: a one-slot bank holds fewer than 300, the bank more);
* (d) marked slow: the JAX ``pallas_fused_readout`` at top_k 300 in
  interpret mode against the port's plain fused read.

Tolerances: the rules work on the keys of one score matrix, so they must
give the oracle's selection exactly.  The JAX scores come from another
matmul, a few fp32 ulps apart: weights within 1e-6, ids equal except at
neighbouring scores within 1e-4 (integer-valued keys score exactly on both
sides, so there ids are equal everywhere).  Readouts are weighted means of
N(0, 1) values (atol 1e-5; 2.1e-6 measured).  The engine's tolerance is
``test_torch_port_engine.py``'s (atol 1e-4, 99.9% of the masks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.engine.propagation import EngineConfig as JxConfig
from eva_vos_tpu.engine.propagation import InferenceEngine as JxEngine
from eva_vos_tpu.engine.propagation import pad_mask as jx_pad_mask
from eva_vos_tpu.engine.propagation import prepare_video as jx_prepare
from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout
from eva_vos_tpu.models import FusionNet as JxFusion
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu.ops import memory_attention as jx_mem
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine, pad_mask,
                                      prepare_video)
from eva_vos_tpu_torch.kernels import fused_readout_plain
from eva_vos_tpu_torch.kernels.memory_topk import (DEAD_KEY, radix_cap,
                                                   radix_lists,
                                                   radix_threshold, sort_keys)
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.ops import memory_attention as mem
from eva_vos_tpu_torch.utils import (fusion_state_dict_from_flax,
                                     stcn_state_dict_from_flax)

M, N, CK = 3000, 64, 64


def _bank(kind: str, m: int = M, seed: int = 0):
    """(mk [m, CK], qk [N, CK]) fp32 numpy: 'fp32' random, 'bf16' random
    rounded to bf16, 'integer' small integers (exact scores, many ties),
    'identical' one key repeated, 'tied' seven keys repeated along the
    bank (every score value m / 7 times, across the bank blocks)."""
    rng = np.random.default_rng(seed)
    qk = rng.standard_normal((N, CK)).astype(np.float32)
    if kind == "integer":
        qk = rng.integers(-2, 3, (N, CK)).astype(np.float32)
        mk = rng.integers(-2, 3, (m, CK)).astype(np.float32)
    elif kind == "identical":
        mk = np.tile(rng.standard_normal((1, CK)), (m, 1)).astype(np.float32)
    elif kind == "tied":
        mk = np.tile(rng.standard_normal((7, CK)), (-(-m // 7), 1))[:m]
        mk = mk.astype(np.float32)
    else:
        mk = rng.standard_normal((m, CK)).astype(np.float32)
    if kind == "bf16":
        qk, mk = (torch.from_numpy(x).bfloat16().float().numpy()
                  for x in (qk, mk))
    return mk, qk


def _keys(mk, qk):
    """The kernels' 64-bit keys of the plain scores, and the scores."""
    s = mem._scores(torch.from_numpy(mk), torch.from_numpy(qk))
    ids = torch.arange(s.shape[1]).expand_as(s)
    return sort_keys(s, ids, torch.ones_like(ids, dtype=torch.bool)), s


def _oracle(scores: torch.Tensor, valid: int, top_k: int) -> np.ndarray:
    """Ids [N, min(top_k, valid)] by (score desc, id asc)."""
    s = scores[:, :valid].double().numpy()
    ids = np.broadcast_to(np.arange(valid), s.shape)
    return np.lexsort((ids, -s), axis=1)[:, :min(top_k, valid)]


RULE_CASES = [(kind, k, valid) for kind in ("fp32", "bf16")
              for k in (257, 300, 1000, M) for valid in (M, 250)]


@pytest.mark.parametrize("kind,top_k,valid", RULE_CASES, ids=str)
def test_radix_lists_match_oracle(kind, top_k, valid):
    """The rules' selection is the oracle's, ids and raw scores; slots past
    the live tokens hold (-1e30, 0)."""
    mk, qk = _bank(kind)
    keys, scores = _keys(mk, qk)
    vals, idx = radix_lists(keys, valid, top_k)
    assert vals.shape == idx.shape == (top_k, N)
    want = _oracle(scores, valid, top_k)
    kk = want.shape[1]
    np.testing.assert_array_equal(idx[:kk].T.numpy(), want)
    np.testing.assert_array_equal(
        vals[:kk].T.numpy(), np.take_along_axis(scores.numpy(), want, 1))
    assert (vals[kk:] == -1e30).all() and (idx[kk:] == 0).all()


def _check_bins(keys, valid, top_k, cap=None):
    """The bins of ``radix_threshold`` against a full sort of the keys: the
    kk-th largest key lies in [lo, hi], ``greater`` keys above hi and
    ``count`` <= cap in the bin, of which the ``need`` largest close the
    top kk; kk == valid takes one pass and no bin."""
    bins = radix_threshold(keys, valid, top_k, cap)
    cap = radix_cap(valid, top_k) if cap is None else cap
    live = keys[:, :valid]
    kk = min(top_k, valid)
    if kk == valid:
        assert (bins.greater == kk).all() and (bins.need == 0).all()
        assert (bins.scorings == 1).all() and not bins.spilled.any()
        return bins
    kth = live.sort(1, descending=True).values[:, kk - 1]
    assert ((bins.lo <= kth) & (kth <= bins.hi)).all()
    in_bin = ((live >= bins.lo[:, None]) & (live <= bins.hi[:, None])).sum(1)
    torch.testing.assert_close(bins.greater, (live > bins.hi[:, None]).sum(1),
                               rtol=0, atol=0)
    torch.testing.assert_close(bins.count, in_bin, rtol=0, atol=0)
    assert (bins.count <= cap).all()
    assert ((bins.need >= 1) & (bins.need <= bins.count)).all()
    torch.testing.assert_close(bins.greater + bins.need,
                               torch.full_like(bins.need, kk), rtol=0, atol=0)
    assert (bins.scorings >= 2).all()
    assert torch.equal(bins.spilled, bins.scorings > 2)
    return bins


@pytest.mark.parametrize("kind,top_k,valid", RULE_CASES, ids=str)
def test_radix_threshold_digits(kind, top_k, valid):
    """Each query's final bin holds its kk-th largest key, the keys above
    it and in it are counted as a full sort counts them, and with random
    keys the first digit's bin fits the cap: two passes."""
    mk, qk = _bank(kind)
    keys, _ = _keys(mk, qk)
    bins = _check_bins(keys, valid, top_k)
    if min(top_k, valid) < valid:
        assert (bins.scorings == 2).all()


@pytest.mark.parametrize("top_k", [257, 1000, M])
def test_radix_identical_keys(top_k):
    """Every score of a row ties: one bin holds the whole bank (within the
    cap, M), need is kk (no key above it), and the ids are 0..kk-1, the
    lowest."""
    mk, qk = _bank("identical")
    keys, _ = _keys(mk, qk)
    bins = _check_bins(keys, M, top_k)
    if top_k < M:
        assert (bins.need == top_k).all() and (bins.count == M).all()
    _, idx = radix_lists(keys, M, top_k)
    want = torch.arange(top_k, dtype=torch.int32)[:, None].expand(top_k, N)
    assert torch.equal(idx, want)


@pytest.mark.parametrize("top_k", [257, 300, 1000, 4999])
def test_radix_ties_at_threshold(top_k):
    """Seven keys repeated along a 5,000-token bank (three bank blocks of
    2,048): the kk-th key falls inside a run of 714 tied scores spread over
    every block, of which only some are taken, and the tied keys taken are
    the lowest ids, as the oracle's."""
    mk, qk = _bank("tied", m=5000, seed=3)
    keys, scores = _keys(mk, qk)
    _check_bins(keys, 5000, top_k)
    kth = keys.sort(1, descending=True).values[:, top_k - 1]
    ords = keys >> 32
    tied = (ords == (kth >> 32)[:, None]).sum(1)
    taken = top_k - (ords > (kth >> 32)[:, None]).sum(1)
    assert (tied > taken).any()
    _, idx = radix_lists(keys, 5000, top_k)
    np.testing.assert_array_equal(idx.T.numpy(), _oracle(scores, 5000, top_k))


# (kind, top_k, valid, cap): bins past small caps take more passes, down
# the score digits and, where scores tie, into the id digits
OVERFLOW_CASES = [("fp32", 300, M, 8), ("bf16", 1000, M, 64),
                  ("tied", 300, 5000, 100), ("tied", 1000, 5000, 2),
                  ("identical", 257, M, 1), ("identical", 1000, M, 500)]


def _overflow_bank(kind):
    if kind == "tied":
        return _bank("tied", m=5000, seed=3)
    return _bank(kind)


@pytest.mark.parametrize("kind,top_k,valid,cap", OVERFLOW_CASES, ids=str)
def test_radix_bin_overflows_cap(kind, top_k, valid, cap):
    """A first bin of more than ``cap`` keys spills: the rules count the
    next digit within it, a pass each, until a bin fits; the selection is
    still the oracle's, ties to the lowest ids."""
    mk, qk = _overflow_bank(kind)
    keys, scores = _keys(mk, qk)
    bins = _check_bins(keys, valid, top_k, cap)
    assert bins.spilled.any() and (bins.scorings >= 3).any()
    if kind in ("identical", "tied"):  # into the id digits
        assert (bins.scorings > 5).any()
    vals, idx = radix_lists(keys, valid, top_k, cap)
    want = _oracle(scores, valid, top_k)
    np.testing.assert_array_equal(idx.T.numpy(), want)
    np.testing.assert_array_equal(
        vals.T.numpy(), np.take_along_axis(scores[:, :valid].numpy(), want, 1))


@pytest.mark.parametrize("kind", ["fp32", "bf16", "identical"])
@pytest.mark.parametrize("top_k,valid", [(300, 300), (M, M), (1000, 700)])
def test_radix_all_live_tokens(kind, top_k, valid):
    """kk == valid: every live key is the answer, in one pass; slots past
    the live tokens hold (-1e30, 0)."""
    mk, qk = _bank(kind)
    keys, scores = _keys(mk, qk)
    bins = _check_bins(keys, valid, top_k)
    assert (bins.lo == DEAD_KEY).all() and (bins.count == 0).all()
    vals, idx = radix_lists(keys, valid, top_k)
    want = _oracle(scores, valid, top_k)
    np.testing.assert_array_equal(idx[:valid].T.numpy(), want)
    assert (vals[valid:] == -1e30).all() and (idx[valid:] == 0).all()


def _assert_near(idx, w, jidx, jw, jvals):
    """ids equal except where the JAX scores of neighbouring slots lie
    within 1e-4; weights within 1e-6."""
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)
    close = np.abs(np.diff(jvals, axis=1)) <= 1e-4
    tied = np.zeros_like(idx, dtype=bool)
    tied[:, :-1] |= close
    tied[:, 1:] |= close
    assert not ((idx != jidx) & ~tied).any()


@pytest.mark.parametrize("kind", ["fp32", "bf16", "integer"])
@pytest.mark.parametrize("top_k", [257, 1000, M])
@pytest.mark.parametrize("valid", [M, 250])
def test_radix_lists_match_jax(kind, top_k, valid):
    """The rules against the JAX ``memory_affinity_topk`` (its own scores):
    the same ids and softmax weights; with integer keys the scores are
    exact on both sides and every id must agree, ties included."""
    mk, qk = _bank(kind)
    keys, _ = _keys(mk, qk)
    vals, idx = radix_lists(keys, valid, top_k)
    w = mem.softmax_weights(vals.T).numpy()
    jw, jidx = jx_mem.memory_affinity_topk(jnp.asarray(mk), jnp.asarray(qk),
                                           top_k, valid)
    jvals = np.asarray(jx_mem._scores(jnp.asarray(mk), jnp.asarray(qk),
                                      valid))
    jvals = np.take_along_axis(jvals, np.asarray(jidx), 1)
    kk = min(top_k, valid)
    if kind == "integer":
        np.testing.assert_array_equal(idx[:kk].T.numpy(),
                                      np.asarray(jidx)[:, :kk])
    _assert_near(idx[:kk].T.numpy(), w[:, :kk], np.asarray(jidx)[:, :kk],
                 np.asarray(jw)[:, :kk], jvals[:, :kk])
    # the dead slots weigh 0 on both sides
    np.testing.assert_array_equal(w[:, kk:], 0.0)
    np.testing.assert_array_equal(np.asarray(jw)[:, kk:], 0.0)


@pytest.mark.parametrize("kind,top_k,valid,cap", [
    ("fp32", 300, M, 8), ("integer", 1000, M, 16), ("bf16", 257, M, 1),
    ("fp32", 500, 500, None), ("integer", M, M, None)], ids=str)
def test_radix_overflow_matches_jax(kind, top_k, valid, cap):
    """The rules with a spilled first bin (small caps) and with kk == valid
    against the JAX ``memory_affinity_topk``, as above."""
    mk, qk = _bank(kind)
    keys, _ = _keys(mk, qk)
    if cap is not None:
        assert radix_threshold(keys, valid, top_k, cap).spilled.any()
    vals, idx = radix_lists(keys, valid, top_k, cap)
    w = mem.softmax_weights(vals.T).numpy()
    jw, jidx = jx_mem.memory_affinity_topk(jnp.asarray(mk), jnp.asarray(qk),
                                           top_k, valid)
    jvals = np.take_along_axis(np.asarray(jx_mem._scores(
        jnp.asarray(mk), jnp.asarray(qk), valid)), np.asarray(jidx), 1)
    if kind == "integer":
        np.testing.assert_array_equal(idx.T.numpy(), np.asarray(jidx))
    _assert_near(idx.T.numpy(), w, np.asarray(jidx), np.asarray(jw), jvals)


READ_N, READ_CV = 200, 64


@functools.lru_cache(maxsize=None)
def _read_inputs(seed: int = 5):
    rng = np.random.default_rng(seed)
    mk = rng.standard_normal((M, CK)).astype(np.float32)
    qk = rng.standard_normal((READ_N, CK)).astype(np.float32)
    mv = rng.standard_normal((2, M, READ_CV)).astype(np.float32)
    return mk, qk, mv


@functools.lru_cache(maxsize=None)
def _jax_read(top_k: int, valid, strategy: str) -> np.ndarray:
    mk, qk, mv = _read_inputs()
    return np.asarray(jx_mem.memory_readout(
        jnp.asarray(mk), jnp.asarray(qk), jnp.asarray(mv), top_k, valid,
        strategy=strategy))


@pytest.mark.parametrize("strategy", ["gather", "scatter", "fused"])
@pytest.mark.parametrize("jax_strategy", ["scatter", "gather"])
@pytest.mark.parametrize("top_k", [300, 1000])
@pytest.mark.parametrize("valid", [None, 250])
def test_memory_readout_matches_jax(strategy, jax_strategy, top_k, valid):
    mk, qk, mv = _read_inputs()
    got = mem.memory_readout(torch.from_numpy(mk), torch.from_numpy(qk),
                             torch.from_numpy(mv), top_k, valid,
                             strategy=strategy)
    assert got.shape == (2, READ_N, READ_CV)
    np.testing.assert_allclose(got.numpy(), _jax_read(top_k, valid,
                                                      jax_strategy),
                               rtol=0, atol=1e-5)


T, H, W = 6, 128, 192
MEM_FREQ, TOP_K = 2, 300
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


@pytest.mark.parametrize("k_objects", [1, 2])
def test_engine_top_k_300_matches_jax(nets, k_objects):
    """Frame 0's reads see a one-frame bank of 96 tokens (204 dead slots of
    weight 0); frame 4's blocked passes read banks of up to 4 frames (384
    tokens), where 300 of them are chosen."""
    jstcn, jfusion, sp, fp = nets[0]
    stcn, fusion = nets[1]
    images, masks = synthetic_video(T, H, W, num_objects=k_objects, seed=3)

    jcfg = JxConfig(mem_freq=MEM_FREQ, top_k=TOP_K, max_interactions=4,
                    feature_chunk=2, readout_strategy="gather")
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

    cfg = EngineConfig(mem_freq=MEM_FREQ, top_k=TOP_K, max_interactions=4,
                       feature_chunk=2)
    engine = InferenceEngine(stcn, fusion, cfg, device="cpu")
    padded, pad = prepare_video(images, device="cpu")
    assert pad == jpad
    feats = engine.precompute_features(padded)
    hw = feats.k16.shape[1]
    assert hw < TOP_K < 4 * hw
    state = engine.init_state(feats, k_objects)
    for idx, want in zip(ROUNDS, ref):
        state = engine.interact(
            state, feats, pad_mask(masks[:, idx], pad, device="cpu"), idx)
        np.testing.assert_allclose(state.prob.numpy(), want, rtol=0,
                                   atol=1e-4,
                                   err_msg=f"after interacting frame {idx}")
    ours = engine.masks_from_prob(state.prob, pad)
    theirs = JxEngine.masks_from_prob(jstate.prob, jpad)
    assert np.mean(ours == theirs) >= 0.999


@pytest.mark.slow
def test_pallas_fused_readout_top_k_300_matches_plain():
    """The JAX fused read (#1 then #2, interpret mode) against the port's
    plain fused read at top_k 300 (3.6e-7 apart when measured)."""
    rng = np.random.default_rng(2)
    mk = rng.standard_normal((1024, CK)).astype(np.float32)
    qk = rng.standard_normal((64, CK)).astype(np.float32)
    mv = rng.standard_normal((1, 1024, 128)).astype(np.float32)
    want = pallas_fused_readout(jnp.asarray(mk), jnp.asarray(qk),
                                jnp.asarray(mv), 300, block_q=32,
                                block_m=512, interpret=True)
    got = fused_readout_plain(torch.from_numpy(mk), torch.from_numpy(qk),
                              torch.from_numpy(mv), 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
