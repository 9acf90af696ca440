"""Every selection and readout method above top_k = 256, on the CPU: the
port against the JAX package.

On the card every selection (#1 and #4-#8) takes any top_k in [1, M]:
above 256 each takes #1's radix select, the transposed ones (tournament,
chunked, resident) with its transposed write, the row ones (grid,
iterative, sort) with a row epilogue whose plain statement is
``kernels.memory_topk.radix_rows``; the chunked readout (#3) takes #2's
large-k kernel.  Here, at M = 1,024, N = 32, CK = 64:

* (a) ``radix_rows`` against a numpy oracle (``lexsort`` by (-score, id))
  and the port's ``memory_affinity_topk`` / ``topk_scores``: top_k 257,
  300, 1,000 and M, valid below top_k (and 0), tied and identical banks,
  bf16-rounded keys;
* (b) ``select_topk(method=m)`` for 'iterative', 'grid' and 'sort' against
  the JAX ``pallas_memory_topk(method=m, interpret=True)`` at top_k 257 and
  300, raw and weighted;
* (c) the port's ``memory_readout`` under ``KernelConfig(sel_method=
  "resident")``, chunked / chunked, and ``strategy="select"`` at top_k 300
  against the JAX ``memory_readout('scatter')``;
* (d) which route each wrapper takes above 256 on a tensor off the CPU
  (the launch itself replaced by a recorder: this machine has no card);
* (e) marked slow (each JAX call takes 18-35 s in interpret mode): the JAX
  'chunked' and 'resident' selections at top_k 300 against the port's plain
  selection, and ``pallas_fused_readout`` under chunked / chunked and the
  resident selection against the port's plain fused read.

On the CPU every wrapper takes its plain version, so (b), (c) and (e) hold
the plain versions against each JAX kernel.  Tolerances, as
``tests/test_torch_port_large_k.py``: the rules work on the keys of one
score matrix, so they give the oracle's selection exactly; the JAX scores
come from another matmul, a few fp32 ulps apart: weights within 1e-6, ids
equal except at neighbouring scores within 1e-4 (integer-valued keys score
exactly on both sides, so there ids are equal everywhere); readouts are
weighted means of N(0, 1) values, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels.config import KernelConfig as JxKernelConfig
from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout
from eva_vos_tpu.kernels.memory_topk import pallas_memory_topk
from eva_vos_tpu.ops import memory_attention as jx_mem
from eva_vos_tpu_torch.kernels import (KernelConfig, fused_readout_plain,
                                       select_topk, topk_select_plain)
from eva_vos_tpu_torch.kernels import memory_readout as R
from eva_vos_tpu_torch.kernels import memory_topk as MT
from eva_vos_tpu_torch.kernels.memory_topk import radix_rows, sort_keys
from eva_vos_tpu_torch.ops import memory_attention as mem

M, N, CK = 1024, 32, 64


def _bank(kind: str, seed: int = 0):
    """(mk [M, CK], qk [N, CK]) fp32 numpy: 'fp32' random, 'bf16' random
    rounded to bf16, 'integer' small integers (exact scores, many ties),
    'identical' one key repeated, 'tied' seven keys repeated along the
    bank (every score value M / 7 times)."""
    rng = np.random.default_rng(seed)
    qk = rng.standard_normal((N, CK)).astype(np.float32)
    if kind == "integer":
        qk = rng.integers(-2, 3, (N, CK)).astype(np.float32)
        mk = rng.integers(-2, 3, (M, CK)).astype(np.float32)
    elif kind == "identical":
        mk = np.tile(rng.standard_normal((1, CK)), (M, 1)).astype(np.float32)
    elif kind == "tied":
        mk = np.tile(rng.standard_normal((7, CK)), (-(-M // 7), 1))[:M]
        mk = mk.astype(np.float32)
    else:
        mk = rng.standard_normal((M, CK)).astype(np.float32)
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


ROW_CASES = [(kind, k, valid)
             for kind in ("fp32", "bf16", "tied", "identical")
             for k in (257, 300, 1000, M) for valid in (M, 700, 250)]


@pytest.mark.parametrize("return_raw", [False, True])
@pytest.mark.parametrize("kind,top_k,valid", ROW_CASES, ids=str)
def test_radix_rows_match_oracle_and_plain(kind, top_k, valid, return_raw):
    """The row epilogue's plain statement: the oracle's ids (ties to the
    lowest id), the raw scores of those ids, and the port's plain
    ``memory_affinity_topk`` / ``topk_scores`` on the live slots exactly
    (the same scores, the same softmax); the slots from the valid tokens
    hold weight 0 (raw -1e30) and id 0."""
    mk, qk = _bank(kind)
    keys, scores = _keys(mk, qk)
    w, idx = radix_rows(keys, valid, top_k, return_raw)
    assert w.shape == idx.shape == (N, top_k) and idx.dtype == torch.int32
    want = _oracle(scores, valid, top_k)
    kk = want.shape[1]
    np.testing.assert_array_equal(idx[:, :kk].numpy(), want)
    fn = mem.topk_scores if return_raw else mem.memory_affinity_topk
    pw, pi = fn(torch.from_numpy(mk), torch.from_numpy(qk), top_k, valid)
    np.testing.assert_array_equal(idx[:, :kk].numpy(), pi[:, :kk].numpy())
    assert torch.equal(w, pw)
    if return_raw:
        np.testing.assert_array_equal(
            w[:, :kk].numpy(), np.take_along_axis(scores.numpy(), want, 1))
    assert (w[:, kk:] == (-1e30 if return_raw else 0.0)).all()
    assert (idx[:, kk:] == 0).all()


@pytest.mark.parametrize("top_k", [257, M])
def test_radix_rows_empty_bank(top_k):
    """No valid token: every slot -1e30 and id 0, and every weight
    1 / top_k, as the plain softmax of the -1e30 scores gives."""
    mk, qk = _bank("fp32")
    keys, _ = _keys(mk, qk)
    raw, idx = radix_rows(keys, 0, top_k, return_raw=True)
    w, _ = radix_rows(keys, 0, top_k)
    assert (raw == -1e30).all() and (idx == 0).all()
    assert torch.equal(w, mem.softmax_weights(raw))
    torch.testing.assert_close(w, torch.full_like(w, 1 / top_k), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "integer"])
@pytest.mark.parametrize("top_k", [257, 1000])
@pytest.mark.parametrize("valid", [M, 250])
def test_radix_rows_match_jax(kind, top_k, valid):
    """The row statement against the JAX ``memory_affinity_topk`` (its own
    scores): weights within 1e-6, ids equal but at near-ties (everywhere
    on integer keys), the dead slots weighing 0 on both sides."""
    mk, qk = _bank(kind)
    keys, _ = _keys(mk, qk)
    w, idx = radix_rows(keys, valid, top_k)
    jw, jidx = jx_mem.memory_affinity_topk(jnp.asarray(mk), jnp.asarray(qk),
                                           top_k, valid)
    jw, jidx = np.asarray(jw), np.asarray(jidx)
    jvals = np.take_along_axis(np.asarray(jx_mem._scores(
        jnp.asarray(mk), jnp.asarray(qk), valid)), jidx, 1)
    kk = min(top_k, valid)
    if kind == "integer":
        np.testing.assert_array_equal(idx[:, :kk].numpy(), jidx[:, :kk])
    _assert_near(idx[:, :kk].numpy(), jidx[:, :kk], jvals[:, :kk])
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(w[:, kk:].numpy(), 0.0)
    np.testing.assert_array_equal(jw[:, kk:], 0.0)


def _assert_near(idx, jidx, jvals):
    """ids equal except where the JAX scores of neighbouring slots lie
    within 1e-4."""
    close = np.abs(np.diff(jvals, axis=1)) <= 1e-4
    tied = np.zeros_like(idx, dtype=bool)
    tied[:, :-1] |= close
    tied[:, 1:] |= close
    assert not ((idx != jidx) & ~tied).any()


@pytest.mark.parametrize("method", ["iterative", "grid", "sort"])
@pytest.mark.parametrize("top_k", [257, 300])
@pytest.mark.parametrize("return_raw", [False, True])
@pytest.mark.parametrize("kind", ["fp32", "integer"])
def test_row_methods_match_pallas(method, top_k, return_raw, kind):
    """``select_topk(method=m)`` (on the CPU its plain version) against the
    JAX kernel of the same method in interpret mode above 256, with a fill
    of 1,000 of the 1,024 tokens (two bank blocks of 512)."""
    mk, qk = _bank(kind, seed=top_k)
    valid = 1000
    w, idx = select_topk(torch.from_numpy(mk), torch.from_numpy(qk), top_k,
                         valid, method=method, return_raw=return_raw)
    jw, jidx = pallas_memory_topk(
        jnp.asarray(mk), jnp.asarray(qk), top_k, valid, block_q=32,
        block_m=512, interpret=True, method=method, return_raw=return_raw)
    jw, jidx = np.asarray(jw), np.asarray(jidx)
    assert w.shape == idx.shape == (N, top_k) and idx.dtype == torch.int32
    jvals = np.take_along_axis(np.asarray(jx_mem._scores(
        jnp.asarray(mk), jnp.asarray(qk), valid)), jidx, 1)
    if kind == "integer":
        np.testing.assert_array_equal(idx.numpy(), jidx)
    _assert_near(idx.numpy(), jidx, jvals)
    # raw scores of magnitude ~10 a few fp32 ulps apart; weights <= 1
    np.testing.assert_allclose(w.numpy(), jw, rtol=0,
                               atol=1e-4 if return_raw else 1e-6)


READ_N, READ_CV = 32, 64

READ_CONFIGS = {
    "resident": dict(strategy="fused",
                     kernel_cfg=KernelConfig(sel_method="resident")),
    "chunked_chunked": dict(strategy="fused", kernel_cfg=KernelConfig(
        sel_method="chunked", readout_method="chunked")),
    "select": dict(strategy="select"),
}


@pytest.mark.parametrize("read", sorted(READ_CONFIGS))
@pytest.mark.parametrize("valid", [None, 250])
def test_memory_readout_methods_match_jax(read, valid):
    """The port's reads on the other kernels (on the CPU their plain
    versions) at top_k 300 against the JAX 'scatter' read."""
    rng = np.random.default_rng(5)
    mk = rng.standard_normal((M, CK)).astype(np.float32)
    qk = rng.standard_normal((READ_N, CK)).astype(np.float32)
    mv = rng.standard_normal((2, M, READ_CV)).astype(np.float32)
    got = mem.memory_readout(torch.from_numpy(mk), torch.from_numpy(qk),
                             torch.from_numpy(mv), 300, valid,
                             **READ_CONFIGS[read])
    want = jx_mem.memory_readout(jnp.asarray(mk), jnp.asarray(qk),
                                 jnp.asarray(mv), 300, valid,
                                 strategy="scatter")
    assert got.shape == (2, READ_N, READ_CV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# (d): each wrapper above 256 on tensors off the CPU reaches the radix
# route for itself (its launch count and pad), with its output layout
ROUTES = [
    ("tournament", MT.topk_select, {}, None),
    ("chunked", MT.topk_select_chunked, {"no_skip": True}, None),
    ("resident", MT.topk_select_resident, {}, None),
    ("grid", MT.topk_select_grid, {}, False),
    ("iterative", MT.topk_select_iter, {"return_raw": True}, True),
    ("sort", MT.topk_select_sort, {}, False),
]


@pytest.mark.parametrize("name,wrapper,kw,rows", ROUTES,
                         ids=[r[0] for r in ROUTES])
@pytest.mark.parametrize("top_k", [256, 257, 2048])
def test_selections_route_above_256(monkeypatch, name, wrapper, kw, rows,
                                    top_k):
    """Above PRUNED_MAX_K every selection calls the radix route with itself
    as the wrapper that counts, and the row selections ask for rows
    (weights, or raw with ``return_raw``); at 256 none does."""
    calls = []

    def radix(counted, qk, mk, valid, k, escalations=None, scorings=None,
              return_raw=None):
        calls.append((counted, k, return_raw))
        return "radix"

    monkeypatch.setattr(MT, "_topk_select_radix", radix)
    qk = torch.empty((8, CK), device="meta")
    if top_k > MT.PRUNED_MAX_K:
        assert wrapper(qk, qk, 100, top_k, **kw) == "radix"
        assert calls == [(wrapper, top_k, rows)]
    else:  # the k <= 256 design checks its operands: not on a card
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(qk, qk, 100, top_k, **kw)
        assert calls == []


@pytest.mark.parametrize("top_k", [256, 257, 2048])
def test_chunked_readout_routes_above_256(monkeypatch, top_k):
    """Above PRUNED_MAX_K slots the chunked readout launches the large-k
    kernel through ``_readout``, counted as itself (with no counts to
    keep when no ``staged_rows`` is asked for); at 256 its own stage."""
    calls = []

    def readout(counted, mv, vals, idx, counts):
        calls.append((counted, counts))
        return "large_k"

    monkeypatch.setattr(R, "_readout", readout)
    mv = torch.empty((1, 64, 8), device="meta")
    vals = torch.empty((top_k, 4), device="meta")
    if top_k > MT.PRUNED_MAX_K:
        out = R.topk_readout_chunked(mv, vals, vals, no_skip=True)
        assert out == "large_k"
        assert calls == [(R.topk_readout_chunked, None)]
    else:
        with pytest.raises(ValueError, match="CUDA"):
            R.topk_readout_chunked(mv, vals, vals)
        assert calls == []


@pytest.mark.slow
@pytest.mark.parametrize("method", ["chunked", "resident"])
def test_transposed_methods_match_pallas(method):
    """The JAX newest-first and resident selections at top_k 300 in
    interpret mode against the port's plain selection."""
    mk, qk = _bank("fp32", seed=4)
    valid = 1000
    vals, idx = topk_select_plain(torch.from_numpy(qk), torch.from_numpy(mk),
                                  valid, 300)
    jw, jidx = pallas_memory_topk(
        jnp.asarray(mk), jnp.asarray(qk), 300, valid, block_q=32,
        block_m=512, interpret=True, method=method)
    jidx = np.asarray(jidx)
    jvals = np.take_along_axis(np.asarray(jx_mem._scores(
        jnp.asarray(mk), jnp.asarray(qk), valid)), jidx, 1)
    _assert_near(idx.T.numpy(), jidx, jvals)
    np.testing.assert_allclose(mem.softmax_weights(vals.T).numpy(),
                               np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("sel,readout", [("chunked", "chunked"),
                                         ("resident", "grid")])
def test_pallas_fused_readout_methods_match_plain(sel, readout):
    """The JAX fused read on the other kernels at top_k 300 in interpret
    mode against the port's plain fused read."""
    rng = np.random.default_rng(2)
    mk = rng.standard_normal((M, CK)).astype(np.float32)
    qk = rng.standard_normal((64, CK)).astype(np.float32)
    mv = rng.standard_normal((1, M, 128)).astype(np.float32)
    want = pallas_fused_readout(
        jnp.asarray(mk), jnp.asarray(qk), jnp.asarray(mv), 300, block_q=32,
        block_m=512, sel_block_q=32, sel_block_m=512, interpret=True,
        kcfg=JxKernelConfig(sel_method=sel, readout_method=readout))
    got = fused_readout_plain(torch.from_numpy(mk), torch.from_numpy(qk),
                              torch.from_numpy(mv), 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
