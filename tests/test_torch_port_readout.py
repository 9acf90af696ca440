"""The readout stage's plan, on the CPU.

Both readout kernels (``memory_readout.cu`` and ``memory_readout_chunked.cu``)
run one device stage, ``csrc/readout_common.cuh``: a tile of queries stages
each distinct selected row once, in ascending id order, chunk by chunk of
the bank (every chunk with ``no_skip``), and every query sums its hits in
ascending id order.  Its plain statement, ``readout_stage_plain``, is held
here to the plain readout (``topk_readout_plain``) and to the JAX
``pallas_fused_readout`` in interpret mode with both ``readout_method``s,
on the same numpy inputs; its staged-row count to a numpy count of each
tile's distinct ids of weight > 0 (the count the card's tests hold the
kernels to), and its chunk walk to the chunks that hold those ids (every
chunk of the bank with ``no_skip``, for the same output bit for bit).

Above 256 slots the default readout runs its large-k kernel, whose plan
``readout_large_k_plain`` states: each 64- or 32-query tile sums densely,
sparsely or as a direct gather by its sharing (``large_k_tiles``).  It is
held to the plain readout and to the JAX ``memory_readout`` at top_k 300
and 1,000 (valid 250 and all, K = 1 and 2, CV 64, bf16 and fp32), its rows
staged to ``readout_staged_rows`` over its staged tiles, and its branches to
their rules on banks that take each of them.

Tolerances: fp32 readouts rtol 1e-5 / atol 1e-6 (the sums in another order,
as ``tests/test_fused_readout.py``), atol 1e-5 above 256 (as
``tests/test_torch_port_large_k.py``); bf16 2e-2 (bf16 values, as there).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels.config import KernelConfig as JxKernelConfig
from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout
from eva_vos_tpu.ops import memory_attention as jx_mem

from eva_vos_tpu_torch.kernels.memory_readout import (LARGE_K_MAX_ROWS,
                                                      LARGE_K_NEAR,
                                                      LARGE_K_ROWS,
                                                      LARGE_K_SHARE,
                                                      LARGE_K_SHARE_FAR,
                                                      LARGE_K_WINDOW,
                                                      READOUT_CHUNK,
                                                      large_k_geometry,
                                                      large_k_tiles,
                                                      readout_chunks,
                                                      readout_geometry,
                                                      readout_large_k_plain,
                                                      readout_picks,
                                                      readout_stage_plain,
                                                      readout_staged_rows,
                                                      topk_readout_plain)
from eva_vos_tpu_torch.kernels.memory_topk import topk_select_plain


def _inputs(kind, m, n, ck, cv, k_obj, seed):
    """(mk [m, ck], qk [n, ck], mv [k_obj, m, cv]) fp32 from numpy.
    clustered: every token a query key plus noise, so neighbouring queries
    pick shared rows; ties: every key eight times over (exact score ties)."""
    rng = np.random.default_rng(seed)
    qk = rng.standard_normal((n, ck))
    if kind == "clustered":
        mk = qk[np.arange(m) % n] + 0.05 * rng.standard_normal((m, ck))
    elif kind == "ties":
        mk = np.tile(rng.standard_normal((m // 8, ck)), (8, 1))
    else:
        mk = rng.standard_normal((m, ck))
    mv = rng.standard_normal((k_obj, m, cv))
    return (mk.astype(np.float32), qk.astype(np.float32),
            mv.astype(np.float32))


def _numpy_plan(vals, idx, m, queries):
    """(rows staged for one object, chunks walked without and with the
    skip): each tile's distinct ids of weight > 0, and the chunks they lie
    in (every chunk of [0, m) with no_skip)."""
    vals, idx = vals.numpy(), idx.numpy()
    live = np.exp(vals - vals[:1]) > 0
    rows = chunks = tiles = 0
    for q0 in range(0, idx.shape[1], queries):
        ids = np.unique(idx[:, q0:q0 + queries][live[:, q0:q0 + queries]])
        rows += ids.size
        chunks += np.unique(ids // READOUT_CHUNK).size
        tiles += 1
    return rows, chunks, tiles * -(-m // READOUT_CHUNK)


def _check_plan(mv, vals, idx, queries):
    """The plan against the plain readout and the numpy plan, with and
    without the skip; returns the plan's output."""
    k_obj, m, _ = mv.shape
    rows, chunks, all_chunks = _numpy_plan(vals, idx, m, queries)
    out, staged, walked = readout_stage_plain(mv, vals, idx, queries)
    assert staged == k_obj * rows == readout_staged_rows(vals, idx, k_obj,
                                                         queries)
    assert walked == chunks
    out_ns, staged_ns, walked_ns = readout_stage_plain(mv, vals, idx, queries,
                                                       no_skip=True)
    assert torch.equal(out_ns, out) and staged_ns == staged
    assert walked_ns == all_chunks
    ref = topk_readout_plain(mv, vals, idx)
    if mv.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
    return out


# tests/test_fused_readout.py's cases, (m, n, ck, cv, top_k, valid, k_obj,
# bank, dtype, block_q, block_m), and a clustered bank at top_k = 50
JAX_CASES = {
    "oracle_k1": (512, 64, 16, 32, 8, None, 1, "random", "f32", 32, 128),
    "oracle_k2": (512, 64, 16, 32, 8, None, 2, "random", "f32", 32, 128),
    "valid_tokens": (256, 16, 8, 24, 5, 100, 1, "random", "f32", 16, 64),
    "fewer_valid_than_topk": (128, 8, 8, 16, 16, 9, 1, "random", "f32", 8,
                              64),
    "ties_at_threshold": (64, 4, 8, 8, 4, None, 1, "ties", "f32", 4, 32),
    "padding_of_n": (128, 37, 8, 16, 4, None, 1, "random", "f32", 16, 64),
    "bf16": (512, 32, 16, 32, 8, None, 1, "random", "bf16", 32, 128),
    "clustered_k50": (2048, 100, 16, 64, 50, 1900, 2, "clustered", "f32",
                      32, 128),
}


@pytest.mark.parametrize("method", ["grid", "chunked"])
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_plan_matches_pallas_fused_readout(case, method):
    (m, n, ck, cv, top_k, valid, k_obj, bank, dtype, block_q,
     block_m) = JAX_CASES[case]
    mk, qk, mv = _inputs(bank, m, n, ck, cv, k_obj, seed=m + n)
    if dtype == "bf16":
        jx = [jnp.asarray(x, jnp.bfloat16) for x in (mk, qk, mv)]
        ours = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                for x in jx]
        tol = dict(rtol=2e-2, atol=2e-2)
    else:
        jx = [jnp.asarray(x) for x in (mk, qk, mv)]
        ours = [torch.from_numpy(x) for x in (mk, qk, mv)]
        tol = dict(rtol=1e-5, atol=1e-6)
    ref = pallas_fused_readout(
        *jx, top_k=top_k, valid_tokens=valid, block_q=block_q,
        block_m=block_m, interpret=True,
        kcfg=JxKernelConfig(readout_method=method))
    vals, idx = topk_select_plain(ours[1], ours[0], valid, top_k)
    queries = readout_geometry(n, k_obj, cv, ours[2].element_size(),
                               top_k)[0]
    out = _check_plan(ours[2], vals, idx, queries)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# (bank, m, n, cv, top_k, valid, k_obj, dtype): N = 1 and N not a multiple
# of a tile; K = 1 and 2; CV 8, 64, 512 and 1,024 in bf16 and 512 in fp32;
# top_k 1, 50 and 256; random and clustered banks; fewer valid tokens than
# top_k; a bank of several chunks
PLAN_CASES = [
    ("random", 3000, 300, 512, 50, 2500, 1, torch.bfloat16),
    ("clustered", 3000, 300, 512, 50, 2500, 2, torch.bfloat16),
    ("random", 3000, 1, 512, 50, 2500, 1, torch.bfloat16),
    ("clustered", 3000, 130, 64, 50, 3000, 1, torch.float32),
    ("random", 3000, 130, 64, 50, 20, 2, torch.float32),
    ("random", 512, 77, 8, 1, 512, 1, torch.bfloat16),
    ("clustered", 5000, 100, 1024, 256, 4000, 1, torch.bfloat16),
    ("random", 5000, 100, 512, 256, 4000, 2, torch.float32),
    ("clustered", 5000, 200, 512, 100, 5000, 1, torch.float32),
    ("ties", 640, 100, 64, 16, 640, 1, torch.float32),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_matches_plain_readout(case):
    bank, m, n, cv, top_k, valid, k_obj, dtype = case
    mk, qk, mv = _inputs(bank, m, n, 64, cv, k_obj, seed=n + cv + top_k)
    mk, qk = torch.from_numpy(mk), torch.from_numpy(qk)
    mv = torch.from_numpy(mv).to(dtype)
    vals, idx = topk_select_plain(qk, mk, valid, top_k)
    queries = readout_geometry(n, k_obj, cv, mv.element_size(), top_k)[0]
    _check_plan(mv, vals, idx, queries)


def test_plan_sums_each_query_in_ascending_id_order():
    """readout_picks sorts a query's picks by (id, slot) and gives a pick
    of weight 0 no row; the weights' sum is the softmax denominator."""
    vals = torch.tensor([[3.0, 1.0], [2.0, -1e30], [1.0, -1e30]])
    idx = torch.tensor([[7, 4], [2, 0], [7, 0]], dtype=torch.int32)
    ids, w, z = readout_picks(vals, idx)
    assert ids[:, 0].tolist() == [2, 7, 7]
    assert ids[0, 1] == 4 and bool((ids[1:, 1] > 2 ** 30).all())
    e = np.exp(np.float32([0.0, -1.0, -2.0]))
    torch.testing.assert_close(w[:, 0], torch.from_numpy(e[[1, 0, 2]]))
    torch.testing.assert_close(z, torch.tensor([e.sum(), 1.0]))


def test_chunk_walk_skips_empty_chunks():
    rows = torch.tensor([5, 1023, 1024, 5000])
    assert readout_chunks(rows, 6000, no_skip=False) == [0, 1, 4]
    assert readout_chunks(rows, 6000, no_skip=True) == list(range(6))
    assert readout_chunks(rows[:0], 2048, no_skip=False) == []


@pytest.mark.parametrize("n,n_obj,cv,itemsize,top_k,want", [
    (8100, 1, 512, 2, 50, (64, 1)),   # a blocked step: 127 blocks
    (1620, 1, 512, 2, 50, (32, 2)),   # a single-frame step: 102 blocks
    (8100, 2, 512, 2, 50, (64, 1)),
    (8100, 1, 512, 2, 100, (32, 1)),  # top_k > 64: 32-query tiles
    (8100, 1, 512, 4, 50, (64, 2)),   # 2 KB rows: two 1 KB slices
    (300, 1, 1024, 2, 256, (32, 8)),
    (1, 1, 8, 2, 1, (32, 1)),
])
def test_readout_geometry(n, n_obj, cv, itemsize, top_k, want):
    queries, slices = readout_geometry(n, n_obj, cv, itemsize, top_k)
    assert (queries, slices) == want
    vecs = cv * itemsize // 16
    assert 1 <= slices <= vecs and -(-vecs // slices) <= 64


LARGE_M, LARGE_N = 20000, 200  # a random bank; three full tiles and one of 8


@functools.lru_cache(maxsize=None)
def _large_k_inputs(dtype: str):
    """(mk, qk, mv [2, M, 64]) from numpy, fp32 or rounded to bf16."""
    mk, qk, mv = _inputs("random", LARGE_M, LARGE_N, 64, 64, 2, seed=7)
    if dtype == "bf16":
        mk, qk, mv = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                      for x in (mk, qk, mv))
    return mk, qk, mv


def _staged_over_tiles(vals, idx, k_obj, queries, tiles):
    """readout_staged_rows summed over the tiles that stage their rows."""
    return sum(readout_staged_rows(vals[:, i * queries:(i + 1) * queries],
                                   idx[:, i * queries:(i + 1) * queries],
                                   k_obj, queries)
               for i, t in enumerate(tiles) if t[0] != "direct")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k_obj", [1, 2])
@pytest.mark.parametrize("valid", [250, None])
@pytest.mark.parametrize("top_k", [300, 1000])
def test_large_k_plan_matches_readouts(top_k, valid, k_obj, dtype):
    """The large-k plan against the plain readout and the JAX
    ``memory_readout``; its rows staged against ``readout_staged_rows`` and
    its dense stages against its tiles."""
    mk, qk, mv = _large_k_inputs(dtype)
    mv = mv[:k_obj]
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    mv_t = torch.from_numpy(mv).to(tdt)
    vals, idx = topk_select_plain(torch.from_numpy(qk), torch.from_numpy(mk),
                                  valid, top_k)
    queries = large_k_geometry(LARGE_N, k_obj, 64, mv_t.element_size())[0]
    out, staged, dense = readout_large_k_plain(mv_t, vals, idx, queries)
    tiles = large_k_tiles(vals, idx, queries, 64 * mv_t.element_size(),
                          dtype == "bf16")
    assert staged == _staged_over_tiles(vals, idx, k_obj, queries, tiles)
    assert dense == k_obj * sum(-(-rows // LARGE_K_ROWS)
                                for mode, _, rows in tiles if mode == "dense")
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = np.asarray(jx_mem.memory_readout(
        jnp.asarray(mk, jdt), jnp.asarray(qk, jdt), jnp.asarray(mv, jdt),
        top_k, valid, strategy="gather"), np.float32)
    ref = topk_readout_plain(mv_t, vals, idx)
    if dtype == "bf16":
        tol = dict(rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
    else:
        tol = dict(rtol=0, atol=1e-5)
        torch.testing.assert_close(out, ref, **tol)
    np.testing.assert_allclose(out.float().numpy(), want, **tol)


@pytest.mark.parametrize("bank,m,top_k,want", [
    ("clustered", 1600, 512, "dense"),   # each query picks a third of M
    ("random", 4000, 300, "sparse"),     # ~5.5 picks a distinct row
    ("random", 100000, 300, "direct"),   # ~1.2 picks a distinct row
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_large_k_branches(bank, m, top_k, want, dtype):
    """Each branch where its rule sends a tile (fp32 has no dense branch:
    sparse there), and its output against the plain readout."""
    mk, qk, mv = _inputs(bank, m, 64, 16, 8, 1, seed=m + top_k)
    mv = torch.from_numpy(mv).to(dtype)
    vals, idx = topk_select_plain(torch.from_numpy(qk), torch.from_numpy(mk),
                                  None, top_k)
    tiles = large_k_tiles(vals, idx, 64, 8 * mv.element_size(),
                          dtype == torch.bfloat16)
    if want == "dense" and dtype == torch.float32:
        want = "sparse"
    assert {t[0] for t in tiles} == {want}
    out, staged, dense = readout_large_k_plain(mv, vals, idx, 64)
    assert (staged > 0) == (want != "direct") and (dense > 0) == (
        want == "dense")
    _assert_large_k_close(out, topk_readout_plain(mv, vals, idx))


def _assert_large_k_close(out, ref):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)


def _shared_selection(ids: np.ndarray, n: int, seed: int):
    """Every one of n queries picks the same ``ids`` (each query in its own
    order, descending random scores): vals/idx [len(ids), n]."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(ids) for _ in range(n)], 1)
    vals = -np.sort(-3 * rng.standard_normal(idx.shape), axis=0)
    return (torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(idx.astype(np.int32)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_large_k_window_and_row_cap(dtype):
    """A tile whose rows would be dense goes direct when one of its ids lies
    past LARGE_K_WINDOW; a tile that would be sparse goes direct when it has
    more than LARGE_K_MAX_ROWS rows."""
    staged = "dense" if dtype == torch.bfloat16 else "sparse"
    bf16 = dtype == torch.bfloat16
    for lo, want in ((LARGE_K_WINDOW - 600, staged),
                     (LARGE_K_WINDOW - 256, "direct")):
        vals, idx = _shared_selection(np.arange(lo, lo + 512), 64, lo)
        assert [t[0] for t in large_k_tiles(vals, idx, 64, 16, bf16)] == [
            want]
        mv = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, LARGE_K_WINDOW + 256, 8)).astype(np.float32)).to(dtype)
        out, staged_rows, _ = readout_large_k_plain(mv, vals, idx, 64)
        assert (staged_rows == 512) == (want != "direct")
        _assert_large_k_close(out, topk_readout_plain(mv, vals, idx))
    # 64 queries, LARGE_K_SHARE of them on each row: sparse up to
    # LARGE_K_MAX_ROWS rows
    rng = np.random.default_rng(2)
    for rows, want in ((LARGE_K_MAX_ROWS - 32, "sparse"),
                       (LARGE_K_MAX_ROWS + 32, "direct")):
        picks = np.concatenate([rng.permutation(rows)
                                for _ in range(LARGE_K_SHARE)])
        idx = torch.from_numpy(picks.reshape(64, -1).T.astype(np.int32).copy())
        vals = torch.from_numpy(-np.sort(-rng.standard_normal(
            idx.shape), axis=0).astype(np.float32))
        assert large_k_tiles(vals, idx, 64, 16, bf16) == [
            (want, LARGE_K_SHARE * rows, rows)]


@pytest.mark.parametrize("stride,row_bytes,want", [
    (1, 1024, "direct"),     # 1,024 ids, 1 MB of rows: L2 holds them
    (100, 1024, "sparse"),   # 102,400 ids, 100 MB: the far cut
    (100, 16, "direct"),     # the same ids, 1.6 MB
])
def test_large_k_span_sets_the_share(stride, row_bytes, want):
    """Three picks a row: staged only when the tile's ids span more than
    LARGE_K_NEAR bytes of rows (LARGE_K_SHARE_FAR = 2 <= 3 < LARGE_K_SHARE)."""
    assert LARGE_K_SHARE_FAR <= 3 < LARGE_K_SHARE
    rng = np.random.default_rng(3)
    picks = np.concatenate([rng.permutation(1024) * stride for _ in range(3)])
    idx = torch.from_numpy(picks.reshape(64, -1).T.astype(np.int32).copy())
    vals = torch.from_numpy(-np.sort(-rng.standard_normal(
        idx.shape), axis=0).astype(np.float32))
    assert large_k_tiles(vals, idx, 64, row_bytes, True) == [
        (want, 3 * 1024, 1024)]


@pytest.mark.parametrize("n,n_obj,cv,itemsize,want", [
    (8100, 1, 512, 2, (64, 1)),   # phase 6c: 127 blocks
    (8100, 1, 512, 4, (64, 2)),   # fp32: two 1 KB slices
    (1620, 1, 512, 2, (32, 2)),   # 51 tiles: 32-query tiles, two slices
    (200, 2, 64, 2, (32, 1)),
])
def test_large_k_geometry(n, n_obj, cv, itemsize, want):
    assert large_k_geometry(n, n_obj, cv, itemsize) == want
