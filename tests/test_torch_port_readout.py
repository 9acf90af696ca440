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

Tolerances: fp32 readouts rtol 1e-5 / atol 1e-6 (the sums in another order,
as ``tests/test_fused_readout.py``); bf16 2e-2 (bf16 values, as there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels.config import KernelConfig as JxKernelConfig
from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout

from eva_vos_tpu_torch.kernels.memory_readout import (READOUT_CHUNK,
                                                      readout_chunks,
                                                      readout_geometry,
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
