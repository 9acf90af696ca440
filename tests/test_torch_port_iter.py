"""The iterative selection (select_topk's default) as the resident walk with
a row epilogue, on the CPU.

``memory_topk_iter.cu`` runs the walk of ``csrc/resident_walk.cuh`` (query
tiles walking their bank segment newest first with a running k-th key per
query and candidate buffers compacted in waves) and writes rows: with one
segment each warp its queries' sorted keys, softmax included; with several,
the row-output stage's merge of the segments' sorted lists.  Its plain
statement, ``resident_rows`` (``resident_lists``, then per query the top k
of the segments' lists, unpacked, and the softmax), is held here to the JAX
package's default selection, ``pallas_memory_topk`` with no method (the
iterative kernel, in interpret mode), on the same numpy inputs: ids equal on
the live slots, weights within rtol 1e-5 in fp32 (two fp32 score sums in
another order, a few ulps apart) and 2e-2 in bf16 (as
``tests/test_torch_port_kernel_variants.py``).  The bf16 inputs lie on a
grid of quarters in [-4, 4], exact in bf16, so that every score is exact in
fp32 in any summation order: two sums of the same products in another order
may otherwise swap a near-tie, which at top_k = 256 happens on random keys.
The cases: fills below top_k, identical keys (every score tied), fp32 and
bf16, top_k 1, 50 and 256, one segment and several.  It is also held to the
plain selection exactly (the same fp32 scores), raw scores included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels.memory_topk import pallas_memory_topk

from eva_vos_tpu_torch.kernels import select_topk
from eva_vos_tpu_torch.kernels.memory_topk import (ITER_MERGE_KEYS,
                                                   ITER_SEGMENT,
                                                   RESIDENT_STEP,
                                                   cut_threshold,
                                                   iter_segments,
                                                   resident_lists,
                                                   resident_rows,
                                                   resident_segments,
                                                   sort_keys)
from eva_vos_tpu_torch.ops.memory_attention import (_scores,
                                                    memory_affinity_topk,
                                                    topk_scores)


def _bank(kind: str, n: int, m: int, seed: int, quarters: bool = False):
    """(qk [n, 64], mk [m, 64]) fp32 from numpy: iid keys, or one key over
    the whole bank (every score of a query tied); with ``quarters`` rounded
    to multiples of 1/4 in [-4, 4]."""
    rng = np.random.default_rng(seed)
    qk = rng.standard_normal((n, 64))
    if kind == "random":
        mk = rng.standard_normal((m, 64))
    elif kind == "ties":
        mk = np.tile(rng.standard_normal((1, 64)), (m, 1))
    else:
        raise ValueError(kind)
    if quarters:
        qk, mk = (np.clip(np.round(4 * x) / 4, -4, 4) for x in (qk, mk))
    return qk.astype(np.float32), mk.astype(np.float32)


def _rows(qk, mk, valid: int, top_k: int, segments: int, raw=False):
    """resident_rows over the plain version's fp32 scores of the torch
    tensors qk, mk (the kernel's keys, dead past ``valid``)."""
    ids = torch.arange(mk.shape[0]).expand(qk.shape[0], -1)
    keys = sort_keys(_scores(mk, qk, valid), ids, ids < valid)
    return resident_rows(keys, valid, top_k, segments, return_raw=raw)


CASES = [  # (kind, valid, top_k, segments): M = 2,048, N = 40
    ("random", 1500, 50, 1), ("random", 1500, 50, 3), ("random", 2048, 1, 2),
    ("random", 20, 50, 1), ("random", 2000, 256, 1), ("random", 2000, 256, 4),
    ("random", 200, 256, 2), ("ties", 1990, 50, 2), ("ties", 1990, 256, 1),
    ("ties", 30, 50, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,valid,top_k,segments", CASES)
def test_iter_rows_match_the_jax_default_selection(kind, valid, top_k,
                                                   segments, dtype):
    qk, mk = _bank(kind, 40, 2048, valid + top_k, dtype == "bfloat16")
    tq = torch.from_numpy(qk).to(getattr(torch, dtype))
    tm = torch.from_numpy(mk).to(getattr(torch, dtype))
    w, idx, _ = _rows(tq, tm, valid, top_k, segments)
    jdt = getattr(jnp, dtype)
    ref_w, ref_i = pallas_memory_topk(
        jnp.asarray(mk, jdt), jnp.asarray(qk, jdt), top_k, valid, block_q=8,
        block_m=512, interpret=True)
    assert w.shape == idx.shape == (40, top_k) and idx.dtype == torch.int32
    live = min(valid, top_k)
    np.testing.assert_array_equal(idx.numpy()[:, :live],
                                  np.asarray(ref_i)[:, :live])
    rtol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=rtol,
                               atol=1e-6)
    assert (w[:, live:] == 0).all() and (idx[:, live:] == 0).all()
    if kind == "ties":  # every score tied: the lowest ids, in order
        assert torch.equal(idx[:, :live],
                           torch.arange(live, dtype=torch.int32).expand(40, -1))


@pytest.mark.parametrize("kind,valid,top_k,segments", CASES)
def test_iter_rows_are_the_plain_selection(kind, valid, top_k, segments):
    """The same fp32 scores: weights and raw scores equal the plain
    version's bit for bit on the live slots, -1e30 past them."""
    qk, mk = (torch.from_numpy(x) for x in _bank(kind, 40, 2048, 5))
    w, idx, _ = _rows(qk, mk, valid, top_k, segments)
    vals, raw_idx, _ = _rows(qk, mk, valid, top_k, segments, raw=True)
    live = min(valid, top_k)
    pv, pi = topk_scores(mk, qk, top_k, valid)
    pw, _ = memory_affinity_topk(mk, qk, top_k, valid)
    assert torch.equal(idx, raw_idx)
    assert torch.equal(idx[:, :live], pi[:, :live].to(torch.int32))
    assert torch.equal(vals[:, :live], pv[:, :live])
    assert (vals[:, live:] == -1e30).all()
    torch.testing.assert_close(w, pw, rtol=1e-6, atol=1e-7)
    # select_topk on CPU tensors: the plain version, the same selection
    sw, si = select_topk(mk, qk, top_k, valid)
    assert torch.equal(si[:, :live], idx[:, :live])
    torch.testing.assert_close(sw, w, rtol=1e-6, atol=1e-7)


def test_iter_rows_count_the_walks_compactions():
    """resident_rows' compactions are resident_lists' for the same walk:
    the count the card's test holds the kernel to."""
    qk, mk = (torch.from_numpy(x) for x in _bank("random", 70, 2048, 9))
    ids = torch.arange(2048).expand(70, -1)
    keys = sort_keys(_scores(mk, qk, 2000), ids, ids < 2000)
    _, _, got = resident_rows(keys, 2000, 16, 3)
    _, want = resident_lists(keys, 2000, 16, 3)
    assert got == want > 0


@pytest.mark.parametrize("n,valid,top_k,want", [
    (8100, 72 * 1620, 50, 1),     # 127 tiles fill the card
    (8100, 1620, 50, 1),
    (1620, 1620, 50, 5),          # one frame: five segments of 2-3 steps
    (1620, 12 * 1620, 50, 5),     # the resident selection's rule
    (1620, 72 * 1620, 256, 2),    # 51 tiles of 32 queries
    (1620, 300, 50, 2),           # no more segments than live units
    (64, 3000, 50, 10),           # no more lists than the merge takes
    (64, 3000, 200, 2),
    (64, 0, 16, 1)])              # an empty bank still writes its rows
def test_iter_segment_rule(n, valid, top_k, want):
    got = iter_segments(n, valid, top_k, 132)
    assert got == want
    assert got <= max(1, -(-valid // RESIDENT_STEP))  # a step a segment
    assert got == 1 or got * top_k <= ITER_MERGE_KEYS
    if valid >= 5 * 2048:
        assert got == resident_segments(n, valid, top_k, 132)
    assert ITER_SEGMENT % RESIDENT_STEP == 0


@pytest.mark.parametrize("kind", ["random", "close", "tied", "one_score"])
@pytest.mark.parametrize("count,top_k", [(2, 1), (64, 50), (256, 50),
                                         (251, 250), (384, 256), (512, 256)])
def test_cut_finds_the_kth_key(kind, count, top_k):
    """The kernel's cut of a buffer (bisection on the score bits, then on
    the keys tied there) finds its top_k-th key on scores spread wide,
    close together (a buffer above a threshold), tied in small groups, and
    all one score (every key tied: the ids decide), in at most 64 rounds."""
    rng = np.random.default_rng(count + top_k)
    scores = {"random": rng.standard_normal(count) * 30,
              "close": 7 + 1e-3 * rng.random(count),
              "tied": rng.integers(0, 5, count).astype(np.float64),
              "one_score": np.full(count, -2.5)}[kind]
    ids = torch.from_numpy(rng.permutation(100000)[:count])
    keys = sort_keys(torch.from_numpy(scores.astype(np.float32)), ids,
                     torch.ones(count, dtype=torch.bool))
    kth, rounds = cut_threshold(keys, top_k)
    assert kth == int(keys.topk(top_k).values[-1])
    assert int((keys >= kth).sum()) == top_k and rounds <= 64
    if kind == "close":  # scores within 1e-3: fewer rounds on their bits
        assert rounds < 32
