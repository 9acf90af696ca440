"""The resident selection's walk, on the CPU.

``memory_topk_resident.cu`` gives each tile of 64 queries (32 for
top_k > 128) a segment of the bank, walks it newest first in 128-token
steps, admits every key above the query's running threshold into a
candidate buffer, and compacts a buffer that could overflow in the next
step to its top k, whose k-th key becomes the threshold.  Its plain
statement, ``resident_lists``, is held here to the plain selection
(``topk_select_plain``, exactly: the same fp32 scores) and to the JAX
resident kernel (``resident_topk_t`` in interpret mode, ids exactly), on
the same numpy inputs.  The banks: iid and clustered keys, identical keys,
scores that rise in the walking order (every key is admitted: the most
compactions), fewer valid tokens than top_k, fills that end mid-step, and
several segments (merged by ``merge_lists_t``, as the kernel's segments
are by the default selection's merge).  The compaction counts that the
card's test holds the kernel to come from the same function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels.memory_topk import pallas_memory_topk

from eva_vos_tpu_torch.kernels.memory_topk import (DEAD_KEY, RESIDENT_STEP,
                                                   merge_lists_t,
                                                   resident_geometry,
                                                   resident_lists,
                                                   resident_segments,
                                                   sort_keys,
                                                   topk_select_plain)
from eva_vos_tpu_torch.ops.memory_attention import _scores


def _bank(kind: str, n: int, m: int, seed: int):
    """(qk [n, 64], mk [m, 64]) fp32 from numpy.  clustered: every token a
    query key plus noise; ties: one key over the whole bank; rising: keys
    c v with c rising along the bank and queries q with q . v <= 0, so
    that the scores (2 c q.v - 64 c^2) / 8 fall along the bank and rise in
    the walking order (newest first), ties by id rising too."""
    rng = np.random.default_rng(seed)
    qk = rng.standard_normal((n, 64))
    if kind == "random":
        mk = rng.standard_normal((m, 64))
    elif kind == "clustered":
        mk = qk[np.arange(m) % n] + 0.05 * rng.standard_normal((m, 64))
    elif kind == "ties":
        mk = np.tile(rng.standard_normal((1, 64)), (m, 1))
    elif kind == "rising":
        v = rng.choice([-1.0, 1.0], 64)
        mk = (np.arange(m) * 256 // max(m, 1))[:, None] * v
        qk = -v * rng.integers(0, 3, (n, 64))
    else:
        raise ValueError(kind)
    return (torch.from_numpy(qk.astype(np.float32)),
            torch.from_numpy(mk.astype(np.float32)))


def _keys(qk, mk, valid: int) -> torch.Tensor:
    """The kernel's keys [N, M] of the plain version's scores, dead past
    ``valid``."""
    ids = torch.arange(mk.shape[0]).expand(qk.shape[0], -1)
    return sort_keys(_scores(mk, qk, valid), ids, ids < valid)


def _walk(qk, mk, valid: int, top_k: int, segments: int):
    lists, compactions = resident_lists(_keys(qk, mk, valid), valid, top_k,
                                        segments)
    vals, idx = merge_lists_t(lists, top_k)
    return vals, idx, compactions


CASES = [  # (valid, top_k, segments)
    (3000, 50, 1), (3000, 50, 2), (2944, 1, 1), (5000, 128, 3),
    (5000, 129, 2), (5000, 256, 2), (1000, 256, 1), (20, 50, 1),
    (0, 8, 1)]


@pytest.mark.parametrize("kind", ["random", "clustered", "ties", "rising"])
@pytest.mark.parametrize("valid,top_k,segments", CASES)
def test_resident_walk_is_the_plain_selection(kind, valid, top_k, segments):
    """Every bank and geometry: the walked and merged lists are the plain
    selection's scores and ids, -1e30 and id 0 past the fill."""
    qk, mk = _bank(kind, 6, 5000, valid + top_k)
    vals, idx, _ = _walk(qk, mk, valid, top_k, segments)
    want_v, want_i = topk_select_plain(qk, mk, valid, top_k)
    live = min(valid, top_k)
    assert vals.shape == idx.shape == (top_k, 6) and idx.dtype == torch.int32
    assert torch.equal(vals[:live], want_v[:live])
    assert torch.equal(idx[:live], want_i[:live])
    assert (vals[live:] == -1e30).all() and (idx[live:] == 0).all()


@pytest.mark.parametrize("kind,valid,top_k,segments", [
    ("random", 3000, 16, 2), ("clustered", 3000, 50, 1),
    ("ties", 1990, 16, 1), ("rising", 2500, 40, 2)])
def test_resident_walk_matches_the_jax_resident_kernel(kind, valid, top_k,
                                                       segments):
    """The same numpy inputs through resident_topk_t (interpret mode):
    scores within fp32 rounding of its sums (another order), and the same
    ids except where neighbouring scores lie that close (the clustered
    bank's near copies of a query); exact ties fall to the lowest id in
    both."""
    qk, mk = _bank(kind, 8, 3000, 7)
    vals, idx, _ = _walk(qk, mk, valid, top_k, segments)
    ref_v, ref_i = pallas_memory_topk(
        jnp.asarray(mk.numpy()), jnp.asarray(qk.numpy()), top_k, valid,
        block_q=8, block_m=512, interpret=True, method="resident",
        return_raw=True)
    ref_v, ref_i = np.asarray(ref_v).T, np.asarray(ref_i).T   # [k, N]
    np.testing.assert_allclose(vals.numpy(), ref_v, rtol=1e-5, atol=1e-5)
    close = np.abs(np.diff(vals.numpy(), axis=0)) <= 1e-4
    tied = np.zeros_like(close[:1]).repeat(top_k, 0)
    tied[:-1] |= close
    tied[1:] |= close
    assert not ((idx.numpy() != ref_i) & ~tied).any()
    if kind != "clustered":
        np.testing.assert_array_equal(idx.numpy(), ref_i)


def _every_key_admitted(valid: int, top_k: int, segments: int) -> int:
    """Compactions a query makes when every key it walks is admitted (so
    that all buffers of a tile fill alike): its buffer gains each step's
    live tokens and, after a step other than the segment's last that left
    it with more than capacity - 128, is cut back to top_k."""
    cap = resident_geometry(top_k)[1]
    steps = -(-valid // RESIDENT_STEP)
    total = 0
    for s in range(segments):
        first, last = s * steps // segments, (s + 1) * steps // segments
        count = 0
        for step in reversed(range(first, last)):
            count += min(valid - step * RESIDENT_STEP, RESIDENT_STEP)
            if step > first and count > cap - RESIDENT_STEP:
                total, count = total + 1, top_k
    return total


@pytest.mark.parametrize("kind", ["rising", "ties"])
@pytest.mark.parametrize("valid,top_k,segments", [
    (3000, 50, 1), (3000, 50, 2), (5000, 256, 3), (1000, 128, 1),
    (2000, 200, 1)])
def test_keys_rising_in_walking_order_compact_at_every_fill(kind, valid,
                                                            top_k, segments):
    """Each key beats every key walked before it (rising scores, or one
    key over the bank: ties by id, walked from the highest id), so every
    key is admitted and the tile's buffers are compacted whenever they
    fill: at every step for top_k <= 128 once the first 256 keys are in,
    every other step at top_k = 256.  The most compactions a walk makes;
    exact all the same."""
    qk, mk = _bank(kind, 5, 5000, 3)
    vals, idx, compactions = _walk(qk, mk, valid, top_k, segments)
    assert compactions == 5 * _every_key_admitted(valid, top_k, segments)
    assert compactions >= 5 * (-(-valid // RESIDENT_STEP) - 4 * segments) // 2
    want_v, want_i = topk_select_plain(qk, mk, valid, top_k)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i)


def test_iid_keys_compact_a_few_times():
    """On iid keys a compaction sets the threshold to the k-th of the n_1
    tokens walked so far, which each later token beats with chance about
    k / n_1; the buffer's 256 - 128 - k free keys then last until about
    2.6 n_1 tokens.  A query walking 116,640 tokens (a 72-frame bank) at
    k = 50 compacts about 7 times alone, and about 9 in a tile whose
    buffers compact in waves (the first to fill takes the others along),
    against 910 for keys that rise in the walking order."""
    rng = np.random.default_rng(4)
    m = 72 * 1620
    scores = torch.from_numpy(rng.standard_normal((16, m)).astype(np.float32))
    ids = torch.arange(m).expand(16, -1)
    lists, compactions = resident_lists(
        sort_keys(scores, ids, ids < m), m, 50)
    assert 6 * 16 <= compactions <= 10 * 16
    assert _every_key_admitted(m, 50, 1) == 910
    assert torch.equal(lists[:, 0], sort_keys(scores, ids, ids < m).topk(
        50, dim=1).values)


def test_threshold_admits_only_live_keys():
    """Until a buffer first compacts, its threshold is the dead key: every
    live key and no dead one is admitted.  A 40-token bank with top_k 50
    keeps the 40 live keys and DEAD_KEY after them, with no compaction."""
    qk, mk = _bank("random", 3, 100, 1)
    lists, compactions = resident_lists(_keys(qk, mk, 40), 40, 50)
    assert compactions == 0
    assert (lists[:, 0, :40] > DEAD_KEY).all()
    assert (lists[:, 0, 40:] == DEAD_KEY).all()


@pytest.mark.parametrize("n,valid,top_k,sms,want", [
    (8100, 72 * 1620, 50, 132, 1),    # 127 tiles fill the card
    (1620, 12 * 1620, 50, 132, 5),    # 26 tiles: five segments
    (1620, 72 * 1620, 50, 132, 5),
    (1620, 1620, 50, 132, 1),         # one live bank block
    (1620, 3 * 2048, 50, 132, 3),     # no more segments than live blocks
    (1620, 72 * 1620, 200, 132, 2),   # 51 tiles of 32 queries
    (8100, 72 * 1620, 200, 132, 1),   # 254 tiles: two waves, one segment
    (64, 3000, 16, 132, 2),
    (64, 0, 16, 132, 1),              # an empty bank still writes its slots
    (1620, 72 * 1620, 50, 114, 4)])   # a card with fewer SMs
def test_segment_rule(n, valid, top_k, sms, want):
    assert resident_segments(n, valid, top_k, sms) == want


def test_geometry_leaves_room_for_a_step():
    for top_k in (1, 128, 129, 256):
        queries, cap = resident_geometry(top_k)
        assert top_k <= cap - RESIDENT_STEP
        assert queries * cap * 8 == 128 * 1024
