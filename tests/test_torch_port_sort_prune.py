"""The sort kernel's pruning rule, on the CPU.

``memory_topk_sort.cu`` keeps, of each (query, 2,048-token bank block) row,
only the keys whose score is at or above tau, the k-th largest of the row's
group maxima of scores (groups strided across the columns), and ranks
those.  Its plain statement,
``sort_prune_threshold``, is held here to the rule's promise: the keys >= tau
contain the row's exact top k, no dead key is admitted, and a row with fewer
live keys than k keeps all of them.  The rows: random scores, exact ties,
constant rows, k equal to the number of groups, and blocks that end mid-way.

Where the survivors stay within the kernel's candidate list (random rows) and
where they overflow it (winners packed into fewer than k groups, the case
that takes the kernel's exact bisection) is checked too, since the card's
tests rely on both.  Comparisons are exact: keys are integers.

The default selection (``memory_topk.cu``) runs the same block stage and
merges the blocks' sorted lists into the transposed [k, N] outputs; with one
live block it writes the block's list and merges nothing.  Its plain
statement, ``merge_lists_t`` over the rule's per-block lists, is held to the
plain selection.
"""

import numpy as np
import pytest
import torch

from eva_vos_tpu_torch.kernels.memory_topk import _SELECT_BLOCK as BLOCK
from eva_vos_tpu_torch.kernels.memory_topk import (SORT_CAPACITY,
                                                   _live_blocks, merge_lists_t,
                                                   sort_keys,
                                                   sort_prune_groups,
                                                   sort_prune_threshold,
                                                   topk_select_plain,
                                                   unpack_keys)
from eva_vos_tpu_torch.ops.memory_attention import _scores

LIVE_FLOOR = -2 ** 63 + 2 ** 32  # the least live key, shifted as sort_keys
DEAD = -2 ** 63                   # the kernels' key 0 (a list's empty slot)


def _rows(kind: str, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((rows, BLOCK)).astype(np.float32)
    if kind == "ties":  # every score 16 times, scattered over the row
        base = rng.standard_normal((rows, BLOCK // 16)).astype(np.float32)
        tiled = np.tile(base, (1, 16))
        return np.take_along_axis(
            tiled, rng.permuted(np.tile(np.arange(BLOCK), (rows, 1)), axis=1),
            axis=1)
    if kind == "constant":
        return np.full((rows, BLOCK), rng.standard_normal(), np.float32)
    if kind == "coarse":  # few distinct values: long runs of exact ties
        return rng.integers(-2, 3, (rows, BLOCK)).astype(np.float32)
    raise ValueError(kind)


def _keys(scores: np.ndarray, live: int, lo: int = 0) -> torch.Tensor:
    s = torch.from_numpy(scores)
    ids = lo + torch.arange(s.shape[-1])
    return sort_keys(s, ids.expand_as(s), (ids < lo + live).expand_as(s))


def _assert_rule(keys: torch.Tensor, top_k: int, groups=None):
    tau = sort_prune_threshold(keys, top_k, groups)
    exact = keys.topk(top_k, dim=-1).values         # distinct keys
    admitted = keys >= tau[:, None]
    # the exact top k, where live, is admitted; nothing dead is
    assert (admitted.sum(-1) >= (exact >= LIVE_FLOOR).sum(-1)).all()
    assert ((exact >= tau[:, None]) | (exact < LIVE_FLOOR)).all()
    assert (keys[admitted] >= LIVE_FLOOR).all()
    return admitted.sum(-1)


@pytest.mark.parametrize("top_k", [1, 50, 64, 100, 128, 256])
@pytest.mark.parametrize("kind", ["random", "ties", "constant", "coarse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_keys_at_or_above_tau_hold_the_exact_top_k(kind, top_k, seed):
    _assert_rule(_keys(_rows(kind, 16, seed), BLOCK), top_k)


@pytest.mark.parametrize("groups", [32, 128, 256, 512])
@pytest.mark.parametrize("kind", ["random", "ties", "constant"])
def test_rule_holds_when_k_equals_the_groups(kind, groups):
    """k = G: tau is the least group maximum."""
    _assert_rule(_keys(_rows(kind, 8, groups), BLOCK), groups, groups)


@pytest.mark.parametrize("live", [0, 1, 49, 50, 127, 700, 2047])
@pytest.mark.parametrize("top_k", [50, 256])
def test_block_ending_mid_way(live, top_k):
    """Tokens at or past the fill are dead: none is admitted, and a row with
    fewer live keys than k keeps all of them."""
    keys = _keys(_rows("random", 8, live), live, lo=4096)
    count = _assert_rule(keys, top_k)
    if live <= top_k:
        assert (count == live).all()
    else:
        assert (count >= top_k).all() and (count <= SORT_CAPACITY).all()


def test_scores_tied_across_a_row_admit_the_whole_row():
    """The threshold is on scores, so a score tied across the row admits
    every key: more than the kernel's candidate list, so its exact
    escalation (which splits the tie by id) takes such rows."""
    keys = _keys(_rows("constant", 4, 3), BLOCK)
    for top_k in (1, 50, 256):
        tau = sort_prune_threshold(keys, top_k)
        assert ((keys >= tau[:, None]).sum(-1) == BLOCK).all()
    assert BLOCK > SORT_CAPACITY


@pytest.mark.parametrize("top_k", [50, 64, 100, 128, 256])
def test_random_rows_fit_the_candidate_list(top_k):
    """On random scores ~1.0-1.4 k keys survive, inside the list: the
    kernel's exact escalation does not run."""
    count = _assert_rule(_keys(_rows("random", 256, top_k), BLOCK), top_k)
    assert count.max() <= SORT_CAPACITY
    assert count.float().mean() <= 1.5 * top_k


def test_winners_in_few_groups_overflow_the_candidate_list():
    """Columns 0..39 of every 128 score above the rest: their 40 groups hold
    640 keys above tau (the 50th group maximum), more than the list keeps,
    so the kernel takes its exact bisection (the escalation test's bank)."""
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((8, BLOCK)).astype(np.float32)
    scores[:, (np.arange(BLOCK) % 128) < 40] += 100.0
    count = _assert_rule(_keys(scores, BLOCK), 50)
    assert sort_prune_groups(50) == 128
    assert (count > SORT_CAPACITY).all()


def test_keys_order_as_score_desc_id_asc():
    scores = torch.tensor([1.0, -0.0, 0.0, -2.5, 3.0, 3.0, -np.inf, 1e30])
    ids = torch.arange(8)
    keys = sort_keys(scores, ids, torch.ones(8, dtype=torch.bool))
    order = keys.argsort(descending=True)
    # -0 sorts below +0 by its bits (the kernel's scores are never -0)
    assert order.tolist() == [7, 4, 5, 0, 2, 1, 3, 6]
    dead = sort_keys(scores, ids, torch.zeros(8, dtype=torch.bool))
    assert (dead < LIVE_FLOOR).all() and (keys >= LIVE_FLOOR).all()


def _block_lists(qk, mk, valid: int, top_k: int) -> torch.Tensor:
    """The block stage's sorted lists [N, blocks, top_k]: per live 2,048-token
    bank block, the top_k keys at or above the pruning threshold, empty
    slots DEAD."""
    blocks = _live_blocks(valid)
    scores = torch.zeros((qk.shape[0], blocks * BLOCK))
    m = min(mk.shape[0], blocks * BLOCK)
    scores[:, :m] = _scores(mk, qk, valid)[:, :m]
    ids = torch.arange(blocks * BLOCK).expand_as(scores)
    keys = sort_keys(scores, ids, ids < valid).unflatten(-1, (blocks, BLOCK))
    tau = sort_prune_threshold(keys, top_k)
    kept = torch.where(keys >= tau[..., None], keys, torch.full_like(keys, DEAD))
    return kept.topk(top_k, dim=-1).values


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("valid,top_k", [
    (0, 50), (20, 50), (1620, 50), (2048, 64), (2049, 50), (3000, 100),
    (5000, 50), (5000, 256)])
def test_block_lists_merged_transposed_are_the_plain_selection(kind, valid,
                                                               top_k):
    """Blocks of one live bank block (no merge: the list is the answer), a
    second block of one token, fills ending mid-block, fewer valid tokens
    than k, and exact ties (each key 40 times over the bank): the merged
    lists give the plain selection's scores and ids, -1e30 past the fill."""
    rng = np.random.default_rng(valid + top_k)
    if kind == "random":
        mk = rng.standard_normal((5000, 64))
    else:
        mk = np.tile(rng.standard_normal((125, 64)), (40, 1))
    mk = torch.from_numpy(mk.astype(np.float32))
    qk = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    lists = _block_lists(qk, mk, valid, top_k)
    if _live_blocks(valid) == 1:
        vals, idx = unpack_keys(lists[:, 0])
        assert torch.equal(merge_lists_t(lists, top_k)[0], vals.T)
    vals, idx = merge_lists_t(lists, top_k)
    want_v, want_i = topk_select_plain(qk, mk, valid, top_k)
    live = min(valid, top_k)
    assert vals.shape == idx.shape == (top_k, 6) and idx.dtype == torch.int32
    assert torch.equal(vals[:live], want_v[:live])
    assert torch.equal(idx[:live], want_i[:live])
    assert (vals[live:] == -1e30).all() and (idx[live:] == 0).all()


def test_unpack_keys_inverts_sort_keys():
    scores = torch.tensor([1.0, 0.0, -2.5, 3.0, -1e30, 1e30, 7.25e-3])
    ids = torch.tensor([0, 5, 7, 2 ** 31 - 1, 3, 12, 40000])
    vals, got = unpack_keys(sort_keys(scores, ids, torch.ones(7, dtype=torch.bool)))
    assert torch.equal(vals, scores) and torch.equal(got, ids.to(torch.int32))
    dead_v, dead_i = unpack_keys(torch.full((3,), DEAD))
    assert (dead_v == -1e30).all() and (dead_i == 0).all()
