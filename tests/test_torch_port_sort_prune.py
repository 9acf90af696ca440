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

The newest-first selection runs those kernels with a running floor per
query: each block's row keeps its top k keys at or above both the threshold
and a floor that the k-th key of some already ranked block of the query lies
at or above (``floored_lists``, ``list_floor``).  Over random block orders
and floors so chosen, the merged lists are the plain selection, ties
included; one tie-heavy bank is also held to the JAX newest-first kernel
(``chunked_topk_t``) in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels.memory_topk import pallas_memory_topk

from eva_vos_tpu_torch.kernels.memory_topk import _SELECT_BLOCK as BLOCK
from eva_vos_tpu_torch.kernels.memory_topk import (DEAD_KEY, SORT_CAPACITY,
                                                   _live_blocks, floored_lists,
                                                   list_floor, merge_lists_t,
                                                   sort_keys,
                                                   sort_prune_groups,
                                                   sort_prune_threshold,
                                                   topk_select_plain,
                                                   unpack_keys)
from eva_vos_tpu_torch.ops.memory_attention import _scores

LIVE_FLOOR = -2 ** 63 + 2 ** 32  # the least live key, shifted as sort_keys
DEAD = DEAD_KEY                   # the kernels' key 0 (a list's empty slot)


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


def _bank_keys(qk, mk, valid: int) -> torch.Tensor:
    """The keys [N, blocks, 2,048] of the live 2,048-token bank blocks."""
    blocks = _live_blocks(valid)
    scores = torch.zeros((qk.shape[0], blocks * BLOCK))
    m = min(mk.shape[0], blocks * BLOCK)
    scores[:, :m] = _scores(mk, qk, valid)[:, :m]
    ids = torch.arange(blocks * BLOCK).expand_as(scores)
    return sort_keys(scores, ids, ids < valid).unflatten(-1, (blocks, BLOCK))


def _block_lists(qk, mk, valid: int, top_k: int) -> torch.Tensor:
    """The block stage's sorted lists [N, blocks, top_k]: per live 2,048-token
    bank block, the top_k keys at or above the pruning threshold, empty
    slots DEAD."""
    keys = _bank_keys(qk, mk, valid)
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


def _bank(kind: str, rng, n: int, m: int, ck: int = 64):
    """(qk [n, ck], mk [m, ck]) fp32.  ties: each key 40 times over the bank;
    clustered: every token a query key plus noise, the tokens of query q
    packed into the last bank block, so that the floor from that block
    empties the other blocks' rows of that query."""
    qk = rng.standard_normal((n, ck))
    if kind == "random":
        mk = rng.standard_normal((m, ck))
    elif kind == "ties":
        mk = np.tile(rng.standard_normal((-(-m // 40), ck)), (40, 1))[:m]
    else:
        mk = 0.3 * rng.standard_normal((m, ck))
        near = np.arange(m - 8 * n, m)
        mk[near] = qk[near % n] + 0.05 * rng.standard_normal((8 * n, ck))
    return (torch.from_numpy(qk.astype(np.float32)),
            torch.from_numpy(mk.astype(np.float32)))


def _floored_run(keys, top_k: int, order, pick):
    """The block lists [N, blocks, top_k] when blocks are ranked in
    ``order`` and each row's floor is ``pick(seen lists, seen keys)`` [N]
    over the blocks ranked before it."""
    lists = torch.full(keys.shape[:2] + (top_k,), DEAD)
    seen = []
    for b in order:
        floor = pick(lists[:, seen], keys[:, seen])
        lists[:, b] = floored_lists(keys[:, b], top_k, floor)
        seen.append(b)
    return lists


def _kth_lowered(keys, top_k: int):
    """list_floor of the exact top_k of keys [N, ...] (DEAD where fewer)."""
    flat = keys.flatten(1)
    if flat.shape[1] < top_k:
        return torch.full((keys.shape[0],), DEAD)
    return list_floor(flat.topk(top_k, dim=1).values)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["random", "ties", "clustered"])
@pytest.mark.parametrize("valid,top_k", [(9000, 50), (5000, 256), (4097, 8)])
def test_floored_block_lists_merge_to_the_plain_selection(kind, seed, valid,
                                                          top_k):
    """Random block orders, and per query a random floor among: none, the
    largest floor any seen block's list raised (the kernel's atomicMax),
    one seen list's floor, and the lowered k-th key of a random set of seen
    blocks (at or below the true k-th key, as the rule requires).  The
    merged lists are the plain selection, ties included."""
    rng = np.random.default_rng([seed, valid, top_k])
    qk, mk = _bank(kind, rng, 6, valid)
    keys = _bank_keys(qk, mk, valid)
    blocks = keys.shape[1]
    dead = torch.full((6,), DEAD)

    def pick(seen_lists, seen_keys):
        if seen_lists.shape[1] == 0:
            return dead
        floors = list_floor(seen_lists)                  # [N, seen]
        subset = rng.random(seen_keys.shape[1]) < 0.5
        options = torch.stack([
            dead, floors.amax(1),
            floors[:, rng.integers(seen_lists.shape[1])],
            _kth_lowered(seen_keys[:, torch.from_numpy(subset)], top_k)], 1)
        return options[torch.arange(6), torch.from_numpy(rng.integers(4, size=6))]

    for order in (rng.permutation(blocks), range(blocks - 1, -1, -1)):
        lists = _floored_run(keys, top_k, order, pick)
        vals, idx = merge_lists_t(lists, top_k)
        want_v, want_i = topk_select_plain(qk, mk, valid, top_k)
        assert torch.equal(vals, want_v) and torch.equal(idx, want_i)


def _kernel_floor(seen_lists, _seen_keys):
    """The kernel's floor once the seen blocks have published theirs."""
    if seen_lists.shape[1] == 0:
        return torch.full(seen_lists.shape[:1], DEAD)
    return list_floor(seen_lists).amax(1)


def test_floor_empties_rows_that_cannot_hold_a_winner():
    """A query's near tokens all in the newest block: ranked newest first,
    that block's k-th key floors every older block's row of the query,
    which the kernel then empties without ranking it; ranked oldest first,
    no row is emptied.  Both merge to the plain selection."""
    rng = np.random.default_rng(11)
    qk, mk = _bank("clustered", rng, 6, 9000)
    keys = _bank_keys(qk, mk, 9000)
    blocks = keys.shape[1]
    want = topk_select_plain(qk, mk, 9000, 8)
    emptied = {}
    for name, order in (("newest", range(blocks - 1, -1, -1)),
                        ("oldest", range(blocks))):
        lists = _floored_run(keys, 8, order, _kernel_floor)
        got = merge_lists_t(lists, 8)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        emptied[name] = int((lists[..., 0] == DEAD).sum())
    assert emptied == {"newest": 6 * (blocks - 1), "oldest": 0}


def test_floored_lists_match_the_jax_newest_first_kernel():
    """Each key 40 times over a 5,000-token bank (ties across all three
    blocks): the floored lists, ranked newest first with the kernel's
    floor, merge to what chunked_topk_t (the JAX newest-first kernel, in
    interpret mode) selects, ids included."""
    rng = np.random.default_rng(12)
    qk, mk = _bank("ties", rng, 8, 5000)
    keys = _bank_keys(qk, mk, 5000)
    lists = _floored_run(keys, 16, range(keys.shape[1] - 1, -1, -1),
                         _kernel_floor)
    vals, idx = merge_lists_t(lists, 16)
    ref_v, ref_i = pallas_memory_topk(
        jnp.asarray(mk.numpy()), jnp.asarray(qk.numpy()), 16, 5000,
        block_q=8, block_m=512, interpret=True, method="chunked",
        return_raw=True)
    np.testing.assert_array_equal(idx.T.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(vals.T.numpy(), np.asarray(ref_v), rtol=1e-5,
                               atol=1e-5)
