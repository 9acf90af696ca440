"""The port's CUDA kernels against their plain versions and a numpy oracle.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tests marked ``cuda`` skip without a GPU.  Tolerances: scores are sums of CK
products in fp32, summed in another order by the kernel than by the plain
version's matmul (atol 1e-4 at |score| ~ 10); the fp32 readout is a
weighted mean of N(0, 1) values (atol 1e-5); the bf16 readout may round
one bf16 ulp apart (2^-7 relative, atol 2e-2).
"""

import shutil
from functools import partial

import numpy as np
import pytest
import torch

from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine, pad_mask,
                                      prepare_video)
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.kernels import (KernelConfig, build, fused_readout,
                                       fused_readout_plain, select_topk,
                                       topk_readout, topk_readout_chunked,
                                       topk_readout_plain, topk_select,
                                       topk_select_chunked, topk_select_grid,
                                       topk_select_iter, topk_select_plain,
                                       topk_select_resident, topk_select_sort)
from eva_vos_tpu_torch.kernels.memory_readout import (large_k_geometry,
                                                      readout_geometry,
                                                      readout_large_k_plain,
                                                      readout_staged_rows)
from eva_vos_tpu_torch.kernels.memory_topk import (_SELECT_BLOCK,
                                                   RADIX_ROUND,
                                                   RADIX_SORT_CHUNK,
                                                   SORT_CAPACITY,
                                                   iter_segments,
                                                   radix_threshold,
                                                   resident_lists,
                                                   resident_rows,
                                                   resident_segments,
                                                   sort_keys,
                                                   sort_prune_threshold)
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.ops.memory_attention import (_scores,
                                                    memory_affinity_topk,
                                                    softmax_weights,
                                                    topk_scores)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _oracle_topk(qk, mk, valid, top_k):
    """fp64 ranking by (score desc, id asc); duplicate rows tie exactly."""
    q = qk.double().cpu().numpy()
    k = mk.double().cpu().numpy()[:valid]
    s = (2 * (q[:, None, :] * k[None, :, :]).sum(-1) - (k * k).sum(-1)) / 8.0
    order = np.lexsort((np.broadcast_to(np.arange(valid), s.shape), -s), axis=1)
    return order[:, :top_k].T


def test_plain_selection_matches_numpy_oracle():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (8, 1)))          # exact ties
    qk = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    _, idx = topk_select_plain(qk, mk, 60, 12)
    np.testing.assert_array_equal(idx.numpy(), _oracle_topk(qk, mk, 60, 12))


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, never computed by the plain version."""
    qk = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        topk_select(qk, qk, 8, 4)


# the selection kernels of the other memory reads, each as
# (vals [k, N] raw scores, idx [k, N]) and the wrapper that counts it
def _grid_transposed(qk, mk, valid, top_k):
    vals, idx = topk_select_grid(qk, mk, valid, top_k, return_raw=True)
    return vals.T, idx.T


VARIANTS = {
    "chunked": (topk_select_chunked, topk_select_chunked),
    "chunked_notau": (partial(topk_select_chunked, no_skip=True),
                      topk_select_chunked),
    "resident": (topk_select_resident, topk_select_resident),
    "grid": (_grid_transposed, topk_select_grid),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [3000, 1700, 20])
def test_selection_variant_kernels(cuda, variant, dtype, valid):
    """The pruned block stage (grid, chunked) and the resident kernel sum
    |k|^2 and the products in another order than the plain version (bf16
    keys on the tensor cores), so their ids may differ only at near-ties,
    as the default selection's."""
    fn, counted = VARIANTS[variant]
    g = torch.Generator(device=cuda).manual_seed(valid)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(dtype)
    before = counted.launches
    vals, idx = fn(qk, mk, valid, 50)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    pv, pi = topk_select_plain(qk, mk, valid, 51)
    live = min(valid, 50)
    _assert_same_selection(vals[:live].T, idx[:live].T, pv[:live + 1].T,
                           pi[:live + 1].T, 1e-4)
    assert torch.all(vals[live:] == -1e30)
    assert int(idx.min()) >= 0 and int(idx.max()) < valid


@pytest.mark.cuda
def test_grid_selection_weights(cuda):
    """The softmax weights of the 'select' read's selection (two bank
    blocks here, merged); ids up to near-ties, as the raw scores."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qk = torch.randn((300, 64), generator=g, device=cuda)
    mk = torch.randn((3000, 64), generator=g, device=cuda)
    w, idx = topk_select_grid(qk, mk, 2500, 50)
    vals, raw_idx = topk_select_grid(qk, mk, 2500, 50, return_raw=True)
    assert torch.equal(idx, raw_idx)
    pv, pi = topk_scores(mk, qk, 51, 2500)
    _assert_same_selection(vals, idx, pv, pi.to(torch.int32), 1e-4)
    pw, _ = memory_affinity_topk(mk, qk, 50, 2500)
    torch.testing.assert_close(w, pw, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_variants_tie_to_lowest_id(cuda, variant, dtype):
    rng = np.random.default_rng(2)
    base = rng.standard_normal((40, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (50, 1))).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((70, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = VARIANTS[variant][0](qk, mk, 1990, 50)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, 1990, 50))


def _as_rows(select):
    """A transposed [k, N] selection as rows (raw scores or weights)."""
    def rows(qk, mk, valid, top_k, return_raw=False, **kw):
        vals, idx = select(qk, mk, valid, top_k, **kw)
        vals, idx = vals.T, idx.T
        return (vals if return_raw else softmax_weights(vals)), idx
    return rows


# the block selections as rows: select_topk's 'iterative' and 'sort'
# methods; the 'select' read's selection (grid), which runs the sort
# kernel's device code; the default read's selection, which shares its
# block stage, and the chunked read's, the default one newest first with a
# running floor (chunked) or without (chunked_notau); and the wrapper that
# counts each one's launches
ROW_SELECTORS = {
    "iterative": topk_select_iter, "sort": topk_select_sort,
    "grid": topk_select_grid, "tournament": _as_rows(topk_select),
    "chunked": _as_rows(topk_select_chunked),
    "chunked_notau": _as_rows(partial(topk_select_chunked, no_skip=True))}
COUNTED = {"iterative": topk_select_iter, "sort": topk_select_sort,
           "grid": topk_select_grid, "tournament": topk_select,
           "chunked": topk_select_chunked,
           "chunked_notau": topk_select_chunked}
# the selections with the pruned block stage
PRUNED = ("sort", "grid", "tournament", "chunked", "chunked_notau")
FRAME_TOKENS = 30 * 54  # key tokens of one 480x864 frame


def _assert_same_selection(vals, idx, ref_vals, ref_idx, atol):
    """Scores within atol of the plain version's; ids equal except where
    the plain version's neighbouring scores lie within atol (a near-tie
    that summing in another order may swap).  The plain version may give
    one slot more than the kernel, so that a near-tie across the last slot
    counts too."""
    k = idx.shape[1]
    torch.testing.assert_close(vals, ref_vals[:, :k], rtol=0, atol=atol)
    close = (ref_vals[:, :-1] - ref_vals[:, 1:]).abs() <= atol
    tied = torch.zeros_like(idx, dtype=torch.bool)
    tied[:, :close.shape[1]] |= close[:, :k]
    tied[:, 1:] |= close[:, :k - 1]
    assert not ((idx != ref_idx[:, :k]) & ~tied).any()


def _overflowing_rows(qk, mk, valid, top_k):
    """(query, bank block) rows whose keys at or above the plain statement
    of the sort kernel's pruning threshold outnumber its candidate list:
    the rows its exact escalation must take."""
    blocks = -(-valid // _SELECT_BLOCK)
    scores = torch.zeros((qk.shape[0], blocks * _SELECT_BLOCK))
    scores[:, :valid] = _scores(mk[:valid], qk).cpu()
    ids = torch.arange(scores.shape[1]).expand_as(scores)
    keys = sort_keys(scores, ids, ids < valid).unflatten(-1, (blocks, -1))
    tau = sort_prune_threshold(keys, top_k)
    return int(((keys >= tau[..., None]).sum(-1) > SORT_CAPACITY).sum())


def _escalations(method, device):
    """The pruned block stage's counter of escalated rows (a one-element
    zero) and the keyword that hands it over; no keyword for the iterative
    kernel."""
    esc = torch.zeros(1, dtype=torch.int32, device=device)
    return esc, ({"escalations": esc} if method in PRUNED else {})


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(ROW_SELECTORS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [FRAME_TOKENS, 333])
@pytest.mark.parametrize("fill", [1, 12, 72])
def test_row_selection_kernels_at_bank_fills(cuda, method, dtype, n, fill):
    """The block selections at the engine's bank fills (1, 12 and 72 frames
    of 1,620 tokens) in a 72-frame bank, N = 1,620 and ragged; fill 1 is one
    live bank block, which the default selection writes with no merge."""
    fn = ROW_SELECTORS[method]
    g = torch.Generator(device=cuda).manual_seed(fill)
    qk = torch.randn((n, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((72 * FRAME_TOKENS, 64), generator=g, device=cuda).to(
        dtype)
    valid = fill * FRAME_TOKENS
    before = COUNTED[method].launches
    esc, kw = _escalations(method, cuda)
    vals, idx = fn(qk, mk, valid, 50, return_raw=True, **kw)
    torch.cuda.synchronize()
    assert COUNTED[method].launches == before + 1
    assert vals.shape == idx.shape == (n, 50) and idx.dtype == torch.int32
    pv, pi = topk_scores(mk, qk, 50, valid)
    _assert_same_selection(vals, idx, pv, pi.to(torch.int32), 1e-4)
    assert int(esc) == 0  # random banks never overflow the sort's lists


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(ROW_SELECTORS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [5000, 3000, 20])
@pytest.mark.parametrize("top_k", [50, 64, 100, 256])
def test_row_selection_kernels_partial_fills(cuda, method, dtype, valid,
                                             top_k):
    """A full bank of three blocks, a fill ending mid-block (3,000 =
    2,048 + 952), and fewer valid tokens than top_k; raw scores and
    weights.  top_k past 64 runs the sort kernel's shared-memory bitonic
    stages (runs of 128 and 256 keys) and the longer extractions."""
    fn = ROW_SELECTORS[method]
    g = torch.Generator(device=cuda).manual_seed(valid)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((5000, 64), generator=g, device=cuda).to(dtype)
    esc, kw = _escalations(method, cuda)
    vals, idx = fn(qk, mk, valid, top_k, return_raw=True, **kw)
    assert vals.shape == idx.shape == (300, top_k)
    assert int(esc) == 0
    pv, pi = topk_scores(mk, qk, top_k, valid)
    live = min(valid, top_k)
    _assert_same_selection(vals[:, :live], idx[:, :live], pv[:, :live],
                           pi[:, :live].to(torch.int32), 1e-4)
    assert torch.all(vals[:, live:] == -1e30)
    assert int(idx.min()) >= 0 and int(idx.max()) < valid
    w, widx = fn(qk, mk, valid, top_k)
    pw, _ = memory_affinity_topk(mk, qk, top_k, valid)
    assert torch.equal(widx, idx)
    torch.testing.assert_close(w, pw, rtol=1e-5, atol=1e-6)
    assert torch.all(w[:, live:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(ROW_SELECTORS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [50, 256])
def test_row_selection_kernels_exact_ties(cuda, method, dtype, top_k):
    """300 copies of each of 10 keys: every selected token ties 299 others;
    the ids must be the lowest, as the plain version's."""
    rng = np.random.default_rng(4)
    mk = torch.from_numpy(np.tile(rng.standard_normal((10, 64)), (300, 1))
                          .astype(np.float32)).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = ROW_SELECTORS[method](qk, mk, 3000, top_k)
    _, pi = topk_scores(mk, qk, top_k, 3000)
    assert torch.equal(idx, pi.to(torch.int32))
    np.testing.assert_array_equal(idx.cpu().numpy().T,
                                  _oracle_topk(qk, mk, 3000, top_k))


@pytest.mark.cuda
@pytest.mark.parametrize("method", PRUNED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [50, 256])
def test_sort_kernel_identical_keys(cuda, method, dtype, top_k):
    """Every token the same key: all scores of a row tie, so the threshold
    (on scores) admits all 2,048 keys of a block, more than the candidate
    list holds.  Every (query, block) row of the two full blocks takes the
    exact escalation (the third, 404 tokens, fits), which splits the tie by
    id: the ids are the lowest, as the plain version's.  The other
    selections share the block stage; the newest-first one's floor is the
    tied score's least key, which admits the whole row all the same."""
    rng = np.random.default_rng(8)
    mk = torch.from_numpy(np.tile(rng.standard_normal((1, 64)), (5000, 1))
                          .astype(np.float32)).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((45, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    esc = torch.zeros(1, dtype=torch.int32, device=cuda)
    _, idx = ROW_SELECTORS[method](qk, mk, 4500, top_k, escalations=esc)
    want = torch.arange(top_k, dtype=torch.int32, device=cuda)
    assert torch.equal(idx, want.expand(45, top_k))
    assert int(esc) == 45 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("method", PRUNED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [50, 64, 100, 256])
def test_sort_kernel_escalation(cuda, method, dtype, top_k):
    """Winners packed into few groups: tokens with (t mod 128) < 40 lie near
    every query and the rest far away, so the 40 of each 128 column groups
    hold 640 keys of a block's row above the threshold, more than the
    kernel's candidate list (512).  Every row of the first, full bank block
    escalates to the exact bisection (the second block, 952 tokens, keeps
    320 near tokens and fits); the result stays exact, and the selections
    that share the block stage escalate the same rows (the newest-first one
    at most those: its floor may lift a row out of the overflow)."""
    rng = np.random.default_rng(9)
    u = rng.standard_normal(64)
    near = (np.arange(3000) % 128) < 40
    mk = np.where(near[:, None], u, -u) + 0.1 * rng.standard_normal((3000, 64))
    qk = u + 0.1 * rng.standard_normal((77, 64))
    mk = torch.from_numpy(mk.astype(np.float32)).to(cuda, dtype)
    qk = torch.from_numpy(qk.astype(np.float32)).to(cuda, dtype)
    esc = torch.zeros(1, dtype=torch.int32, device=cuda)
    vals, idx = ROW_SELECTORS[method](qk, mk, 3000, top_k, return_raw=True,
                                      escalations=esc)
    if method == "chunked":
        # the floor from the newer block, where it arrives before the older
        # block's row compacts, raises the threshold above that row's
        # overflow: fewer rows escalate, depending on the blocks' timing
        assert 0 <= int(esc) <= _overflowing_rows(qk, mk, 3000, top_k) == 77
    else:
        assert int(esc) == _overflowing_rows(qk, mk, 3000, top_k) == 77
    # 640 near tokens crowd each row's scores: compare up to near-ties,
    # across the last slot too
    pv, pi = topk_scores(mk, qk, top_k + 1, 3000)
    _assert_same_selection(vals, idx, pv, pi.to(torch.int32), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("no_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_selection_floor_empties_older_rows(cuda, no_skip, dtype):
    """Every key of the newest bank block scores above every older key for
    every query (older keys have norms of ~80, so -|k|^2 sinks their
    scores): the newest block's k-th key floors each older block's row.
    The newest blocks are dispatched first (8,100 queries fill 4 waves of
    the card before the older blocks start), so the floor empties older
    rows, which the counter shows; at most all of them.  No_skip: none.
    Either way the selection is the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(13)
    n, valid = 8100, 4 * 2048 + 1000
    qk = torch.randn((n, 64), generator=g, device=cuda).to(dtype)
    mk = 10 * torch.randn((valid, 64), generator=g, device=cuda)
    mk[4 * 2048:] *= 0.01
    mk = mk.to(dtype)
    esc = torch.zeros(1, dtype=torch.int32, device=cuda)
    floored = torch.zeros(1, dtype=torch.int32, device=cuda)
    vals, idx = topk_select_chunked(qk, mk, valid, 50, no_skip=no_skip,
                                    escalations=esc, floored_rows=floored)
    older_rows = n * 4
    if no_skip:
        assert int(floored) == 0
    else:
        assert 0 < int(floored) <= older_rows
    assert int(esc) == 0
    assert int(idx.min()) >= 4 * 2048
    pv, pi = topk_select_plain(qk, mk, valid, 51)
    _assert_same_selection(vals.T, idx.T, pv.T, pi.T, 1e-4)


@pytest.mark.cuda
def test_select_topk_default_launches_iterative(cuda):
    """select_topk with no method runs the iterative kernel; 'sort' the
    sort kernel."""
    g = torch.Generator(device=cuda).manual_seed(6)
    qk = torch.randn((100, 64), generator=g, device=cuda)
    mk = torch.randn((3000, 64), generator=g, device=cuda)
    before = (topk_select_iter.launches, topk_select_sort.launches)
    w, idx = select_topk(mk, qk, 50, 2500)
    ws, idxs = select_topk(mk, qk, 50, 2500, method="sort")
    assert (topk_select_iter.launches, topk_select_sort.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(idx, idxs)
    torch.testing.assert_close(w, ws, rtol=1e-6, atol=1e-7)


def _integer_bank(case: str, rng):
    """(qk [64, 64], mk [3000, 64]) of small integers, exact in bf16, whose
    scores are exact in fp32 in any summation order.  dominant_tokens:
    winners packed into tokens 20..39; ties_past_capacity: ten keys 300
    times each, more exact ties than a buffer holds; rising_scores: keys
    c v with c rising along the bank and queries with q . v <= 0, so that
    every key beats the keys walked (newest first) before it."""
    if case == "dominant_tokens":
        mk = rng.integers(-3, 4, (3000, 64))
        mk[20:40] *= 30
        qk = 30 * rng.integers(-3, 4, (64, 64))
    elif case == "ties_past_capacity":
        mk = np.tile(rng.integers(-4, 5, (10, 64)), (300, 1))
        qk = rng.integers(-4, 5, (64, 64))
    else:
        v = rng.choice([-1, 1], 64)
        mk = (np.arange(3000) * 256 // 3000)[:, None] * v
        qk = -v * rng.integers(0, 3, (64, 64))
    return qk.astype(np.float32), mk.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dominant_tokens", "ties_past_capacity",
                                  "rising_scores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [16, 200])
def test_resident_compactions(cuda, case, dtype, top_k):
    """Winners packed into one slice of the bank, more exact ties than a
    candidate buffer holds, and keys that rise in the walking order (a
    compaction at every fill): the ids are the exact selection's, ties to
    the lowest id, and the kernel's compactions are those of its plain
    statement (resident_lists) over the same keys, in the kernel's segments
    (two here).  The scores are exact in any order, so the kernel admits
    the plain walk's keys at every step."""
    qk, mk = _integer_bank(case, np.random.default_rng(3))
    qk, mk = torch.from_numpy(qk), torch.from_numpy(mk)
    comp = torch.zeros(1, dtype=torch.int32, device=cuda)
    _, idx = topk_select_resident(qk.to(cuda, dtype), mk.to(cuda, dtype),
                                  3000, top_k, compactions=comp)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, 3000, top_k))
    segments = resident_segments(
        64, 3000, top_k,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    ids = torch.arange(3000).expand(64, -1)
    _, want = resident_lists(sort_keys(_scores(mk, qk), ids, ids < 3000),
                             3000, top_k, segments)
    assert segments == 2 and int(comp) == want
    if case == "rising_scores":
        assert want >= 64 * 8  # every key admitted: a compaction a fill
    elif case == "ties_past_capacity":
        assert want > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [300, 8100])
@pytest.mark.parametrize("valid", [5000, 3000, 100])
@pytest.mark.parametrize("top_k", [1, 50, 128, 129, 256])
def test_resident_kernel_top_k(cuda, dtype, n, valid, top_k):
    """The resident kernel at top_k 1 to 256: 64-query tiles with 256-key
    buffers up to 128, 32-query tiles with 512-key buffers above; 300
    queries take one segment a live bank block (merged), 8,100 one segment
    (the block stores [k, N]); fills of three blocks, one ending mid-step,
    and fewer tokens than top_k."""
    g = torch.Generator(device=cuda).manual_seed(valid + top_k)
    qk = torch.randn((n, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((5000, 64), generator=g, device=cuda).to(dtype)
    before = topk_select_resident.launches
    comp = torch.zeros(1, dtype=torch.int32, device=cuda)
    vals, idx = topk_select_resident(qk, mk, valid, top_k, compactions=comp)
    torch.cuda.synchronize()
    assert topk_select_resident.launches == before + 1
    assert vals.shape == idx.shape == (top_k, n) and idx.dtype == torch.int32
    pv, pi = topk_select_plain(qk, mk, valid, top_k + 1)
    live = min(valid, top_k)
    _assert_same_selection(vals[:live].T, idx[:live].T, pv[:live + 1].T,
                           pi[:live + 1].T, 1e-4)
    assert torch.all(vals[live:] == -1e30) and torch.all(idx[live:] == 0)
    assert int(idx.min()) >= 0 and int(idx.max()) < valid
    assert 0 <= int(comp) <= n * -(-valid // 128)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dominant_tokens", "ties_past_capacity",
                                  "rising_scores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [64, 8100])
@pytest.mark.parametrize("top_k", [16, 200])
@pytest.mark.parametrize("raw", [False, True])
def test_iter_kernel_is_its_plain_statement(cuda, case, dtype, n, top_k, raw):
    """The iterative kernel (the resident walk with the row epilogue) on
    test_resident_compactions' banks, whose scores are exact in any
    summation order, so that the kernel admits the plain walk's keys at
    every step: ids and raw scores equal to resident_rows' in the kernel's
    segments (64 queries: twelve segments, merged; 8,100: one, each warp
    writes its rows), weights to expf's rounding, and the same compactions.
    Ids are also the exact selection's (ties to the lowest id)."""
    qk, mk = _integer_bank(case, np.random.default_rng(3))
    qk = torch.from_numpy(np.tile(qk, (-(-n // 64), 1))[:n])
    mk = torch.from_numpy(mk)
    comp = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = topk_select_iter.launches
    w, idx = topk_select_iter(qk.to(cuda, dtype), mk.to(cuda, dtype), 3000,
                              top_k, return_raw=raw, compactions=comp)
    torch.cuda.synchronize()
    assert topk_select_iter.launches == before + 1
    segments = iter_segments(
        n, 3000, top_k,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (segments > 1) == (n == 64)
    ids = torch.arange(3000).expand(n, -1)
    want_w, want_i, want_c = resident_rows(
        sort_keys(_scores(mk, qk), ids, ids < 3000), 3000, top_k, segments,
        return_raw=raw)
    assert torch.equal(idx.cpu(), want_i)
    if raw:
        assert torch.equal(w.cpu(), want_w)
    else:
        torch.testing.assert_close(w.cpu(), want_w, rtol=1e-5, atol=1e-7)
    assert int(comp) == want_c
    np.testing.assert_array_equal(idx[:64].cpu().numpy().T,
                                  _oracle_topk(qk[:64], mk, 3000, top_k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,fill", [(8100, 1), (8100, 72), (1620, 1),
                                    (1620, 12)])
@pytest.mark.parametrize("top_k", [50, 256])
def test_iter_kernel_at_card_size(cuda, dtype, n, fill, top_k):
    """The engine's shapes: N = 8,100 (one segment: each warp writes its
    rows) and 1,620 (several segments, merged by the row merge), banks of 1,
    12 and 72 frames of 1,620 tokens in a 72-frame bank, top_k 50 and 256:
    the plain version's selection up to near-ties; the weights are the
    softmax of the raw scores."""
    g = torch.Generator(device=cuda).manual_seed(fill + top_k)
    qk = torch.randn((n, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((72 * FRAME_TOKENS, 64), generator=g, device=cuda).to(
        dtype)
    valid = fill * FRAME_TOKENS
    segments = iter_segments(
        n, valid, top_k,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (segments > 1) == (n == 1620)
    vals, idx = topk_select_iter(qk, mk, valid, top_k, return_raw=True)
    w, widx = topk_select_iter(qk, mk, valid, top_k)
    torch.cuda.synchronize()
    assert vals.shape == idx.shape == (n, top_k) and idx.dtype == torch.int32
    pv, pi = topk_scores(mk, qk, top_k + 1, valid)
    _assert_same_selection(vals, idx, pv, pi.to(torch.int32), 1e-4)
    assert torch.equal(widx, idx)
    torch.testing.assert_close(w, softmax_weights(vals), rtol=1e-6, atol=1e-7)


def test_build_raises_without_nvcc():
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolkit is present: the build runs instead")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid,top_k", [
    (3000, 50), (1700, 50), (20, 50), (2048, 64), (5000, 100), (5000, 256),
    (20, 256)])
def test_topk_select_kernel(cuda, dtype, valid, top_k):
    """The transposed [k, N] contract: one live bank block (1,700 and 2,048
    tokens: no merge), a fill ending mid-block (3,000), three blocks, and
    fewer valid tokens than top_k; no random row escalates.  The kernel sums
    |k|^2 and the products in another order than the plain version, so ids
    may differ only at near-ties (as for the sort kernel's tests)."""
    g = torch.Generator(device=cuda).manual_seed(valid)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((5000, 64), generator=g, device=cuda).to(dtype)
    before = topk_select.launches
    esc = torch.zeros(1, dtype=torch.int32, device=cuda)
    vals, idx = topk_select(qk, mk, valid, top_k, escalations=esc)
    torch.cuda.synchronize()
    assert topk_select.launches == before + 1
    assert vals.shape == idx.shape == (top_k, 300) and idx.dtype == torch.int32
    assert int(esc) == 0
    pv, pi = topk_select_plain(qk, mk, valid, top_k + 1)
    live = min(valid, top_k)
    _assert_same_selection(vals[:live].T, idx[:live].T, pv[:live + 1].T,
                           pi[:live + 1].T, 1e-4)
    assert torch.all(vals[live:] == -1e30)
    assert int(idx.min()) >= 0 and int(idx.max()) < valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [1990, 4990])
@pytest.mark.parametrize("top_k", [50, 256])
def test_topk_select_kernel_ties_to_lowest_id(cuda, dtype, valid, top_k):
    """Each of 40 keys 125 times over the bank: within one bank block
    (1,990 tokens) and across the merge of three (4,990)."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((40, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (125, 1))).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((70, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = topk_select(qk, mk, valid, top_k)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, valid, top_k))


def _readout_selection(kind: str, n: int, m: int, top_k: int, valid: int,
                       device):
    """(vals [top_k, N] descending raw scores, idx [top_k, N] int32) as a
    selection gives them, from numpy: 'random' picks distinct ids over the
    valid tokens; 'clustered' picks them from a 256-id pool that 16
    neighbouring queries share (few distinct rows a tile); 'ties' gives
    every pick the same score.  Slots past ``valid`` hold -1e30 and id 0."""
    rng = np.random.default_rng(n + m + top_k)
    live = min(valid, top_k)
    idx = np.zeros((n, top_k), np.int64)
    for q in range(n):
        if kind == "clustered":
            pool = ((q // 16) * 64 + np.arange(256)) % valid
            idx[q, :live] = rng.choice(pool, live, replace=False)
        else:
            idx[q, :live] = rng.choice(valid, live, replace=False)
    vals = np.full((n, top_k), -1e30, np.float32)
    scores = (np.zeros((n, live)) if kind == "ties"
              else -np.sort(-3 * rng.standard_normal((n, live)), axis=1))
    vals[:, :live] = scores
    return (torch.from_numpy(np.ascontiguousarray(vals.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(idx.T, np.int32)).to(device))


# (kind, N, M, CV, top_k, valid, K, dtype): the cases of the plain plan's
# CPU tests (tests/test_torch_port_readout.py) at card sizes: N = 1 and N
# not a multiple of a tile; valid < top_k; top_k 1, 50 and 256; CV 8, 64,
# 512 and 1,024 in bf16 and 512 in fp32; K = 1 and 2; 64-query tiles at
# N = 8,100; ids over two bitmap windows (M > 131,072)
READOUT_CASES = [
    ("random", 300, 3000, 512, 50, 2500, 1, torch.bfloat16),
    ("random", 300, 3000, 512, 50, 2500, 2, torch.float32),
    ("clustered", 300, 3000, 512, 50, 2500, 2, torch.bfloat16),
    ("clustered", 300, 3000, 512, 50, 2500, 1, torch.float32),
    ("random", 1, 3000, 512, 50, 2500, 1, torch.bfloat16),
    ("random", 130, 3000, 64, 50, 20, 1, torch.bfloat16),
    ("ties", 100, 640, 64, 16, 640, 2, torch.float32),
    ("random", 77, 512, 8, 1, 512, 1, torch.bfloat16),
    ("clustered", 200, 5000, 1024, 256, 4000, 1, torch.bfloat16),
    ("random", 200, 5000, 512, 256, 4000, 1, torch.float32),
    ("random", 200, 5000, 1024, 100, 4000, 2, torch.bfloat16),
    ("clustered", 8100, 20000, 512, 50, 19440, 1, torch.bfloat16),
    ("random", 1000, 140000, 64, 50, 140000, 1, torch.bfloat16),
]


def _readout_case(case, device):
    kind, n, m, cv, top_k, valid, k_obj, dtype = case
    g = torch.Generator(device=device).manual_seed(n + cv)
    mv = torch.randn((k_obj, m, cv), generator=g, device=device).to(dtype)
    vals, idx = _readout_selection(kind, n, m, top_k, valid, device)
    queries, _ = readout_geometry(n, k_obj, cv, mv.element_size(), top_k,
                                  torch.cuda.get_device_properties(
                                      device).multi_processor_count)
    return mv, vals, idx, readout_staged_rows(vals, idx, k_obj, queries)


def _assert_readout_close(out, ref):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", READOUT_CASES, ids=str)
def test_topk_readout_kernel(cuda, case):
    """The default read's readout (a weighted gather) against the plain
    version; two runs equal bit for bit."""
    mv, vals, idx, _ = _readout_case(case, cuda)
    before = topk_readout.launches
    out = topk_readout(mv, vals, idx)
    torch.cuda.synchronize()
    assert topk_readout.launches == before + 1
    assert out.shape == (mv.shape[0], vals.shape[1], mv.shape[2])
    _assert_readout_close(out, topk_readout_plain(mv, vals, idx))
    assert torch.equal(topk_readout(mv, vals, idx), out)


@pytest.mark.cuda
@pytest.mark.parametrize("no_skip", [False, True])
@pytest.mark.parametrize("case", READOUT_CASES, ids=str)
def test_chunked_readout_kernel(cuda, case, no_skip):
    """The chunked readout (the readout stage) against the plain version;
    bit for bit equal to a second run and with the chunk skip turned the
    other way; the rows staged as many as the plain plan stages
    (readout_staged_rows)."""
    mv, vals, idx, want_rows = _readout_case(case, cuda)
    staged = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = topk_readout_chunked.launches
    out = topk_readout_chunked(mv, vals, idx, no_skip=no_skip,
                               staged_rows=staged)
    torch.cuda.synchronize()
    assert topk_readout_chunked.launches == before + 1
    assert out.shape == (mv.shape[0], vals.shape[1], mv.shape[2])
    _assert_readout_close(out, topk_readout_plain(mv, vals, idx))
    assert int(staged) == want_rows
    assert torch.equal(topk_readout_chunked(mv, vals, idx, no_skip=no_skip),
                       out)
    assert torch.equal(topk_readout_chunked(mv, vals, idx,
                                            no_skip=not no_skip), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_obj", [1, 2])
def test_readout_kernels_on_selections(cuda, dtype, k_obj):
    """Both readouts on the default selection kernel's output, random and
    clustered banks, fewer valid tokens than top_k too, and chained by
    fused_readout against the plain chain."""
    g = torch.Generator(device=cuda).manual_seed(k_obj)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mv = torch.randn((k_obj, 3000, 512), generator=g, device=cuda).to(dtype)
    for mk in (torch.randn((3000, 64), generator=g, device=cuda).to(dtype),
               qk[torch.arange(3000, device=cuda) % 300]
               + 0.05 * torch.randn((3000, 64), generator=g, device=cuda
                                    ).to(dtype)):
        for valid in (2500, 20):
            vals, idx = topk_select(qk, mk.contiguous(), valid, 50)
            ref = topk_readout_plain(mv, vals, idx)
            _assert_readout_close(topk_readout(mv, vals, idx), ref)
            _assert_readout_close(topk_readout_chunked(mv, vals, idx), ref)
    out = fused_readout(mk, qk, mv, 50, 20)
    torch.testing.assert_close(out.float(),
                               fused_readout_plain(mk, qk, mv, 50, 20).float(),
                               rtol=2 ** -7, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sel", ["tournament", "chunked", "resident"])
@pytest.mark.parametrize("readout", ["grid", "chunked"])
def test_fused_readout_kernel_configs(cuda, sel, readout):
    g = torch.Generator(device=cuda).manual_seed(7)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(torch.bfloat16)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(torch.bfloat16)
    mv = torch.randn((2, 3000, 512), generator=g, device=cuda).to(
        torch.bfloat16)
    out = fused_readout(mk, qk, mv, 50, 2900, KernelConfig(sel, readout))
    torch.testing.assert_close(
        out.float(), fused_readout_plain(mk, qk, mv, 50, 2900).float(),
        rtol=2 ** -7, atol=2e-2)


def _engine_session(stcn, fusion, cfg, images, masks):
    engine = InferenceEngine(stcn, fusion, cfg)
    padded, pad = prepare_video(images)
    feats = engine.precompute_features(padded)
    state = engine.init_state(feats, masks.shape[0])
    for idx in (0, 4):
        state = engine.interact(state, feats, pad_mask(masks[:, idx], pad), idx)
    return engine, state


# the other memory reads: (strategy, KernelConfig, wrappers that must launch)
READS = {
    "select": ("select", None, (topk_select_grid,)),
    "resident": ("fused", KernelConfig(sel_method="resident"),
                 (topk_select_resident, topk_readout)),
    "chunked_chunked": ("fused", KernelConfig(sel_method="chunked",
                                              readout_method="chunked"),
                        (topk_select_chunked, topk_readout_chunked)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("read", sorted(READS))
def test_engine_on_card_other_reads(cuda, read):
    """The small engine on the card under each other memory read: its
    kernels launch, and the fp32 session matches the plain read's."""
    strategy, kcfg, wrappers = READS[read]
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    fusion = FusionNet()
    cfg = EngineConfig(mem_freq=2, top_k=8, max_interactions=4,
                       feature_chunk=2)
    images, masks = synthetic_video(6, 48, 64, num_objects=2, seed=3)
    before = [w.launches for w in wrappers]
    _, got = _engine_session(stcn, fusion, cfg._replace(
        readout_strategy=strategy, kernels=kcfg), images, masks)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    _, want = _engine_session(stcn, fusion, cfg._replace(
        readout_strategy="gather"), images, masks)
    torch.testing.assert_close(got.prob, want.prob, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("block_frames", [True, False])
def test_engine_on_card_matches_plain_read(cuda, block_frames):
    """The small engine on the card: 'auto' resolves to the kernels, which
    launch, and the fp32 session matches the plain read's."""
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    fusion = FusionNet()
    cfg = EngineConfig(mem_freq=2, top_k=8, max_interactions=4,
                       feature_chunk=2, block_frames=block_frames)
    images, masks = synthetic_video(6, 48, 64, num_objects=2, seed=3)
    probs = []
    for strategy in ("auto", "gather"):
        engine = InferenceEngine(stcn, fusion,
                                 cfg._replace(readout_strategy=strategy))
        padded, pad = prepare_video(images)
        feats = engine.precompute_features(padded)
        state = engine.init_state(feats, 2)
        before = topk_select.launches
        for idx in (0, 4):
            state = engine.interact(state, feats, pad_mask(masks[:, idx], pad),
                                    idx)
        if strategy == "auto":
            assert engine.config.readout_strategy == "fused"
            assert topk_select.launches > before
        probs.append(state.prob)
    torch.testing.assert_close(probs[0], probs[1], rtol=0, atol=1e-4)


# The default read above top_k = 256: #1's radix select (with merge passes
# above RADIX_SORT_CHUNK keys a query) and #2's large-k readout.

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [3000, 1700, 20])
@pytest.mark.parametrize("top_k", [257, 512, 2048, 3000])
def test_topk_select_large_k(cuda, dtype, valid, top_k):
    """#1 above 256 against the plain version: M = 3,000 (top_k = M takes
    the whole bank), fills of two bank blocks, one (no second block) and
    fewer valid tokens than top_k; ids may differ only at near-ties; the
    slots from the valid tokens hold (-1e30, 0); no escalation."""
    g = torch.Generator(device=cuda).manual_seed(valid + top_k)
    qk = torch.randn((333, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(dtype)
    esc = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = topk_select.launches
    vals, idx = topk_select(qk, mk, valid, top_k, escalations=esc)
    torch.cuda.synchronize()
    assert topk_select.launches == before + 1 and int(esc) == 0
    assert vals.shape == idx.shape == (top_k, 333) and idx.dtype == torch.int32
    pv, pi = topk_select_plain(qk, mk, valid, top_k + 1)
    live = min(valid, top_k)
    _assert_same_selection(vals[:live].T, idx[:live].T, pv[:live + 1].T,
                           pi[:live + 1].T, 1e-4)
    assert torch.all(vals[live:] == -1e30) and torch.all(idx[live:] == 0)
    assert int(idx.min()) >= 0 and int(idx.max()) < max(valid, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [257, 2048, 4500])
def test_topk_select_large_k_identical_keys(cuda, dtype, top_k):
    """Every score of a row ties: the top k are ids 0..k-1 across the three
    bank blocks of a 4,500-token fill."""
    rng = np.random.default_rng(8)
    mk = torch.from_numpy(np.tile(rng.standard_normal((1, 64)), (5000, 1))
                          .astype(np.float32)).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((45, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = topk_select(qk, mk, 4500, top_k)
    want = torch.arange(top_k, dtype=torch.int32, device=cuda)
    assert torch.equal(idx, want[:, None].expand(top_k, 45))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [1990, 4990])
@pytest.mark.parametrize("top_k", [257, 1000, 1990])
def test_topk_select_large_k_ties_at_threshold(cuda, dtype, valid, top_k):
    """Each of 40 keys 125 times over the bank: the threshold falls inside a
    run of exactly tied scores, within one bank block (1,990 tokens) and
    across three (4,990); the tied keys taken are the lowest ids."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((40, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (125, 1))).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((70, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = topk_select(qk, mk, valid, top_k)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, valid, top_k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid,top_k", [(20000, RADIX_SORT_CHUNK + 1),
                                         (20000, 20000), (40000, 33000)])
def test_topk_select_large_k_merge_passes(cuda, dtype, valid, top_k):
    """More keys a query than one block sorts in shared memory: sorted runs
    of RADIX_SORT_CHUNK keys merged in device memory (two runs, three, and
    five over three passes)."""
    g = torch.Generator(device=cuda).manual_seed(top_k)
    qk = torch.randn((40, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((40000, 64), generator=g, device=cuda).to(dtype)
    vals, idx = topk_select(qk, mk, valid, top_k)
    pv, pi = topk_select_plain(qk, mk, valid, top_k + 1)
    live = min(valid, top_k)
    _assert_same_selection(vals[:live].T, idx[:live].T, pv[:live + 1].T,
                           pi[:live + 1].T, 1e-4)
    assert torch.all(vals[live:] == -1e30)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [257, 3000])
def test_topk_select_large_k_empty_bank(cuda, top_k):
    qk = torch.randn((50, 64), device=cuda).to(torch.bfloat16)
    mk = torch.randn((3000, 64), device=cuda).to(torch.bfloat16)
    vals, idx = topk_select(qk, mk, 0, top_k)
    assert torch.all(vals == -1e30) and torch.all(idx == 0)


# (kind, N, M, CV, top_k, valid, K, dtype) above 256: valid < top_k, K = 2,
# CV 64, 512 and 1,024, an odd top_k; high sharing (M ~ 1,600 at top_k 512:
# dense tiles in bf16) and low sharing (M = 100,000: direct tiles)
LARGE_K_READOUT_CASES = [
    ("random", 300, 5000, 512, 512, 4000, 1, torch.bfloat16),
    ("random", 300, 5000, 512, 512, 4000, 2, torch.float32),
    ("random", 200, 5000, 1024, 2000, 4000, 1, torch.bfloat16),
    ("random", 130, 3000, 64, 2048, 1500, 2, torch.float32),
    ("ties", 100, 3000, 64, 257, 3000, 1, torch.bfloat16),
    ("random", 500, 1600, 512, 512, 1600, 1, torch.bfloat16),
    ("random", 300, 100000, 512, 512, 100000, 1, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LARGE_K_READOUT_CASES, ids=str)
def test_topk_readout_large_k(cuda, case):
    """#2 above 256 against the plain version; two runs equal bit for bit;
    its rows staged and dense stages as its plan counts them (dense stages
    where M ~ 1,600, nothing staged where M = 100,000); the chunked readout
    keeps its cap and names it."""
    kind, n, m, cv, top_k, valid, k_obj, dtype = case
    g = torch.Generator(device=cuda).manual_seed(n + cv)
    mv = torch.randn((k_obj, m, cv), generator=g, device=cuda).to(dtype)
    vals, idx = _readout_selection(kind, n, m, top_k, valid, cuda)
    counts = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = topk_readout.launches
    out = topk_readout(mv, vals, idx, counts=counts)
    torch.cuda.synchronize()
    assert topk_readout.launches == before + 1
    _assert_readout_close(out, topk_readout_plain(mv, vals, idx))
    assert torch.equal(topk_readout(mv, vals, idx), out)
    queries = large_k_geometry(n, k_obj, cv, mv.element_size(),
                               torch.cuda.get_device_properties(
                                   cuda).multi_processor_count)[0]
    _, staged, dense = readout_large_k_plain(mv, vals, idx, queries)
    assert counts.tolist() == [staged, dense]
    if m == 1600 and dtype == torch.bfloat16:
        assert dense > 0
    if m == 100000:
        assert staged == 0
    with pytest.raises(ValueError, match="at most 256"):
        topk_readout_chunked(mv, vals, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [300, 1000])
def test_fused_readout_large_k(cuda, dtype, top_k):
    """The default fused read above 256 (#1 then #2) against the plain
    fused read, with valid below and above top_k."""
    g = torch.Generator(device=cuda).manual_seed(top_k)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(dtype)
    qk = torch.randn((200, 64), generator=g, device=cuda).to(dtype)
    mv = torch.randn((2, 3000, 64), generator=g, device=cuda).to(dtype)
    for valid in (250, 3000):
        got = fused_readout(mk, qk, mv, top_k, valid)
        _assert_readout_close(got, fused_readout_plain(mk, qk, mv, top_k,
                                                       valid))


@pytest.mark.cuda
@pytest.mark.parametrize("select", ["chunked", "resident", "grid", "iterative",
                                    "sort"])
def test_other_selections_raise_above_256(cuda, select):
    """Every selection but the default one keeps [1, min(M, 256)] and names
    the cap; so do the fused reads on the other kernels."""
    qk = torch.randn((40, 64), device=cuda).to(torch.bfloat16)
    mk = torch.randn((3000, 64), device=cuda).to(torch.bfloat16)
    mv = torch.randn((1, 3000, 64), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="256"):
        select_topk(mk, qk, 257, 3000, method=select)
    if select in ("chunked", "resident"):
        with pytest.raises(ValueError, match="256"):
            fused_readout(mk, qk, mv, 257, 3000,
                          KernelConfig(sel_method=select))
    with pytest.raises(ValueError, match="256"):
        fused_readout(mk, qk, mv, 257, 3000,
                      KernelConfig(readout_method="chunked"))


# #1 above 256 where a query's first bin holds more than its cap of keys (the
# extra scorings), where every score ties, and where kk == valid (one
# scoring, then the sort of every live token).

def _radix_counters(device):
    return (torch.zeros(1, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def _radix_plan(qk, mk, valid, top_k):
    """The plain statement's bins over the plain scores (exact here)."""
    scores = _scores(mk[:valid].cpu().float(), qk.cpu().float())
    ids = torch.arange(valid).expand_as(scores)
    keys = sort_keys(scores, ids, torch.ones_like(ids, dtype=torch.bool))
    return radix_threshold(keys, valid, top_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [512, 2048])
@pytest.mark.parametrize("m", [20000, 70000])
def test_topk_select_large_k_bin_overflows_cap(cuda, dtype, top_k, m):
    """A tight cluster of integer keys (one base key, four channels moved by
    one): every score is exact in both dtypes, and 20,000 or 70,000 of them
    crowd into a few bins of the first digit, past the cap, so queries take
    extra scorings (70,000: past RADIX_ROUND tokens, whose histograms go to
    device memory).  The selection is the oracle's exactly (ties to the
    lowest id), the overflow counter and the passes are the plain
    statement's, and the counter is above 0."""
    rng = np.random.default_rng(top_k)
    mk = np.tile(rng.integers(-2, 3, 64), (m, 1))
    for _ in range(4):
        mk[np.arange(m), rng.integers(0, 64, m)] += rng.integers(-1, 2, m)
    qk = rng.integers(-2, 3, (300, 64))
    qk, mk = (torch.from_numpy(x.astype(np.float32)).to(cuda, dtype)
              for x in (qk, mk))
    esc, passes = _radix_counters(cuda)
    vals, idx = topk_select(qk, mk, m, top_k, escalations=esc,
                            scorings=passes)
    torch.cuda.synchronize()
    plan = _radix_plan(qk, mk, m, top_k)
    assert int(plan.spilled.sum()) > 0
    assert int(esc) == int(plan.spilled.sum())
    assert int(passes) == int(plan.scorings.max()) >= 3
    q, k = qk.double().cpu().numpy(), mk.double().cpu().numpy()
    s = (2 * q @ k.T - (k * k).sum(-1)) / 8.0  # exact: small integers
    order = np.lexsort((np.broadcast_to(np.arange(m), s.shape), -s), axis=1)
    np.testing.assert_array_equal(idx.cpu().numpy(), order[:, :top_k].T)
    ref_vals, _ = topk_select_plain(qk, mk, m, top_k)
    assert torch.equal(vals, ref_vals)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k", [2048, 5000])
def test_topk_select_large_k_identical_keys_past_cap(cuda, dtype, top_k):
    """20,000 identical keys: every query's bins spill down the score digits
    into the id digits, and the top k are ids 0..k-1."""
    rng = np.random.default_rng(9)
    m = 20000
    mk = torch.from_numpy(np.tile(rng.standard_normal((1, 64)), (m, 1))
                          .astype(np.float32)).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((45, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    esc, passes = _radix_counters(cuda)
    _, idx = topk_select(qk, mk, m, top_k, escalations=esc, scorings=passes)
    want = torch.arange(top_k, dtype=torch.int32, device=cuda)
    assert torch.equal(idx, want[:, None].expand(top_k, 45))
    assert int(esc) == 45 and int(passes) > 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_select_large_k_every_live_token(cuda, dtype):
    """Fill 1 (1,620 valid tokens of a 72-slot bank) at top_k 2,048 and
    N = 8,100: kk == valid, so one scoring writes every live key and the
    sort orders them all; the 428 slots past them hold (-1e30, 0)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    qk = torch.randn((8100, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((72 * FRAME_TOKENS, 64), generator=g,
                     device=cuda).to(dtype)
    esc, passes = _radix_counters(cuda)
    vals, idx = topk_select(qk, mk, FRAME_TOKENS, 2048, escalations=esc,
                            scorings=passes)
    torch.cuda.synchronize()
    assert int(esc) == 0 and int(passes) == 1
    pv, pi = topk_select_plain(qk, mk, FRAME_TOKENS, FRAME_TOKENS)
    _assert_same_selection(vals[:FRAME_TOKENS].T, idx[:FRAME_TOKENS].T,
                           pv.T, pi.T, 1e-4)
    assert torch.all(vals[FRAME_TOKENS:] == -1e30)
    assert torch.all(idx[FRAME_TOKENS:] == 0)
    # every live token once
    assert torch.equal(idx[:FRAME_TOKENS].sort(0).values,
                       torch.arange(FRAME_TOKENS, dtype=torch.int32,
                                    device=cuda)[:, None].expand(-1, 8100))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [100000, 70000])
@pytest.mark.parametrize("top_k", [512, 2048])
def test_topk_select_large_k_past_round(cuda, dtype, valid, top_k):
    """Banks of more than RADIX_ROUND valid tokens: the histograms are
    counted in rounds and added up in device memory; the selection is the
    plain version's (near-ties aside)."""
    g = torch.Generator(device=cuda).manual_seed(valid + top_k)
    qk = torch.randn((200, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((100000, 64), generator=g, device=cuda).to(dtype)
    assert valid > RADIX_ROUND
    vals, idx = topk_select(qk, mk, valid, top_k)
    pv, pi = topk_select_plain(qk, mk, valid, top_k + 1)
    _assert_same_selection(vals.T, idx.T, pv.T, pi.T, 1e-4)


# key widths: each selection kernel (transposed, raw scores) and the wrapper
# that counts its launches and pads
def _rows_transposed(select):
    def transposed(qk, mk, valid, top_k):
        vals, idx = select(qk, mk, valid, top_k, return_raw=True)
        return vals.T, idx.T
    return transposed


WIDTH_SELECTORS = {
    "tournament": (topk_select, topk_select),
    "chunked": (topk_select_chunked, topk_select_chunked),
    "resident": (topk_select_resident, topk_select_resident),
    "grid": (_grid_transposed, topk_select_grid),
    "iterative": (_rows_transposed(topk_select_iter), topk_select_iter),
    "sort": (_rows_transposed(topk_select_sort), topk_select_sort)}
# #1 at top_k 50 and 512 (its radix select), the others at 50
WIDTH_CASES = [(m, 50) for m in WIDTH_SELECTORS] + [("tournament", 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("method,top_k", WIDTH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ck", [16, 24, 128, 256])
def test_selection_kernels_at_key_widths(cuda, method, top_k, dtype, ck):
    """Keys of the widths the kernels are built for (16, 128, 256) and of
    one they take zero-padded (24, to 32, counted in ``pads``): the plain
    selection at that width, on three bank blocks.  Scores are sums of CK
    products in another order than the plain version's: atol 1e-4 up to
    CK = 64, scaled with CK / 64 above."""
    fn, counted = WIDTH_SELECTORS[method]
    g = torch.Generator(device=cuda).manual_seed(ck + top_k)
    qk = torch.randn((300, ck), generator=g, device=cuda).to(dtype)
    mk = torch.randn((5000, ck), generator=g, device=cuda).to(dtype)
    valid = 4500
    launches, pads = counted.launches, counted.pads
    vals, idx = fn(qk, mk, valid, top_k)
    torch.cuda.synchronize()
    assert counted.launches == launches + 1
    assert counted.pads == pads + (ck == 24)
    pv, pi = topk_select_plain(qk, mk, valid, top_k + 1)
    _assert_same_selection(vals.T, idx.T, pv.T, pi.T,
                           1e-4 * max(1, ck // 64))


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(WIDTH_SELECTORS))
def test_selection_kernels_refuse_keys_past_the_cap(cuda, method):
    """Keys 300 wide: every kernel's wrapper raises naming the cap, and
    nothing runs the plain version on the card instead."""
    fn, counted = WIDTH_SELECTORS[method]
    qk = torch.randn((64, 300), device=cuda)
    launches = counted.launches
    with pytest.raises(ValueError, match="256"):
        fn(qk, qk, 64, 8)
    assert counted.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("method,top_k", WIDTH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ck", [24, 32, 128])
def test_selection_kernels_divide_as_the_plain_read(cuda, method, top_k,
                                                    dtype, ck):
    """Widths whose sqrt is not a power of two (24, padded to 32; 32; 128):
    each kernel's raw scores are the plain read's quotient
    (2 q.k - |k|^2) / sqrt(CK) bit for bit, as the CPU divides it
    (PyTorch's CUDA division by a Python float multiplies by the rounded
    reciprocal instead, which can land one ulp off).  Integer keys in
    [-16, 16] make every dot product and |k|^2 exact in any order (bf16
    holds them, fp32 sums them exactly), so the scale is the one rounding.
    Ids equal: ties go to the lowest id."""
    fn, _ = WIDTH_SELECTORS[method]
    rng = np.random.default_rng(ck + top_k)
    qk = torch.from_numpy(rng.integers(-16, 17, (300, ck)).astype(np.float32))
    mk = torch.from_numpy(rng.integers(-16, 17, (5000, ck)).astype(np.float32))
    valid = 4500
    vals, idx = fn(qk.to(cuda, dtype), mk.to(cuda, dtype), valid, top_k)
    pv, pi = topk_select_plain(qk, mk, valid, top_k)
    assert torch.equal(idx.cpu(), pi)
    assert torch.equal(vals.cpu().view(torch.int32), pv.view(torch.int32))
