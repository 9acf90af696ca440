"""Exact top-k memory selection: CUDA kernel wrappers and their plain
versions.

Counterparts of the selection kernels of ``eva_vos_tpu/kernels/memory_topk.py``:

* :func:`topk_select` — ``tournament_topk_t`` (``_kernel_tournament``),
  per-block pruning and ranking as in the sort kernel (the shared
  ``csrc/topk_prune.cuh``), then a merge that writes the transposed layout,
  kernels ``csrc/memory_topk.cu:topk_prune_block_kernel`` and
  ``topk_merge_t_kernel``; :func:`merge_lists_t` states the merge.  Above
  top_k = 256 (any top_k up to M) a radix select over the same scores
  that scores the bank twice in the common case, sorted and transposed
  (``topk_key_norms_kernel``, ``topk_radix_kernel``,
  ``topk_cand_select_kernel``, ``topk_sort_rows_kernel`` or
  ``topk_sort_chunks_kernel``, ``topk_rank_merge_kernel``,
  ``topk_keys_t_kernel``); :func:`radix_threshold` and :func:`radix_lists`
  state it;
* :func:`topk_select_chunked` — ``chunked_topk_t``
  (``_kernel_tournament_chunked``), the same kernels with the bank blocks
  newest first and a running floor per query in place of the TPU kernel's
  tau skip; :func:`floored_lists` and :func:`list_floor` state the floor;
* :func:`topk_select_resident` — ``resident_topk_t`` (``_kernel_resident``),
  one block per query tile walks its segment of the L2-resident bank
  newest first on the tensor cores, keeping a running k-th key per query
  and a compacted candidate buffer, kernel ``csrc/memory_topk_resident.cu``
  (segments merged by the default selection's merge);
  :func:`resident_lists` states the walk;
* :func:`topk_select_grid` — ``pallas_memory_topk(method="grid")``
  (``_kernel_grid``), kernel ``csrc/memory_topk_grid.cu``: the sort
  kernel's function and device code (the row-output stage of
  ``csrc/topk_prune.cuh``);
* :func:`topk_select_iter` — ``pallas_memory_topk(method="iterative")``
  (``_kernel_iter``), the resident kernel's walk (``csrc/resident_walk.cuh``)
  with a row epilogue, kernel ``csrc/memory_topk_iter.cu`` (segments merged
  by a cut of their lists); :func:`resident_rows` states it;
* :func:`topk_select_sort` — ``pallas_memory_topk(method="sort")``
  (``_kernel``), per-block pruning to a few candidates and a ranking of
  those, then a merge of the sorted lists (no merge with one live bank
  block), kernel ``csrc/memory_topk_sort.cu``;
  :func:`sort_prune_threshold` states its pruning rule for the tests;
* :func:`select_topk` — ``pallas_memory_topk``: a method name to one of them,
  'iterative' by default as there.

Above top_k = 256 (PRUNED_MAX_K) the designs of all but the first hold a
query's list in 512-key buffers, so every selection takes #1's radix
select there, as the JAX kernels all compute one function: the transposed
selectors with its transposed write, the row selectors (grid, iterative,
sort) with a row epilogue in its place (``topk_keys_rows_kernel``, the
softmax weights or raw scores as [N, top_k] rows); :func:`radix_rows`
states it.  There ``escalations`` counts what #1's does (the queries past
the radix cap), and the counters of the k <= 256 designs do nothing:
``floored_rows`` and ``no_skip`` (chunked), ``compactions`` (resident,
iterative); the result is the same function.

Each source note says what bounds its kernel and how its design answers that.

Contract of the transposed selectors (the first three): qk [N, CK],
mk [M, CK] in fp32 or bf16, 1 <= CK <= MAX_KEY_WIDTH (:func:`key_width`: the
kernels are built for the widths KEY_WIDTHS; keys of another width are
zero-padded to the next one, which is exact, and counted in
``<wrapper>.pads``) ->
(vals [top_k, N] fp32 raw scores in descending order, idx [top_k, N] int32),
over tokens < ``valid_tokens``, ties to the lowest id.  Where
valid_tokens < top_k the trailing slots hold -1e30 with unspecified (but
in-range) ids; their softmax weight is exactly 0.  On the card every
selection takes top_k in [1, M], as the JAX kernels do (PRUNED_MAX_K is the
boundary between the routes, not a cap).  Their plain version is
:func:`topk_select_plain`.  The row selectors (grid, iterative, sort) return
the same selection as [N, top_k] softmax weights (or raw scores with
``return_raw``) and int32 ids; their plain version is
``memory_affinity_topk`` (``topk_scores`` for raw scores).  Each wrapper
takes its plain version for CPU tensors only; for CUDA tensors it launches
its kernel or raises, and counts launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops.memory_attention import (memory_affinity_topk, softmax_weights,
                                    topk_scores)
from . import build

KEY_WIDTHS = build.KEY_WIDTHS  # topk_common.cuh's padded widths CKP
MAX_KEY_WIDTH = KEY_WIDTHS[-1]  # topk_common.cuh's kMaxKeyWidth
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SELECT_BLOCK = 2048  # bank tokens per block of the block selections
_MAX_LISTS = 2048     # memory_topk.cu's kMaxLists: bank blocks it merges
_MAX_ROW_LISTS = 6000  # topk_prune.cuh's kMaxRowLists: the row merge's lists
PRUNED_MAX_K = 256  # the largest top_k of the k <= 256 designs; above it
#                     every selection takes the radix select
RADIX_SORT_CHUNK = 8192  # memory_topk.cu's kSortChunk: keys sorted in shared
#                          memory; longer lists take merge passes
RADIX_CAP = 4096  # candidates a query keeps at least (below: valid)
RADIX_MAX_CAP = 16384  # memory_topk.cu's kRMaxCap: and at most
RADIX_ROW_SORT = 1024  # the longest list memory_topk.cu sorts a warp a query


def topk_select_plain(qk, mk, valid_tokens, top_k: int):
    """Plain PyTorch selection (stable sort of the dense score matrix)."""
    vals, idx = topk_scores(mk, qk, top_k, valid_tokens)
    return vals.T.contiguous(), idx.T.to(torch.int32).contiguous()


def key_width(ck: int) -> tuple:
    """Keys ``ck`` wide -> (CKP, pad): the width of KEY_WIDTHS the kernels
    take them at, the least one at or above ``ck``, and the zero channels
    the wrappers append (0 at an instantiated width).  Above MAX_KEY_WIDTH
    (or below 1) raises ValueError naming the cap."""
    if not 1 <= ck <= MAX_KEY_WIDTH:
        raise ValueError(f"keys {ck} wide: the selection kernels take widths "
                         f"1 to {MAX_KEY_WIDTH} (the cap)")
    ckp = next(w for w in KEY_WIDTHS if w >= ck)
    return ckp, ckp - ck


def pad_keys(x: torch.Tensor, ckp: int) -> torch.Tensor:
    """Keys [..., CK] with zero channels appended up to ``ckp``: each dot
    product and |k|^2 stays exactly what it was (a product with 0 adds 0),
    so the selection at the true width's scale is unchanged."""
    return torch.nn.functional.pad(x, (0, ckp - x.shape[-1])).contiguous()


def _bind(library: str, fn: str, argtypes) -> ctypes.CDLL:
    """``build.load(library)`` with its function ``fn`` bound; a selection's
    library is ``<name>@<CKP>``, one for each padded key width."""
    lib = build.load(library)
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib(ckp: int) -> ctypes.CDLL:
    lib = _bind(f"memory_topk@{ckp}", "memory_topk_launch",
                [_P] * 4 + [_I] * 5 + [_P] * 3)
    lib.memory_topk_chunked_launch.argtypes = [_P] * 4 + [_I] * 6 + [_P] * 5
    lib.memory_topk_chunked_launch.restype = ctypes.c_int
    lib.memory_topk_radix_launch.argtypes = [_P] * 4 + [_I] * 5 + [_P] * 9 + [
        _I, _I]
    lib.memory_topk_radix_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _iter_lib(ckp: int) -> ctypes.CDLL:
    return _bind(f"memory_topk_iter@{ckp}", "memory_topk_iter_launch",
                 [_P] * 5 + [_I] * 5 + [_P, _I, _I, _P])


@functools.lru_cache(maxsize=None)
def _rows_lib(name: str, ckp: int) -> ctypes.CDLL:
    """The library of a selection of the row-output stage (sort, grid)."""
    return _bind(f"{name}@{ckp}", f"{name}_launch",
                 [_P] * 5 + [_I] * 7 + [_P, _P])


@functools.lru_cache(maxsize=None)
def _resident_lib(ckp: int) -> ctypes.CDLL:
    return _bind(f"memory_topk_resident@{ckp}",
                 "memory_topk_resident_launch",
                 [_P] * 5 + [_I] * 5 + [_P, _I, _P])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_operand(name, x, dtype=None, layout=True):
    """A CUDA tensor of a kernel's dtype (``dtype`` when given), and with
    ``layout`` contiguous and 16-byte aligned (a padded copy is both)."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES or (dtype is not None and x.dtype != dtype):
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if layout and (not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_selection(wrapper, qk, mk, valid_tokens, top_k: int):
    """Check a kernel's operands, top_k in [1, M] and the keys' width
    (:func:`key_width`) -> (qk, mk at the kernel's width: zero-padded where
    CK is not one of KEY_WIDTHS, which adds one to ``wrapper.pads``; the
    number of valid tokens; the true CK, which the kernel's scale takes)."""
    m, ck = mk.shape[0], qk.shape[1]
    if mk.shape[1] != ck:
        raise ValueError(f"keys of two widths: qk {tuple(qk.shape)}, "
                         f"mk {tuple(mk.shape)}")
    ckp, pad = key_width(ck)
    _check_operand("qk", qk, layout=not pad)
    _check_operand("mk", mk, qk.dtype, layout=not pad)
    if not 0 < top_k <= m:
        raise ValueError(f"top_k={top_k} must be in [1, M={m}]")
    valid = m if valid_tokens is None else max(0, min(int(valid_tokens), m))
    if pad:  # the kernels read tokens below valid only
        qk, mk = pad_keys(qk, ckp), pad_keys(mk[:max(valid, 1)], ckp)
        wrapper.pads += 1
    return qk, mk, valid, ck


def _check_counter(counter, qk, name="escalations"):
    if counter is not None and (
            counter.device != qk.device
            or counter.dtype != torch.int32 or counter.numel() != 1):
        raise ValueError(f"{name} must be one int32 on qk's device")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _on_cpu(qk, mk) -> bool:
    return qk.device.type == "cpu" and mk.device.type == "cpu"


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _transposed_outputs(qk, top_k: int):
    n = qk.shape[0]
    return (torch.empty((top_k, n), dtype=torch.float32, device=qk.device),
            torch.empty((top_k, n), dtype=torch.int32, device=qk.device))


def _row_outputs(qk, top_k: int):
    n = qk.shape[0]
    return (torch.empty((n, top_k), dtype=torch.float32, device=qk.device),
            torch.empty((n, top_k), dtype=torch.int32, device=qk.device))


def _row_selection_plain(qk, mk, valid_tokens, top_k: int, return_raw: bool):
    """Plain version of the row selectors: softmax weights (or raw scores)
    and int32 ids, [N, top_k]."""
    fn = topk_scores if return_raw else memory_affinity_topk
    w, idx = fn(mk, qk, top_k, valid_tokens)
    return w, idx.to(torch.int32)


def _block_lists(qk, n_live: int, top_k: int):
    """The block selections' scratch [N, n_live, top_k] of 64-bit keys, or
    None with one live bank block (no merge); the resident walk's for its
    segments."""
    if n_live == 1:
        return None
    return torch.empty((qk.shape[0], n_live, top_k), dtype=torch.int64,
                       device=qk.device)


def _check_lists(valid: int, most: int) -> int:
    n_live = _live_blocks(valid)
    if n_live > most:
        raise ValueError(f"{valid} valid tokens exceed the selection's "
                         f"{most * _SELECT_BLOCK}")
    return n_live


def topk_select(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                top_k: int, escalations: torch.Tensor | None = None,
                scorings: torch.Tensor | None = None):
    """Top-k selection by pruning each bank block's scores (as
    :func:`topk_select_sort`) and merging the blocks' sorted lists into the
    transposed outputs; with one live block the block kernel writes them
    and no merge runs (plain: topk_select_plain).  ``escalations``, a CUDA
    int32 tensor of one element, gains the number of (query, bank block)
    rows that took the exact escalation.  Above PRUNED_MAX_K, any top_k up
    to M takes the radix select (:func:`radix_lists` states it); there
    ``escalations`` gains the number of queries whose first bin held more
    than :func:`radix_cap` keys, and ``scorings``, a CUDA int32 tensor of
    one element, is raised to the most passes over the bank that a query
    tile took (:func:`radix_threshold`'s ``scorings``); it is left as it is
    at PRUNED_MAX_K and below."""
    if _on_cpu(qk, mk):
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    if top_k > PRUNED_MAX_K:
        return _topk_select_radix(topk_select, qk, mk, valid_tokens, top_k,
                                  escalations, scorings)
    qk, mk, valid, ck = _check_selection(topk_select, qk, mk, valid_tokens,
                                         top_k)
    _check_counter(escalations, qk)
    _check_counter(scorings, qk, "scorings")
    part = _block_lists(qk, _check_lists(valid, _MAX_LISTS), top_k)
    vals, idx = _transposed_outputs(qk, top_k)
    lib = _lib(qk.shape[1])
    status = lib.memory_topk_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        qk.shape[0], valid, ck, top_k, _DTYPES[qk.dtype], _stream(qk),
        _ptr(part), _ptr(escalations))
    build.check("memory_topk", lib, status)
    topk_select.launches += 1
    return vals, idx


def radix_cap(valid: int, top_k: int) -> int:
    """Candidates a query of the radix select keeps: four for each of the
    top_k, within [RADIX_CAP, RADIX_MAX_CAP] (a deeper k-th key falls in a
    fuller bin), or the valid tokens when fewer (no bin holds more)."""
    return max(1, min(valid, RADIX_MAX_CAP, max(RADIX_CAP, 4 * top_k)))


def _topk_select_radix(wrapper, qk, mk, valid_tokens, top_k: int,
                       escalations=None, scorings=None,
                       return_raw: bool | None = None):
    """Every selection above PRUNED_MAX_K, for ``wrapper`` (which counts
    the launch and the pad): the key norms, the radix select, the
    candidates' top to the lists, the lists' sort (a warp a query up to
    RADIX_ROW_SORT keys; above, chunks with merge passes above
    RADIX_SORT_CHUNK keys), kernels of ``csrc/memory_topk.cu``; then the
    transposed write (``return_raw`` None: vals, idx [top_k, N]) or the row
    epilogue (the softmax weights, or the raw scores with ``return_raw``,
    and the ids as [N, top_k] rows: :func:`radix_rows`)."""
    qk, mk, valid, ck = _check_selection(wrapper, qk, mk, valid_tokens,
                                         top_k)
    _check_counter(escalations, qk)
    _check_counter(scorings, qk, "scorings")
    n, kk, cap = qk.shape[0], min(top_k, valid), radix_cap(valid, top_k)
    dev = qk.device
    keys = norms = meta = cand = keys2 = hist = None
    if kk:
        keys = torch.empty((n, kk), dtype=torch.int64, device=dev)
        norms = torch.empty(-(-valid // RADIX_NORMS_PAD) * RADIX_NORMS_PAD,
                            dtype=torch.float32, device=dev)
        meta = torch.empty((n, 2), dtype=torch.int32, device=dev)
        if kk < valid:
            cand = torch.empty((n, cap), dtype=torch.int64, device=dev)
            if valid > RADIX_ROUND:
                hist = torch.empty((n, RADIX_HIST_BINS), dtype=torch.int32,
                                   device=dev)
        if kk > RADIX_SORT_CHUNK:
            keys2 = torch.empty_like(keys)
    if return_raw is None:
        vals, idx = _transposed_outputs(qk, top_k)
        rows = 0
    else:
        vals, idx = _row_outputs(qk, top_k)
        rows = 2 if return_raw else 1
    lib = _lib(qk.shape[1])
    status = lib.memory_topk_radix_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(), n,
        valid, ck, top_k, _DTYPES[qk.dtype], _stream(qk), _ptr(keys),
        _ptr(keys2), _ptr(cand), _ptr(meta), _ptr(norms), _ptr(hist),
        _ptr(escalations), _ptr(scorings), cap, rows)
    build.check("memory_topk", lib, status)
    wrapper.launches += 1
    return vals, idx


def topk_select_chunked(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                        top_k: int, no_skip: bool = False,
                        escalations: torch.Tensor | None = None,
                        floored_rows: torch.Tensor | None = None):
    """Top-k selection as :func:`topk_select`, with the bank blocks ranked
    newest first and a running floor per query (:func:`floored_lists`):
    a block's row keeps only the keys at or above the k-th key of some
    already ranked block of its query, and a row whose keys all lie below
    that floor is emptied.  ``no_skip`` turns the floor off (the JAX
    ``sel_notau`` ablation).  Plain version: topk_select_plain.
    ``escalations`` as for :func:`topk_select`; ``floored_rows``, a CUDA
    int32 tensor of one element, gains the number of (query, bank block)
    rows that the floor emptied.  Above PRUNED_MAX_K, any top_k up to M
    takes :func:`topk_select`'s radix select (the same function, newest
    first or not); ``escalations`` gains what it gains there, and
    ``no_skip`` and ``floored_rows`` do nothing."""
    if _on_cpu(qk, mk):
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    if top_k > PRUNED_MAX_K:
        _check_counter(floored_rows, qk, "floored_rows")
        return _topk_select_radix(topk_select_chunked, qk, mk, valid_tokens,
                                  top_k, escalations)
    qk, mk, valid, ck = _check_selection(topk_select_chunked, qk, mk,
                                         valid_tokens, top_k)
    _check_counter(escalations, qk)
    _check_counter(floored_rows, qk, "floored_rows")
    n, n_live = qk.shape[0], _check_lists(valid, _MAX_LISTS)
    part = _block_lists(qk, n_live, top_k)
    floor = (torch.empty(n, dtype=torch.int64, device=qk.device)
             if n_live > 1 and not no_skip else None)
    vals, idx = _transposed_outputs(qk, top_k)
    lib = _lib(qk.shape[1])
    status = lib.memory_topk_chunked_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(), n,
        valid, ck, top_k, int(bool(no_skip)), _DTYPES[qk.dtype], _stream(qk),
        _ptr(part), _ptr(floor), _ptr(escalations), _ptr(floored_rows))
    build.check("memory_topk", lib, status)
    topk_select_chunked.launches += 1
    return vals, idx


def topk_select_resident(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                         top_k: int, compactions: torch.Tensor | None = None):
    """Top-k selection by query tiles that walk the L2-resident bank newest
    first with a running k-th key per query and a compacted candidate
    buffer (:func:`resident_lists` states the walk), in
    :func:`resident_segments` segments whose sorted lists the default
    selection's merge joins; plain: topk_select_plain.  ``compactions``, a
    CUDA int32 tensor of one element, gains the number of compactions of
    candidate buffers during the walks (:func:`resident_lists` counts
    them), summed over queries and segments.  Above PRUNED_MAX_K, any
    top_k up to M takes :func:`topk_select`'s radix select (no walk:
    ``compactions`` is left as it is)."""
    if _on_cpu(qk, mk):
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    if top_k > PRUNED_MAX_K:
        _check_counter(compactions, qk, "compactions")
        return _topk_select_radix(topk_select_resident, qk, mk, valid_tokens,
                                  top_k)
    qk, mk, valid, ck = _check_selection(topk_select_resident, qk, mk,
                                         valid_tokens, top_k)
    _check_counter(compactions, qk, "compactions")
    n = qk.shape[0]
    segments = resident_segments(n, valid, top_k, _sm_count(qk.device))
    part = _block_lists(qk, segments, top_k)
    vals, idx = _transposed_outputs(qk, top_k)
    lib = _resident_lib(qk.shape[1])
    status = lib.memory_topk_resident_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        _ptr(part), n, valid, ck, top_k, segments, _ptr(compactions),
        _DTYPES[qk.dtype], _stream(qk))
    build.check("memory_topk_resident", lib, status)
    topk_select_resident.launches += 1
    return vals, idx


def _live_blocks(valid: int) -> int:
    """Bank blocks of the block selections below the fill (one at least, so
    that an empty bank still writes its -1e30 slots).  With one, the default
    selection writes its outputs from the block kernel: no merge."""
    return max(1, -(-valid // _SELECT_BLOCK))


def topk_select_iter(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                     top_k: int, return_raw: bool = False,
                     compactions: torch.Tensor | None = None):
    """Top-k selection by the resident kernel's walk (query tiles walking
    the L2-resident bank newest first with a running k-th key per query and
    a compacted candidate buffer) with a row epilogue -> (weights, or raw
    scores with ``return_raw``, [N, top_k] fp32; ids [N, top_k] int32), in
    :func:`iter_segments` segments whose sorted lists a merge joins
    (:func:`resident_rows` states it).  Plain version:
    ``memory_affinity_topk`` / ``topk_scores``.  ``compactions`` as for
    :func:`topk_select_resident`.  Above PRUNED_MAX_K, any top_k up to M
    takes :func:`topk_select`'s radix select with the row epilogue
    (:func:`radix_rows` states it; no walk: ``compactions`` is left as it
    is)."""
    if _on_cpu(qk, mk):
        return _row_selection_plain(qk, mk, valid_tokens, top_k, return_raw)
    if top_k > PRUNED_MAX_K:
        _check_counter(compactions, qk, "compactions")
        return _topk_select_radix(topk_select_iter, qk, mk, valid_tokens,
                                  top_k, return_raw=bool(return_raw))
    qk, mk, valid, ck = _check_selection(topk_select_iter, qk, mk,
                                         valid_tokens, top_k)
    _check_counter(compactions, qk, "compactions")
    n = qk.shape[0]
    segments = iter_segments(n, valid, top_k, _sm_count(qk.device))
    part = _block_lists(qk, segments, top_k)
    out_v, out_i = _row_outputs(qk, top_k)
    lib = _iter_lib(qk.shape[1])
    status = lib.memory_topk_iter_launch(
        qk.data_ptr(), mk.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        _ptr(part), n, valid, ck, top_k, segments, _ptr(compactions),
        int(bool(return_raw)), _DTYPES[qk.dtype], _stream(qk))
    build.check("memory_topk_iter", lib, status)
    topk_select_iter.launches += 1
    return out_v, out_i


def _select_rows(name: str, wrapper, qk, mk, valid_tokens, top_k: int,
                 return_raw: bool, escalations):
    """Launch library ``name``'s selection of the row-output stage (the sort
    and grid kernels, ``csrc/topk_prune.cuh``) for ``wrapper``, counted in
    its ``launches`` -> (out_v, out_i) [N, top_k]; above PRUNED_MAX_K the
    radix select with the row epilogue (:func:`radix_rows`)."""
    if top_k > PRUNED_MAX_K:
        return _topk_select_radix(wrapper, qk, mk, valid_tokens, top_k,
                                  escalations, return_raw=bool(return_raw))
    qk, mk, valid, ck = _check_selection(wrapper, qk, mk, valid_tokens,
                                         top_k)
    _check_counter(escalations, qk)
    n_live = _check_lists(valid, _MAX_ROW_LISTS)
    part = _block_lists(qk, n_live, top_k)
    out_v, out_i = _row_outputs(qk, top_k)
    lib = _rows_lib(name, qk.shape[1])
    status = getattr(lib, f"{name}_launch")(
        qk.data_ptr(), mk.data_ptr(), _ptr(part), out_v.data_ptr(),
        out_i.data_ptr(), qk.shape[0], valid, ck, top_k, n_live,
        int(bool(return_raw)), _DTYPES[qk.dtype], _stream(qk),
        _ptr(escalations))
    build.check(name, lib, status)
    wrapper.launches += 1
    return out_v, out_i


def topk_select_sort(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                     top_k: int, return_raw: bool = False,
                     escalations: torch.Tensor | None = None):
    """Top-k selection by pruning each bank block's scores to the keys at or
    above :func:`sort_prune_threshold`, ranking those, and merging the
    blocks' sorted top-k lists (with one live block the block kernel writes
    the rows and no merge runs); outputs and plain version as
    :func:`topk_select_iter`.  ``escalations``, a CUDA int32 tensor of one
    element, gains the number of (query, bank block) rows whose survivors
    overflowed the kernel's candidate list and took its exact bisection.
    Above PRUNED_MAX_K, any top_k up to M takes :func:`topk_select`'s radix
    select with the row epilogue (:func:`radix_rows`), and ``escalations``
    gains what it gains there."""
    if _on_cpu(qk, mk):
        return _row_selection_plain(qk, mk, valid_tokens, top_k, return_raw)
    return _select_rows("memory_topk_sort", topk_select_sort, qk, mk,
                        valid_tokens, top_k, return_raw, escalations)


def topk_select_grid(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                     top_k: int, return_raw: bool = False,
                     escalations: torch.Tensor | None = None):
    """The 'select' read's selection -> (weights [N, top_k] fp32, ids
    [N, top_k] int32), or the raw scores in place of the weights with
    ``return_raw``: the function of :func:`topk_select_sort`, and on the
    card its device code (the shared row-output stage), with its own
    library and launch count; above PRUNED_MAX_K its radix route too.
    ``escalations`` as there.  Plain version: ``memory_affinity_topk``
    (``topk_scores`` for raw scores), ids as int32."""
    if _on_cpu(qk, mk):
        return _row_selection_plain(qk, mk, valid_tokens, top_k, return_raw)
    return _select_rows("memory_topk_grid", topk_select_grid, qk, mk,
                        valid_tokens, top_k, return_raw, escalations)


SORT_CAPACITY = 512  # memory_topk_sort.cu's kCap: candidates a row keeps


def sort_prune_groups(top_k: int) -> int:
    """Groups of a bank block's row in the sort kernel's pruning rule."""
    return 128 if top_k <= 64 else 256 if top_k <= 128 else 512


def sort_keys(scores: torch.Tensor, ids: torch.Tensor,
              live: torch.Tensor) -> torch.Tensor:
    """The sort kernel's 64-bit keys (ordered score bits, ~id) of fp32
    ``scores`` [..., B], as int64 shifted by -2^63 so that signed order is
    the kernel's unsigned order: (score desc, id asc), distinct for distinct
    ids.  A dead column (``live`` False) has the score bits 0, below every
    live key."""
    u = scores.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u | 2 ** 31)
    order = torch.where(live, order, torch.zeros_like(order))
    low = ~ids.to(torch.int64) & 0xFFFFFFFF
    return (order - 2 ** 31) * 2 ** 32 + low


def sort_prune_threshold(keys: torch.Tensor, top_k: int,
                         groups: int | None = None) -> torch.Tensor:
    """Plain statement of the sort kernel's pruning threshold [...] for rows
    of keys [..., B] (:func:`sort_keys`): the top_k-th largest of the maxima
    of the score bits (the keys' high words) over the groups
    {c : c mod G == g} (G = ``groups``, by default the kernel's
    :func:`sort_prune_groups`), at least 1, as the least key with those
    bits.  The top_k largest maxima come from top_k distinct tokens, so the
    row's top_k keys lie at or above it, ties included."""
    groups = groups or sort_prune_groups(top_k)
    bits = keys >> 32  # the score bits, less 2^31 (floor: exact)
    maxima = bits.unflatten(-1, (-1, groups)).amax(-2)
    tau = maxima.topk(top_k, dim=-1).values[..., -1]
    return tau.clamp(min=1 - 2 ** 31) * 2 ** 32


def unpack_keys(keys: torch.Tensor):
    """Keys (:func:`sort_keys`) -> (fp32 scores, int32 ids); a key with the
    score bits 0 (dead) -> (-1e30, 0), as the kernels write it."""
    order = (keys >> 32) + 2 ** 31
    bits = torch.where(order >= 2 ** 31, order & 0x7FFFFFFF, order ^ 0xFFFFFFFF)
    scores = bits.to(torch.int32).view(torch.float32)
    ids = (~keys & 0xFFFFFFFF).to(torch.int32)
    dead = order == 0
    return (torch.where(dead, torch.full_like(scores, -1e30), scores),
            torch.where(dead, torch.zeros_like(ids), ids))


def merge_lists_t(lists: torch.Tensor, top_k: int):
    """Plain statement of the default selection's merge: per query the
    top_k largest keys of its bank blocks' sorted lists [N, blocks, k]
    (keys are distinct), unpacked to the transposed (vals [top_k, N],
    idx [top_k, N]).  With one block the list itself is the answer, which
    the block kernel writes with no merge."""
    merged = lists.flatten(1).topk(top_k, dim=1).values
    vals, idx = unpack_keys(merged)
    return vals.T.contiguous(), idx.T.contiguous()


DEAD_KEY = -2 ** 63  # the kernels' key 0 (sort_keys' shift): an empty slot

# memory_topk.cu's digits of the radix select over the 64-bit keys (score
# bits, then ~id): (shift, width) from the top, five of RADIX_BITS, then 9
RADIX_BITS = 11
RADIX_DIGITS = tuple((53 - 11 * i, RADIX_BITS) for i in range(5)) + ((0, 9),)
RADIX_ROUND = 65520  # memory_topk.cu's kRRound: tokens a tile's 16-bit
#                      histograms count before they go to RADIX_HIST_BINS-bin
#                      32-bit ones in device memory
RADIX_HIST_BINS = 2 ** RADIX_BITS
RADIX_NORMS_PAD = 16  # memory_topk.cu's kNormsPad: the norms' length unit


class RadixBins(NamedTuple):
    """Per query [N], the final bin of the radix select
    (:func:`radix_threshold`): its keys are those in [lo, hi]; ``greater``
    keys lie above hi and ``count`` in the bin, of which the ``need``
    largest complete the top kk; ``scorings`` the passes over the bank the
    query takes (the kernel's tile of 32 queries takes its most);
    ``spilled`` whether its first bin held more than the cap."""
    lo: torch.Tensor
    hi: torch.Tensor
    greater: torch.Tensor
    count: torch.Tensor
    need: torch.Tensor
    scorings: torch.Tensor
    spilled: torch.Tensor


def radix_threshold(keys: torch.Tensor, valid: int, top_k: int,
                    cap: int | None = None) -> RadixBins:
    """Plain statement of the large-k selection's digits over keys
    [N, >= valid] (:func:`sort_keys`; tokens past ``valid`` never count;
    ``cap`` by default :func:`radix_cap`), kk = min(top_k, valid) >= 1.

    With kk == valid every live key is the answer: one pass over the bank
    (scorings 1), no bin (lo = hi = DEAD_KEY, greater = kk).  Otherwise
    pass 1 counts the first digit of RADIX_DIGITS of every live key (the
    keys' bits as the kernel's unsigned words) and picks the bin at which
    the counts from the top reach the rank kk; the keys above it are in
    the answer and the rank becomes the rank within the bin.  Pass 2 keeps
    the bin's keys as candidates when they number at most ``cap``; else it
    counts their next digit and picks that digit's bin the same way, and
    so on (a pass each) until a bin fits.  Keys are distinct, so the last
    digit's bin holds one key at most."""
    n, kk = keys.shape[0], min(top_k, valid)
    cap = radix_cap(valid, top_k) if cap is None else cap
    one = torch.ones(n, dtype=torch.int64)
    if kk == valid:
        dead = torch.full((n,), DEAD_KEY, dtype=torch.int64)
        return RadixBins(dead, dead.clone(), kk * one, 0 * one, 0 * one, one,
                         torch.zeros(n, dtype=torch.bool))
    u = keys[:, :valid] ^ DEAD_KEY  # the unsigned keys' bits
    pre = torch.zeros(n, dtype=torch.int64)
    mask = torch.zeros(n, dtype=torch.int64)
    rank, greater, scorings = kk * one, 0 * one, one.clone()
    lo, hi, count = pre.clone(), pre.clone(), pre.clone()
    active = torch.ones(n, dtype=torch.bool)
    spilled = None
    for shift, width in RADIX_DIGITS:
        bins = 2 ** width
        match = ((u ^ pre[:, None]) & mask[:, None]) == 0
        digit = (u >> shift) & (bins - 1)
        hist = torch.zeros((n, bins), dtype=torch.int64).scatter_add_(
            1, digit, match.long())
        from_top = hist.flip(1).cumsum(1)                 # bins from the top
        pos = (from_top >= rank[:, None]).long().argmax(1)
        b = bins - 1 - pos
        in_bin = hist.gather(1, b[:, None])[:, 0]
        above = from_top.gather(1, pos[:, None])[:, 0] - in_bin
        rank = torch.where(active, rank - above, rank)
        greater = torch.where(active, greater + above, greater)
        scorings = scorings + active.long()
        pre = torch.where(active, pre | (b << shift), pre)
        ones = torch.tensor(bins - 1, dtype=torch.int64) << shift  # wraps
        mask = torch.where(active, mask | ones, mask)
        if spilled is None:
            spilled = in_bin > cap
        done = active & (in_bin <= cap)
        low = (1 << shift) - 1
        lo = torch.where(done, pre ^ DEAD_KEY, lo)
        hi = torch.where(done, (pre | low) ^ DEAD_KEY, hi)
        count = torch.where(done, in_bin, count)
        active &= ~done
        if not active.any():
            break
    return RadixBins(lo, hi, greater, count, rank, scorings, spilled)


def radix_lists(keys: torch.Tensor, valid: int, top_k: int,
                cap: int | None = None):
    """Plain statement of the large-k selection over keys [N, >= valid]
    (:func:`sort_keys`) -> (vals [top_k, N], idx [top_k, N]), as the
    kernels write them.  With :func:`radix_threshold`'s bins, a query's
    answer is its keys above its bin and the ``need`` largest of the keys
    in it (the candidates; keys order by score, then by lowest id), sorted
    descending; the slots from kk = min(top_k, valid) hold (-1e30, 0)."""
    n, kk = keys.shape[0], min(top_k, valid)
    lists = torch.full((n, top_k), DEAD_KEY, dtype=torch.int64)
    if kk:
        bins = radix_threshold(keys, valid, top_k, cap)
        live = keys[:, :valid]
        dead = torch.full_like(live, DEAD_KEY)
        in_bin = (live >= bins.lo[:, None]) & (live <= bins.hi[:, None])
        cands = torch.where(in_bin, live, dead).sort(1, descending=True)
        least = cands.values.gather(1, (bins.need - 1).clamp(min=0)[:, None])
        taken = (live > bins.hi[:, None]) | (
            in_bin & (bins.need[:, None] > 0) & (live >= least))
        lists[:, :kk] = torch.where(taken, live, dead).topk(kk, dim=1).values
    vals, idx = unpack_keys(lists)
    return vals.T.contiguous(), idx.T.contiguous()


def radix_rows(keys: torch.Tensor, valid: int, top_k: int,
               return_raw: bool = False):
    """Plain statement of the row selections above PRUNED_MAX_K (the radix
    select with the row epilogue) over keys [N, >= valid]
    (:func:`sort_keys`) -> (softmax weights exp(v - v_0) / sum, v_0 the
    first (largest) score, or the raw scores with ``return_raw``,
    [N, top_k] fp32; ids [N, top_k] int32): :func:`radix_lists` as rows.
    The slots from kk = min(top_k, valid) hold weight 0 (raw -1e30) and
    id 0; with kk = 0 every weight is 1 / top_k, as the plain softmax of
    the -1e30 scores gives."""
    vals, idx = radix_lists(keys, valid, top_k)
    vals, idx = vals.T.contiguous(), idx.T.contiguous()
    return (vals if return_raw else softmax_weights(vals)), idx


def floored_lists(keys: torch.Tensor, top_k: int,
                  floor: torch.Tensor) -> torch.Tensor:
    """Plain statement of the newest-first selection's block lists: of each
    (query, bank block) row of keys [..., B] (:func:`sort_keys`), the top_k
    keys at or above both :func:`sort_prune_threshold` and the row's
    ``floor`` [...], sorted, DEAD_KEY past those.  The kernel's floor is a
    key the k-th key of some already ranked block of the query lies at or
    above (:func:`list_floor`), so every winner of the query lies at or
    above it too, and the merged lists (:func:`merge_lists_t`) are the plain
    selection whatever the floors were.  A row whose keys all lie below its
    floor is all DEAD_KEY (the kernel writes only its head: a merge never
    advances past a dead key)."""
    tau = torch.maximum(sort_prune_threshold(keys, top_k), floor)
    kept = torch.where(keys >= tau[..., None], keys,
                       torch.full_like(keys, DEAD_KEY))
    return kept.topk(top_k, dim=-1).values


def list_floor(lists: torch.Tensor) -> torch.Tensor:
    """The floor that sorted block lists [..., k] raise their query's to:
    the k-th key lowered to the least key of its score bits, or DEAD_KEY
    (no floor) where the list holds fewer than k live keys."""
    kth = lists[..., -1]
    return torch.where(kth == DEAD_KEY, kth, kth >> 32 << 32)


RESIDENT_STEP = 128  # resident_walk.cuh's kStep: tokens a step


def resident_geometry(top_k: int) -> tuple:
    """(queries a block, candidate buffer's keys) of the resident kernel:
    (64, 256) for top_k <= 128, else (32, 512); after a compaction a buffer
    holds top_k <= capacity - RESIDENT_STEP keys, so a step never
    overflows it."""
    return (64, 256) if top_k <= 128 else (32, 512)


def resident_segments(n: int, valid: int, top_k: int, sms: int = 132,
                      unit: int = _SELECT_BLOCK) -> int:
    """Bank segments S of the resident walk: as many as the query tiles
    leave SMs for (``sms`` // tiles), at most one a live ``unit`` tokens of
    the bank (the resident selection's: a 2,048-token bank block), at least
    one.  N = 8,100 (127 tiles of 64) gives 1; N = 1,620 (26 tiles) gives 5
    on a 132-SM card at 5 or more live units."""
    tiles = -(-n // resident_geometry(top_k)[0])
    live = -(-valid // unit)
    return max(1, min(live, sms // tiles))


ITER_SEGMENT = 2 * RESIDENT_STEP  # the iterative selection's segment unit
ITER_MERGE_KEYS = 512  # resident_walk.cuh's kCutMergeKeys: S * top_k merged


def iter_segments(n: int, valid: int, top_k: int, sms: int = 132) -> int:
    """Bank segments of the iterative selection: :func:`resident_segments`
    with one segment at most a live ITER_SEGMENT tokens, so that a bank too
    small to fill the card with tiles (N = 1,620, one 1,620-token frame:
    five segments of two or three steps, not one of 13) spreads over more
    SMs, and at most ITER_MERGE_KEYS // top_k segments, the lists its merge
    takes; at 2,048 tokens or more a segment the rule is the resident
    selection's."""
    return min(resident_segments(n, valid, top_k, sms, ITER_SEGMENT),
               max(1, ITER_MERGE_KEYS // top_k))


def resident_lists(keys: torch.Tensor, valid: int, top_k: int,
                   segments: int = 1):
    """Plain statement of the resident kernel's walk over keys [N, >= valid]
    (:func:`sort_keys`; tokens past ``valid`` are never admitted) ->
    (sorted lists [N, segments, top_k], DEAD_KEY past the live keys;
    compactions during the walks, summed over queries and segments).

    The live bank is cut into RESIDENT_STEP-token steps; segment s takes
    steps [s * T // S, (s + 1) * T // S) of the T = ceil(valid / 128), and
    walks them from the last (newest) to the first.  Per (query, segment),
    a step admits every key above the running threshold (DEAD_KEY, the
    kernel's 0, until the first compaction) into the candidate buffer.
    Queries go in tiles of :func:`resident_geometry`'s queries (rows
    [t Q, (t + 1) Q)), one kernel block a (tile, segment): after a step
    other than the segment's last in which some buffer of the tile holds
    more than capacity - RESIDENT_STEP keys, every buffer of the tile with
    more than top_k keys is compacted: cut to its top_k keys, the k-th of
    which becomes its threshold.  After the walk the buffer's top_k keys
    are the segment's list.  A threshold is the k-th key of a subset of the
    tokens, so no winner is refused and :func:`merge_lists_t` of the lists
    is the plain selection."""
    n = keys.shape[0]
    queries, cap = resident_geometry(top_k)
    tile = torch.arange(n) // queries
    n_steps = -(-valid // RESIDENT_STEP)
    dead = torch.full((n, RESIDENT_STEP), DEAD_KEY, dtype=torch.int64)
    lists = torch.full((n, segments, top_k), DEAD_KEY, dtype=torch.int64)
    compactions = 0
    for seg in range(segments):
        first, last = seg * n_steps // segments, (seg + 1) * n_steps // segments
        # the buffer as a set: its keys, DEAD_KEY in the free slots
        buf = torch.full((n, cap), DEAD_KEY, dtype=torch.int64)
        count = torch.zeros(n, dtype=torch.int64)
        thr = torch.full((n,), DEAD_KEY, dtype=torch.int64)
        for step in range(last - 1, first - 1, -1):
            lo = step * RESIDENT_STEP
            hi = min(lo + RESIDENT_STEP, valid)
            admit = keys[:, lo:hi] > thr[:, None]
            new = torch.where(admit, keys[:, lo:hi], dead[:, :hi - lo])
            count += admit.sum(1)
            buf = torch.cat([buf, new], 1).topk(cap, dim=1).values
            if step == first:  # the last compaction follows the walk
                break
            wave = torch.zeros(int(tile[-1]) + 1, dtype=torch.bool)
            wave[tile[count > cap - RESIDENT_STEP]] = True
            full = wave[tile] & (count > top_k)
            compactions += int(full.sum())
            thr = torch.where(full, buf[:, top_k - 1], thr)
            buf[full, top_k:] = DEAD_KEY
            count = torch.where(full, torch.full_like(count, top_k), count)
        lists[:, seg] = buf.topk(top_k, dim=1).values
    return lists, compactions


def cut_threshold(keys: torch.Tensor, top_k: int):
    """Plain statement of the iterative kernel's cut of a candidate buffer
    (``resident_walk.cuh``'s kth_key) over its live keys [c > top_k]
    (:func:`sort_keys`) -> (the top_k-th largest key, bisection rounds):
    first the largest score bits t with at least top_k keys at or above
    them, between the keys' least and largest score bits; then, where more
    than top_k keys are at or above t, the key itself among those tied on
    t.  Keys are distinct, so exactly top_k keys are at or above it."""
    u = [int(x) + 2 ** 63 for x in keys.tolist()]  # the kernel's unsigned keys
    high = [x >> 32 for x in u]
    lo, hi, at_lo, rounds = min(high), max(high) + 1, len(u), 0
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        c = sum(h >= mid for h in high)
        lo, hi, at_lo = (mid, hi, c) if c >= top_k else (lo, mid, at_lo)
        rounds += 1
    if at_lo == top_k:  # the least key of score bits lo
        kth = (lo << 32) | min(x & 0xFFFFFFFF for x in u if x >> 32 == lo)
    else:
        a, b = lo << 32, (lo + 1) << 32
        while b - a > 1:
            mid = a + (b - a) // 2
            a, b = (mid, b) if sum(x >= mid for x in u) >= top_k else (a, mid)
            rounds += 1
        kth = a
    return kth - 2 ** 63, rounds


def resident_rows(keys: torch.Tensor, valid: int, top_k: int,
                  segments: int = 1, return_raw: bool = False):
    """Plain statement of the iterative selection (the walk with the row
    epilogue) over keys [N, >= valid] (:func:`sort_keys`) -> (weights
    exp(v - v_0) / sum, or the raw scores with ``return_raw``, [N, top_k]
    fp32; ids [N, top_k] int32; compactions): the :func:`resident_lists` of
    its segments, and per query the top_k keys of those sorted lists (with
    one segment, its list; with several, the merge), unpacked -1e30 and id
    0 past the live keys, whose weight is exactly 0."""
    lists, compactions = resident_lists(keys, valid, top_k, segments)
    vals, idx = unpack_keys(lists.flatten(1).topk(top_k, dim=1).values)
    return (vals if return_raw else softmax_weights(vals)), idx, compactions


for _fn in (topk_select, topk_select_chunked, topk_select_resident,
            topk_select_grid, topk_select_iter, topk_select_sort):
    _fn.launches = 0
    _fn.pads = 0  # calls whose keys were zero-padded to a KEY_WIDTHS width

# the transposed selectors by the JAX package's method names
SELECTORS = {"tournament": topk_select, "chunked": topk_select_chunked,
             "resident": topk_select_resident}
# the selectors that return [N, top_k] rows
ROW_SELECTORS = {"iterative": topk_select_iter, "sort": topk_select_sort,
                 "grid": topk_select_grid}


def select_topk(mk: torch.Tensor, qk: torch.Tensor, top_k: int,
                valid_tokens=None, *, method: str = "iterative",
                return_raw: bool = False):
    """Exact top-k per query: (softmax weights [N, top_k] fp32, or the raw
    scores with ``return_raw``; ids [N, top_k] int32).  The counterpart of
    ``pallas_memory_topk`` (``eva_vos_tpu/kernels/memory_topk.py:1096``);
    ``method`` names the kernel as there: 'iterative' (the default), 'sort',
    'grid', 'tournament', 'chunked' or 'resident'.  Any other name raises."""
    if method in ROW_SELECTORS:
        return ROW_SELECTORS[method](qk, mk, valid_tokens, top_k,
                                     return_raw=return_raw)
    if method not in SELECTORS:
        raise ValueError(f"unknown select_topk method {method!r}")
    vals, idx = SELECTORS[method](qk, mk, valid_tokens, top_k)
    vals, idx = vals.T, idx.T
    return vals if return_raw else softmax_weights(vals), idx
