"""Top-k weighted value readout: CUDA kernel wrappers and their plain
version, and ``fused_readout``, a selection kernel chained into a readout
kernel.

Counterpart of ``eva_vos_tpu/kernels/memory_readout.py:pallas_fused_readout``
and its two Pallas kernels: ``_scatter_readout_kernel`` (kernel
``csrc/memory_readout.cu``, a weighted gather, wrapper :func:`topk_readout`)
and ``_scatter_readout_kernel_chunked`` (kernel
``csrc/memory_readout_chunked.cu`` on the device stage of
``csrc/readout_common.cuh``, wrapper :func:`topk_readout_chunked`).  Each
source note says what bounds its kernel and how its design answers that.
The stage copies each distinct selected row once per tile of queries, in
ascending id order, chunk by chunk of the bank: :func:`readout_stage_plain`
states that plan in plain PyTorch (with :func:`readout_picks`,
:func:`readout_chunks` and :func:`readout_staged_rows`), and
:func:`readout_geometry` the tiles and CV slices it is launched with.
Above 256 slots :func:`topk_readout` runs ``csrc/memory_readout.cu``'s
large-k kernel, which stages each distinct row once per tile too and sums
each tile densely on the tensor cores, sparsely, or as a direct gather:
:func:`readout_large_k_plain` states its plan (with :func:`large_k_tiles`
and :func:`large_k_geometry`).  The JAX wrapper's padding and VMEM geometry
search have no counterpart: the CUDA kernels take any N and M.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.memory_attention import softmax_weights, weighted_gather
from . import build
from .config import KernelConfig
from .memory_topk import (_DTYPES, PRUNED_MAX_K, SELECTORS, _I, _P, _bind,
                          _check_counter, _check_operand, _ptr, _sm_count,
                          _stream, topk_select_plain)


def topk_readout_plain(mv, vals, idx):
    """Plain PyTorch readout: mv [K, M, CV], vals/idx [top_k, N] ->
    [K, N, CV] in mv.dtype, with w = exp(v - v_0) / sum in fp32."""
    return weighted_gather(mv, softmax_weights(vals.T), idx.T)


READOUT_CHUNK = 1024  # readout_common.cuh's kChunk: bank ids a chunk
_NO_ID = 2 ** 31 - 1  # its kNoId: the id of a pick of weight 0
_MAX_SLICE_VECS = 64  # 16-byte columns a slice holds (kMaxCols * 32)


def readout_geometry(n: int, n_obj: int, cv: int, itemsize: int, top_k: int,
                     sms: int = 132) -> tuple:
    """(queries a tile, CV slices) of the readout stage: 64-query tiles
    while top_k <= 64 and the tiles of all objects fill half the ``sms``,
    else 32; then as many CV slices as the blocks leave SMs for, down to
    16 columns of 16 bytes a slice, and at least enough that a slice holds
    at most 64 of them (1 KB).  N = 8,100, K = 1, top_k = 50, CV = 512 bf16
    gives (64, 1): 127 blocks; N = 1,620 gives (32, 2): 102 blocks."""
    vecs = cv * itemsize // 16
    queries = 64 if top_k <= 64 and -(-n // 64) * n_obj >= sms // 2 else 32
    blocks = -(-n // queries) * n_obj
    slices = max(-(-vecs // _MAX_SLICE_VECS),
                 min(max(1, sms // blocks), max(1, vecs // 16)))
    return queries, slices


def readout_picks(vals, idx):
    """Each query's picks in the stage's order: (ids [top_k, N] int64 and
    weights exp(v - v_0) [top_k, N] fp32, both sorted by (id, slot t) along
    the picks; a pick of weight 0 has no row (id _NO_ID) and sorts last),
    and the sums of the weights [N]."""
    w = torch.exp(vals - vals[:1])
    ids = torch.where(w > 0, idx.long(), torch.full_like(idx, _NO_ID,
                                                         dtype=torch.int64))
    slot = torch.arange(vals.shape[0], device=vals.device)[:, None]
    order = (ids * 256 + slot).argsort(0)
    sw = w.gather(0, order)
    return ids.gather(0, order), sw, sw.sum(0)


def readout_chunks(rows: torch.Tensor, m: int, no_skip: bool) -> list:
    """The chunks a tile walks, in order: those of READOUT_CHUNK ids that
    hold one of its ascending distinct ``rows`` (an empty chunk costs
    nothing), or with ``no_skip`` every chunk of the bank [0, m)."""
    if no_skip:
        return list(range(-(-m // READOUT_CHUNK)))
    return (rows // READOUT_CHUNK).unique().tolist()


def readout_staged_rows(vals, idx, n_obj: int, queries: int) -> int:
    """Rows the stage copies: each distinct id of weight > 0 once per tile
    of ``queries`` queries and object."""
    tile = (torch.arange(vals.shape[1], device=vals.device) // queries
            ).expand_as(idx)
    live = torch.exp(vals - vals[:1]) > 0
    return n_obj * ((tile[live].long() << 32) | idx[live].long()
                    ).unique().numel()


def readout_stage_plain(mv, vals, idx, queries: int = 64,
                        no_skip: bool = False):
    """Plain statement of the readout stage (``csrc/readout_common.cuh``)
    -> (out [K, N, CV] in mv.dtype, rows staged, chunks walked).

    Per tile of ``queries`` queries (and object): its distinct ids of
    weight > 0, ascending, are the rows staged, one copy each; the tile
    walks the chunks of :func:`readout_chunks`, and in each chunk every
    query adds w * row over its hits there, in :func:`readout_picks`'s
    (id, slot) order, to an fp32 sum.  So every query sums its rows in
    ascending id order, with or without the skip; at the end the sum is
    divided by the query's sum of weights."""
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    sid, sw, z = readout_picks(vals, idx)
    out = torch.empty((n_obj, n, cv), dtype=torch.float32, device=mv.device)
    staged = walked = 0
    for q0 in range(0, n, queries):
        tid, tw = sid[:, q0:q0 + queries], sw[:, q0:q0 + queries]
        cols = torch.arange(tid.shape[1], device=mv.device)
        rows = tid[tid != _NO_ID].unique()
        staged += n_obj * rows.numel()
        acc = torch.zeros((n_obj, tid.shape[1], cv), device=mv.device)
        ptr = torch.zeros(tid.shape[1], dtype=torch.int64, device=mv.device)
        for c in readout_chunks(rows, m, no_skip):
            walked += 1
            while True:  # each query's next hit in the chunk, if any
                at = ptr.clamp(max=top_k - 1)
                cur = tid[at, cols]
                take = (ptr < top_k) & (cur < (c + 1) * READOUT_CHUNK)
                if not take.any():
                    break
                q = cols[take]
                acc[:, q] += tw[at[q], q][None, :, None] * mv[:, cur[q]].float()
                ptr[q] += 1
        out[:, q0:q0 + queries] = acc / z[q0:q0 + queries][None, :, None]
    return out.to(mv.dtype), staged, walked


LARGE_K_ROWS = 32          # memory_readout.cu's kS: rows a stage
LARGE_K_WINDOW = 2 ** 17   # its kWinIds: the ids [0, 131,072) a tile stages
LARGE_K_DENSE = (1, 8)     # its kDenseNum, kDenseDen: a bf16 tile is summed
#                            dense when picks * 8 >= queries * rows
LARGE_K_SHARE = 4          # its kShare: staged when picks >= 4 * rows,
LARGE_K_SHARE_FAR = 2      # its kShareFar: or 2 * rows when the tile's ids
LARGE_K_NEAR = 32 << 20    # span more than its kNear bytes of rows
LARGE_K_MAX_ROWS = 65536   # its kS * kMaxStages: the most rows it stages


def large_k_geometry(n: int, n_obj: int, cv: int, itemsize: int,
                     sms: int = 132) -> tuple:
    """(queries a tile, CV slices) of the large-k readout: 64-query tiles
    when the tiles of all objects fill half the ``sms``, else 32; the CV
    slices as :func:`readout_geometry` cuts them.  N = 8,100, K = 1,
    CV = 512 bf16 gives (64, 1): 127 blocks."""
    return readout_geometry(n, n_obj, cv, itemsize, 1, sms)


def large_k_tiles(vals, idx, queries: int, row_bytes: int,
                  bf16: bool) -> list:
    """Each tile's branch of the large-k readout of value rows of
    ``row_bytes`` (CV x itemsize), [(mode, picks, rows)]: its live picks
    (weight > 0) P, its distinct live ids R, and 'dense' (bf16 values)
    when P * 8 >= Qv * R (Qv: its queries), 'sparse' when P >= 4 R, or
    P >= 2 R when its live ids span more than LARGE_K_NEAR bytes of rows,
    else 'direct', also when an id lies past LARGE_K_WINDOW or
    R > LARGE_K_MAX_ROWS."""
    live = torch.exp(vals - vals[:1]) > 0
    num, den = LARGE_K_DENSE
    out = []
    for q0 in range(0, vals.shape[1], queries):
        ids = idx[:, q0:q0 + queries][live[:, q0:q0 + queries]].long()
        qv = min(queries, vals.shape[1] - q0)
        picks, rows = ids.numel(), ids.unique().numel()
        mode = "direct"
        if 0 < rows <= LARGE_K_MAX_ROWS and not bool(
                (ids >= LARGE_K_WINDOW).any()):
            span = (int(ids.max()) - int(ids.min()) + 1) * row_bytes
            share = (LARGE_K_SHARE_FAR if span > LARGE_K_NEAR
                     else LARGE_K_SHARE)
            if bf16 and picks * den >= num * qv * rows:
                mode = "dense"
            elif picks >= share * rows:
                mode = "sparse"
        out.append((mode, picks, rows))
    return out


def readout_large_k_plain(mv, vals, idx, queries: int = 64):
    """Plain statement of the large-k readout (``csrc/memory_readout.cu``,
    ``readout_large_k_kernel``) -> (out [K, N, CV] in mv.dtype, rows
    staged, stages summed dense).

    Per tile of ``queries`` queries (and object), in the branch that
    :func:`large_k_tiles` gives it: 'dense' and 'sparse' stage its distinct
    live ids once each (LARGE_K_ROWS rows a stage) and sum W [Qv x rows]
    (each pick's weight at its query and row) times the staged rows;
    'dense' splits W into two bf16 terms, as the tensor cores take it.
    'direct' sums each query's picks from the bank.  Every query's sum is
    divided by its sum of weights."""
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    w = torch.exp(vals - vals[:1])
    z = w.sum(0)
    tiles = large_k_tiles(vals, idx, queries, cv * mv.element_size(),
                          mv.dtype == torch.bfloat16)
    out = torch.empty((n_obj, n, cv), dtype=torch.float32, device=mv.device)
    staged = dense = 0
    for (mode, _, n_rows), q0 in zip(tiles, range(0, n, queries)):
        tw, ti = w[:, q0:q0 + queries], idx[:, q0:q0 + queries].long()
        if mode == "direct":
            acc = torch.einsum("tq,otqc->oqc", tw, mv[:, ti].float())
        else:
            live = tw > 0
            rows = ti[live].unique()
            cols = torch.arange(tw.shape[1], device=mv.device).expand_as(ti)
            wt = torch.zeros((tw.shape[1], rows.numel()), device=mv.device)
            wt.index_put_((cols[live], torch.searchsorted(rows, ti[live])),
                          tw[live], accumulate=True)
            v = mv[:, rows].float()
            if mode == "dense":
                hi = wt.to(torch.bfloat16).float()
                acc = hi @ v + (wt - hi).to(torch.bfloat16).float() @ v
                dense += n_obj * -(-n_rows // LARGE_K_ROWS)
            else:
                acc = wt @ v
            staged += n_obj * n_rows
        out[:, q0:q0 + queries] = acc / z[q0:q0 + queries][None, :, None]
    return out.to(mv.dtype), staged, dense


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind("memory_readout", "memory_readout_launch",
                 [_P] * 4 + [_I] * 8 + [_P] * 3)


@functools.lru_cache(maxsize=None)
def _chunked_lib() -> ctypes.CDLL:
    return _bind("memory_readout_chunked", "memory_readout_chunked_launch",
                 [_P] * 4 + [_I] * 9 + [_P, _P])


def _check_readout(mv, vals, idx, most: int | None = None):
    """Check a readout kernel's operands, top_k in [1, most] (``most``
    None: any top_k >= 1)."""
    _check_operand("mv", mv)
    if mv.shape[2] % 8:
        raise ValueError(f"value width {mv.shape[2]} must be a multiple of 8")
    if (vals.dtype != torch.float32 or idx.dtype != torch.int32
            or idx.shape != vals.shape or not vals.is_contiguous()
            or not idx.is_contiguous() or vals.device != mv.device
            or idx.device != mv.device):
        raise ValueError("vals/idx must be contiguous [top_k, N] fp32/int32 "
                         "on mv's device")
    top_k = vals.shape[0]
    if top_k < 1:
        raise ValueError(f"top_k={top_k} must be at least 1")
    if most is not None and top_k > most:
        raise ValueError(f"top_k={top_k} must be in [1, {most}]: this "
                         f"readout takes at most {most}")


def topk_readout(mv: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                 counts: torch.Tensor | None = None):
    """Readout, one value row per (query, slot); CPU tensors take the plain
    version (topk_readout_plain), CUDA tensors the kernel (which raises on
    any launch error).  Every id must be < M; any top_k >= 1.  Up to 256
    slots a weighted gather; above, the large-k kernel
    (:func:`readout_large_k_plain` states it), with scratch of 8 B a pick
    of each of its blocks.  ``counts``, a CUDA int32 tensor of two
    elements, gains the large-k kernel's rows staged and stages summed
    dense (nothing up to 256 slots)."""
    if mv.device.type == "cpu":
        return topk_readout_plain(mv, vals, idx)
    _check_readout(mv, vals, idx)
    if counts is not None and (counts.device != mv.device or counts.dtype
                               != torch.int32 or counts.numel() != 2):
        raise ValueError("counts must be two int32 on mv's device")
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    out = torch.empty((n_obj, n, cv), dtype=mv.dtype, device=mv.device)
    queries = slices = 0
    scratch = None
    if top_k > PRUNED_MAX_K:
        queries, slices = large_k_geometry(n, n_obj, cv, mv.element_size(),
                                           _sm_count(mv.device))
        blocks = -(-n // queries) * n_obj * slices
        scratch = torch.empty(2 * blocks * queries * top_k, dtype=torch.int32,
                              device=mv.device)
    lib = _lib()
    status = lib.memory_readout_launch(
        mv.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_obj, n, m, cv, top_k, queries, slices, _DTYPES[mv.dtype],
        _stream(mv), _ptr(scratch), _ptr(counts))
    build.check("memory_readout", lib, status)
    topk_readout.launches += 1
    return out


def topk_readout_chunked(mv: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, no_skip: bool = False,
                         staged_rows: torch.Tensor | None = None):
    """Readout through the stage of ``csrc/readout_common.cuh``
    (:func:`readout_stage_plain` states it): each tile of queries stages
    each distinct row once, walking the value bank in 1,024-token chunks
    and skipping those no selected id lands in (``no_skip`` visits every
    one, the same output bit for bit).  The contract and plain version of
    :func:`topk_readout`, top_k in [1, 256].  ``staged_rows``, a CUDA int32
    tensor of one element, gains the rows the kernel staged
    (:func:`readout_staged_rows` counts them)."""
    if mv.device.type == "cpu":
        return topk_readout_plain(mv, vals, idx)
    _check_readout(mv, vals, idx, PRUNED_MAX_K)
    _check_counter(staged_rows, mv, "staged_rows")
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    queries, slices = readout_geometry(n, n_obj, cv, mv.element_size(), top_k,
                                       _sm_count(mv.device))
    out = torch.empty((n_obj, n, cv), dtype=mv.dtype, device=mv.device)
    lib = _chunked_lib()
    status = lib.memory_readout_chunked_launch(
        mv.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_obj, n, m, cv, top_k, queries, slices, int(bool(no_skip)),
        _DTYPES[mv.dtype], _stream(mv), _ptr(staged_rows))
    build.check("memory_readout_chunked", lib, status)
    topk_readout_chunked.launches += 1
    return out


topk_readout.launches = topk_readout_chunked.launches = 0

# the readout kernels by the JAX package's method names
READOUTS = {"grid": topk_readout, "chunked": topk_readout_chunked}


def fused_readout_plain(mk, qk, mv, top_k: int, valid_tokens=None):
    """Plain selection chained into the plain readout."""
    vals, idx = topk_select_plain(qk, mk, valid_tokens, top_k)
    return topk_readout_plain(mv, vals, idx)


def fused_readout(mk, qk, mv, top_k: int, valid_tokens=None,
                  kcfg: KernelConfig | None = None):
    """Exact top-k attention readout through a selection and a readout
    kernel, chosen by ``kcfg`` as ``pallas_fused_readout`` chooses them
    (``eva_vos_tpu/kernels/memory_readout.py:369-371, 403-407``): selection
    'tournament' (default), 'chunked' or 'resident'; readout 'grid'
    (default) or 'chunked'.  An unknown method raises.  On the card the
    default kernels take any top_k in [1, M]; the other methods take
    [1, min(M, 256)] and raise above it.

    mk [M, CK], qk [N, CK], mv [K, M, CV] -> [K, N, CV] in mv.dtype.
    """
    sel, readout, sel_notau, readout_noskip = (kcfg or KernelConfig()).methods()
    kw = {"no_skip": sel_notau} if sel == "chunked" else {}
    vals, idx = SELECTORS[sel](qk, mk, valid_tokens, top_k, **kw)
    kw = {"no_skip": readout_noskip} if readout == "chunked" else {}
    return READOUTS[readout](mv, vals, idx, **kw)
