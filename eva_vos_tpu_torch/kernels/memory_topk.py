"""Exact top-k memory selection: CUDA kernel wrappers and their plain
versions.

Counterparts of the selection kernels of ``eva_vos_tpu/kernels/memory_topk.py``:

* :func:`topk_select` — ``tournament_topk_t`` (``_kernel_tournament``),
  kernel ``csrc/memory_topk.cu:topk_kernel``;
* :func:`topk_select_chunked` — ``chunked_topk_t``
  (``_kernel_tournament_chunked``), newest first with the tau skip, kernel
  ``csrc/memory_topk.cu:topk_chunked_kernel``;
* :func:`topk_select_resident` — ``resident_topk_t`` (``_kernel_resident``),
  two passes with a threshold, kernel ``csrc/memory_topk_resident.cu``;
* :func:`topk_select_grid` — ``pallas_memory_topk(method="grid")``
  (``_kernel_grid``), split bank plus merge, kernel
  ``csrc/memory_topk_grid.cu``;
* :func:`select_topk` — ``pallas_memory_topk``: a method name to one of them.

Each source note says what bounds its kernel and how its design answers that.

Contract of the transposed selectors (the first three): qk [N, CK],
mk [M, CK] in fp32 or bf16 (the kernels take CK = 64) ->
(vals [top_k, N] fp32 raw scores in descending order, idx [top_k, N] int32),
over tokens < ``valid_tokens``, ties to the lowest id.  Where
valid_tokens < top_k the trailing slots hold -1e30 with unspecified (but
in-range) ids; their softmax weight is exactly 0.  Their plain version is
:func:`topk_select_plain`.  Each wrapper takes it for CPU tensors only; for
CUDA tensors it launches its kernel or raises, and counts launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.memory_attention import (memory_affinity_topk, softmax_weights,
                                    topk_scores)
from . import build

_CK = 64  # the STCN key width, the one the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SPLITS = 16      # memory_topk_grid.cu's kMaxSplits
_SPLIT_UNIT = 128     # bank tokens per staged tile
_TARGET_BLOCKS = 264  # two 256-thread selection blocks on each of 132 SMs


def topk_select_plain(qk, mk, valid_tokens, top_k: int):
    """Plain PyTorch selection (stable sort of the dense score matrix)."""
    vals, idx = topk_scores(mk, qk, top_k, valid_tokens)
    return vals.T.contiguous(), idx.T.to(torch.int32).contiguous()


def _bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _bind("memory_topk", "memory_topk_launch", [_P] * 4 + [_I] * 5 + [_P])
    lib.memory_topk_chunked_launch.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.memory_topk_chunked_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _grid_lib() -> ctypes.CDLL:
    return _bind("memory_topk_grid", "memory_topk_grid_launch",
                 [_P] * 6 + [_I] * 8 + [_P])


@functools.lru_cache(maxsize=None)
def _resident_lib() -> ctypes.CDLL:
    return _bind("memory_topk_resident", "memory_topk_resident_launch",
                 [_P] * 4 + [_I] * 4 + [_P, _I, _P])


def _check_operand(name, x, dtype=None):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES or (dtype is not None and x.dtype != dtype):
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_selection(qk, mk, valid_tokens, top_k: int) -> int:
    """Check a kernel's operands; returns the number of valid tokens."""
    n, ck = qk.shape
    m = mk.shape[0]
    _check_operand("qk", qk)
    _check_operand("mk", mk, qk.dtype)
    if ck != _CK or mk.shape[1] != _CK:
        raise ValueError(f"keys must be {_CK} wide: qk {tuple(qk.shape)}, "
                         f"mk {tuple(mk.shape)}")
    if not 0 < top_k <= min(m, 256):
        raise ValueError(f"top_k={top_k} must be in [1, min(M={m}, 256)]")
    return m if valid_tokens is None else max(0, min(int(valid_tokens), m))


def _on_cpu(qk, mk) -> bool:
    return qk.device.type == "cpu" and mk.device.type == "cpu"


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _transposed_outputs(qk, top_k: int):
    n = qk.shape[0]
    return (torch.empty((top_k, n), dtype=torch.float32, device=qk.device),
            torch.empty((top_k, n), dtype=torch.int32, device=qk.device))


def topk_select(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                top_k: int):
    """Top-k selection, bank oldest first (plain: topk_select_plain)."""
    if _on_cpu(qk, mk):
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    valid = _check_selection(qk, mk, valid_tokens, top_k)
    vals, idx = _transposed_outputs(qk, top_k)
    lib = _lib()
    status = lib.memory_topk_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        qk.shape[0], valid, _CK, top_k, _DTYPES[qk.dtype], _stream(qk))
    build.check("memory_topk", lib, status)
    topk_select.launches += 1
    return vals, idx


def topk_select_chunked(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                        top_k: int, no_skip: bool = False):
    """Top-k selection, bank newest first with the tau skip (``no_skip``
    turns it off); plain: topk_select_plain."""
    if _on_cpu(qk, mk):
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    valid = _check_selection(qk, mk, valid_tokens, top_k)
    vals, idx = _transposed_outputs(qk, top_k)
    lib = _lib()
    status = lib.memory_topk_chunked_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        qk.shape[0], valid, _CK, top_k, int(bool(no_skip)), _DTYPES[qk.dtype],
        _stream(qk))
    build.check("memory_topk", lib, status)
    topk_select_chunked.launches += 1
    return vals, idx


def topk_select_resident(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                         top_k: int, escalations: torch.Tensor | None = None):
    """Top-k selection in two passes over the L2-resident bank; plain:
    topk_select_plain.  ``escalations``, a CUDA int32 tensor of one element,
    gains the number of 32-query blocks that escalated to the full merge."""
    if _on_cpu(qk, mk):
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    valid = _check_selection(qk, mk, valid_tokens, top_k)
    if escalations is not None and (
            escalations.device != qk.device
            or escalations.dtype != torch.int32 or escalations.numel() != 1):
        raise ValueError("escalations must be one int32 on qk's device")
    vals, idx = _transposed_outputs(qk, top_k)
    lib = _resident_lib()
    status = lib.memory_topk_resident_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        qk.shape[0], valid, _CK, top_k,
        None if escalations is None else escalations.data_ptr(),
        _DTYPES[qk.dtype], _stream(qk))
    build.check("memory_topk_resident", lib, status)
    topk_select_resident.launches += 1
    return vals, idx


def _bank_splits(n: int, valid: int) -> tuple:
    """(split_len, n_splits) of the split-bank selection: as many splits as
    keep the 32-query tiles times the splits within one wave of two blocks
    per SM (a second, partial wave would double the time), none shorter
    than 512 tokens, at most 16; only splits below the fill."""
    tiles = -(-n // 32)
    want = max(1, min(_MAX_SPLITS, _TARGET_BLOCKS // tiles,
                      -(-valid // 512)))
    split_len = -(-max(valid, 1) // want)
    split_len = -(-split_len // _SPLIT_UNIT) * _SPLIT_UNIT
    return split_len, max(1, -(-valid // split_len))


def topk_select_grid(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                     top_k: int, return_raw: bool = False):
    """Top-k selection over a split bank -> (weights [N, top_k] fp32, ids
    [N, top_k] int32), or the raw scores in place of the weights with
    ``return_raw``.  Plain version: ``memory_affinity_topk`` (and
    ``topk_scores`` for raw scores), ids as int32."""
    if _on_cpu(qk, mk):
        fn = topk_scores if return_raw else memory_affinity_topk
        w, idx = fn(mk, qk, top_k, valid_tokens)
        return w, idx.to(torch.int32)
    valid = _check_selection(qk, mk, valid_tokens, top_k)
    n = qk.shape[0]
    split_len, n_splits = _bank_splits(n, valid)
    part_v = torch.empty((n_splits, top_k, n), dtype=torch.float32,
                         device=qk.device)
    part_i = torch.empty((n_splits, top_k, n), dtype=torch.int32,
                         device=qk.device)
    out_v = torch.empty((n, top_k), dtype=torch.float32, device=qk.device)
    out_i = torch.empty((n, top_k), dtype=torch.int32, device=qk.device)
    lib = _grid_lib()
    status = lib.memory_topk_grid_launch(
        qk.data_ptr(), mk.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), n, valid, _CK, top_k, split_len,
        n_splits, int(bool(return_raw)), _DTYPES[qk.dtype], _stream(qk))
    build.check("memory_topk_grid", lib, status)
    topk_select_grid.launches += 1
    return out_v, out_i


for _fn in (topk_select, topk_select_chunked, topk_select_resident,
            topk_select_grid):
    _fn.launches = 0

# the transposed selectors by the JAX package's method names
SELECTORS = {"tournament": topk_select, "chunked": topk_select_chunked,
             "resident": topk_select_resident}


def select_topk(mk: torch.Tensor, qk: torch.Tensor, top_k: int,
                valid_tokens=None, *, method: str, return_raw: bool = False):
    """Exact top-k per query: (softmax weights [N, top_k] fp32, or the raw
    scores with ``return_raw``; ids [N, top_k] int32).  The counterpart of
    ``pallas_memory_topk`` (``eva_vos_tpu/kernels/memory_topk.py:1096``);
    ``method`` names the kernel as there: 'grid', 'tournament', 'chunked'
    or 'resident'.  'iterative' (the JAX default) and 'sort' are not ported
    yet, so ``method`` has no default."""
    if method in ("iterative", "sort"):
        raise ValueError(f"select_topk method {method!r} is not ported yet "
                         f"(ROADMAP.md, TPU kernels still to port)")
    if method == "grid":
        return topk_select_grid(qk, mk, valid_tokens, top_k,
                                return_raw=return_raw)
    if method not in SELECTORS:
        raise ValueError(f"unknown select_topk method {method!r}")
    vals, idx = SELECTORS[method](qk, mk, valid_tokens, top_k)
    vals, idx = vals.T, idx.T
    return vals if return_raw else softmax_weights(vals), idx
