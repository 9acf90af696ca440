"""Top-k weighted value readout: CUDA kernel wrappers and their plain
version, and ``fused_readout``, a selection kernel chained into a readout
kernel.

Counterpart of ``eva_vos_tpu/kernels/memory_readout.py:pallas_fused_readout``
and its two Pallas kernels: ``_scatter_readout_kernel`` (kernel
``csrc/memory_readout.cu``, wrapper :func:`topk_readout`) and
``_scatter_readout_kernel_chunked`` (kernel ``csrc/memory_readout_chunked.cu``,
wrapper :func:`topk_readout_chunked`).  Each source note says what bounds
its kernel and how its design answers that.  The JAX wrapper's padding and
VMEM geometry search have no counterpart: the CUDA kernels take any N and M.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.memory_attention import softmax_weights, weighted_gather
from . import build
from .config import KernelConfig
from .memory_topk import (_DTYPES, SELECTORS, _I, _P, _bind, _check_operand,
                          _stream, topk_select_plain)


def topk_readout_plain(mv, vals, idx):
    """Plain PyTorch readout: mv [K, M, CV], vals/idx [top_k, N] ->
    [K, N, CV] in mv.dtype, with w = exp(v - v_0) / sum in fp32."""
    return weighted_gather(mv, softmax_weights(vals.T), idx.T)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind("memory_readout", "memory_readout_launch",
                 [_P] * 4 + [_I] * 6 + [_P])


@functools.lru_cache(maxsize=None)
def _chunked_lib() -> ctypes.CDLL:
    return _bind("memory_readout_chunked", "memory_readout_chunked_launch",
                 [_P] * 4 + [_I] * 7 + [_P])


def _check_readout(mv, vals, idx):
    _check_operand("mv", mv)
    if mv.shape[2] % 8:
        raise ValueError(f"value width {mv.shape[2]} must be a multiple of 8")
    if (vals.dtype != torch.float32 or idx.dtype != torch.int32
            or idx.shape != vals.shape or not vals.is_contiguous()
            or not idx.is_contiguous() or vals.device != mv.device
            or idx.device != mv.device):
        raise ValueError("vals/idx must be contiguous [top_k, N] fp32/int32 "
                         "on mv's device")


def topk_readout(mv: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor):
    """Readout, one value row per (query, slot); CPU tensors take the plain
    version (topk_readout_plain), CUDA tensors the kernel (which raises on
    any launch error).  Every id must be < M."""
    if mv.device.type == "cpu":
        return topk_readout_plain(mv, vals, idx)
    _check_readout(mv, vals, idx)
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    out = torch.empty((n_obj, n, cv), dtype=mv.dtype, device=mv.device)
    lib = _lib()
    status = lib.memory_readout_launch(
        mv.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_obj, n, m, cv, top_k, _DTYPES[mv.dtype], _stream(mv))
    build.check("memory_readout", lib, status)
    topk_readout.launches += 1
    return out


def topk_readout_chunked(mv: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, no_skip: bool = False):
    """Readout that walks the value bank in 1,024-token chunks, skipping
    those no selected id lands in (``no_skip`` visits every one), and reads
    each hit row once per 16-query tile.  The same contract and plain
    version (topk_readout_plain) as :func:`topk_readout`."""
    if mv.device.type == "cpu":
        return topk_readout_plain(mv, vals, idx)
    _check_readout(mv, vals, idx)
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    if cv * mv.element_size() > 2048:
        raise ValueError(f"value width {cv} exceeds the chunked readout's "
                         f"2 KB rows (1024 bf16 or 512 fp32 channels)")
    out = torch.empty((n_obj, n, cv), dtype=mv.dtype, device=mv.device)
    lib = _chunked_lib()
    status = lib.memory_readout_chunked_launch(
        mv.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_obj, n, m, cv, top_k, int(bool(no_skip)), _DTYPES[mv.dtype],
        _stream(mv))
    build.check("memory_readout_chunked", lib, status)
    topk_readout_chunked.launches += 1
    return out


topk_readout.launches = topk_readout_chunked.launches = 0


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
    (default) or 'chunked'.  An unknown method raises.

    mk [M, CK], qk [N, CK], mv [K, M, CV] -> [K, N, CV] in mv.dtype.
    """
    sel, readout, sel_notau, readout_noskip = (kcfg or KernelConfig()).methods()
    kw = {"no_skip": sel_notau} if sel == "chunked" else {}
    vals, idx = SELECTORS[sel](qk, mk, valid_tokens, top_k, **kw)
    if readout == "chunked":
        return topk_readout_chunked(mv, vals, idx, no_skip=readout_noskip)
    return topk_readout(mv, vals, idx)
