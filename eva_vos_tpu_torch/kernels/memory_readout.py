"""Top-k weighted value readout: CUDA kernel wrapper and its plain version,
and ``fused_readout``, the selection kernel chained into the readout kernel.

Counterpart of ``eva_vos_tpu/kernels/memory_readout.py:pallas_fused_readout``
(the Pallas kernel ``_scatter_readout_kernel``).  The kernel is
``csrc/memory_readout.cu``; its source note says what bounds it and how its
design answers that.  The JAX wrapper's padding and VMEM geometry search
have no counterpart: the CUDA kernels take any N and M.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.memory_attention import softmax_weights, weighted_gather
from . import build
from .memory_topk import _DTYPES, _check_operand, topk_select, topk_select_plain


def topk_readout_plain(mv, vals, idx):
    """Plain PyTorch readout: mv [K, M, CV], vals/idx [top_k, N] ->
    [K, N, CV] in mv.dtype, with w = exp(v - v_0) / sum in fp32."""
    return weighted_gather(mv, softmax_weights(vals.T), idx.T)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("memory_readout")
    lib.memory_readout_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.memory_readout_launch.restype = ctypes.c_int
    return lib


def topk_readout(mv: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor):
    """Readout; CPU tensors take the plain version, CUDA tensors the kernel
    (which raises on any launch error).  Every id must be < M."""
    if mv.device.type == "cpu":
        return topk_readout_plain(mv, vals, idx)
    n_obj, m, cv = mv.shape
    top_k, n = vals.shape
    _check_operand("mv", mv)
    if cv % 8:
        raise ValueError(f"value width {cv} must be a multiple of 8")
    if (vals.dtype != torch.float32 or idx.dtype != torch.int32
            or idx.shape != vals.shape or not vals.is_contiguous()
            or not idx.is_contiguous() or vals.device != mv.device
            or idx.device != mv.device):
        raise ValueError("vals/idx must be contiguous [top_k, N] fp32/int32 "
                         "on mv's device")
    out = torch.empty((n_obj, n, cv), dtype=mv.dtype, device=mv.device)
    lib = _lib()
    status = lib.memory_readout_launch(
        mv.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_obj, n, m, cv, top_k, _DTYPES[mv.dtype],
        torch.cuda.current_stream(mv.device).cuda_stream)
    build.check("memory_readout", lib, status)
    topk_readout.launches += 1
    return out


topk_readout.launches = 0


def fused_readout_plain(mk, qk, mv, top_k: int, valid_tokens=None):
    """Plain selection chained into the plain readout."""
    vals, idx = topk_select_plain(qk, mk, valid_tokens, top_k)
    return topk_readout_plain(mv, vals, idx)


def fused_readout(mk, qk, mv, top_k: int, valid_tokens=None):
    """Exact top-k attention readout through the two kernels.

    mk [M, CK], qk [N, CK], mv [K, M, CV] -> [K, N, CV] in mv.dtype.
    """
    vals, idx = topk_select(qk, mk, valid_tokens, top_k)
    return topk_readout(mv, vals, idx)
