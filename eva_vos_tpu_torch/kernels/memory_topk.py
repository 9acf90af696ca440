"""Exact top-k memory selection: CUDA kernel wrapper and its plain version.

Counterpart of ``eva_vos_tpu/kernels/memory_topk.py:tournament_topk_t``
(the Pallas kernel ``_kernel_tournament``).  The kernel is
``csrc/memory_topk.cu``; its source note says what bounds it and how its
design answers that.

Contract (both versions): qk [N, CK], mk [M, CK] in fp32 or bf16 (the
kernel takes CK = 64) ->
(vals [top_k, N] fp32 raw scores in descending order, idx [top_k, N] int32),
over tokens < ``valid_tokens``, ties to the lowest id.  Where
valid_tokens < top_k the trailing slots hold -1e30 with unspecified (but
in-range) ids; their softmax weight is exactly 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.memory_attention import topk_scores
from . import build

_CK = 64  # the STCN key width, the one the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def topk_select_plain(qk, mk, valid_tokens, top_k: int):
    """Plain PyTorch selection (stable sort of the dense score matrix)."""
    vals, idx = topk_scores(mk, qk, top_k, valid_tokens)
    return vals.T.contiguous(), idx.T.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("memory_topk")
    lib.memory_topk_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.memory_topk_launch.restype = ctypes.c_int
    return lib


def _check_operand(name, x, dtype=None):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES or (dtype is not None and x.dtype != dtype):
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def topk_select(qk: torch.Tensor, mk: torch.Tensor, valid_tokens,
                top_k: int):
    """Top-k selection; CPU tensors take the plain version, CUDA tensors the
    kernel (which raises on any launch error)."""
    if qk.device.type == "cpu" and mk.device.type == "cpu":
        return topk_select_plain(qk, mk, valid_tokens, top_k)
    n, ck = qk.shape
    m = mk.shape[0]
    valid = m if valid_tokens is None else min(int(valid_tokens), m)
    _check_operand("qk", qk)
    _check_operand("mk", mk, qk.dtype)
    if ck != _CK or mk.shape[1] != _CK:
        raise ValueError(f"keys must be {_CK} wide: qk {tuple(qk.shape)}, "
                         f"mk {tuple(mk.shape)}")
    if not 0 < top_k <= min(m, 256):
        raise ValueError(f"top_k={top_k} must be in [1, min(M={m}, 256)]")
    vals = torch.empty((top_k, n), dtype=torch.float32, device=qk.device)
    idx = torch.empty((top_k, n), dtype=torch.int32, device=qk.device)
    lib = _lib()
    status = lib.memory_topk_launch(
        qk.data_ptr(), mk.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        n, valid, ck, top_k, _DTYPES[qk.dtype],
        torch.cuda.current_stream(qk.device).cuda_stream)
    build.check("memory_topk", lib, status)
    topk_select.launches += 1
    return vals, idx


topk_select.launches = 0
