"""Space-time memory read in plain PyTorch (counterpart of
``eva_vos_tpu/ops/memory_attention.py``).

Affinity between memory keys and query keys is the negative squared L2
distance over sqrt(CK); the per-query ``-|q|^2`` term changes neither the
ranking over memory nor the softmax, so it is dropped:
``score = (2 q.k - |k|^2) / sqrt(CK)``, accumulated in fp32, with tokens at or
above ``valid_tokens`` set to ``NEG_INF`` (-1e30, not -inf, so an all-masked
row still softmaxes to finite numbers).  Only the top-k tokens per query enter
the softmax; ties go to the LOWEST token id, as ``lax.top_k`` orders them.

This module is the plain read: the CPU path of the engine and the oracle
that the CUDA kernels in ``eva_vos_tpu_torch.kernels`` are held against.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

# queries per chunk of the dense [N, M] score matrix: bounds the plain
# read's memory at full bank size (8100 x 116,640 fp32 scores = 3.8 GB)
_QUERY_CHUNK = 1024


def resolve_strategy(strategy: str, device) -> str:
    """'auto' -> 'fused' (the CUDA kernels) on a CUDA device, else 'gather'."""
    if strategy != "auto":
        return strategy
    return "fused" if torch.device(device).type == "cuda" else "gather"


def _scores(mk: torch.Tensor, qk: torch.Tensor, valid_tokens=None) -> torch.Tensor:
    """Affinity scores [N, M] in fp32 (memory axis last).

    mk [M, CK] memory keys, qk [N, CK] query keys; tokens >= valid_tokens
    are masked to NEG_INF.
    """
    ck = mk.shape[-1]
    mk32 = mk.float()
    dot = qk.float() @ mk32.T                               # [N, M]
    m_sq = (mk32 * mk32).sum(-1)                            # [M]
    # divide (not multiply by the reciprocal): the JAX package's rounding
    scores = (2.0 * dot - m_sq[None, :]) / math.sqrt(ck)
    if valid_tokens is not None:
        token_ids = torch.arange(mk.shape[0], device=mk.device)
        scores = torch.where(token_ids[None, :] < valid_tokens, scores,
                             torch.full_like(scores, NEG_INF))
    return scores


def topk_scores(mk, qk, top_k: int, valid_tokens=None):
    """Exact top-k raw scores per query, descending, ties to the lowest id.

    Returns (vals [N, top_k] fp32, idx [N, top_k] int64).  A stable
    descending sort keeps equal scores in ascending id order; ``torch.topk``
    promises no order among ties.
    """
    vals, idx = [], []
    for lo in range(0, qk.shape[0], _QUERY_CHUNK):
        s = _scores(mk, qk[lo:lo + _QUERY_CHUNK], valid_tokens)
        v, i = torch.sort(s, dim=1, descending=True, stable=True)
        vals.append(v[:, :top_k])
        idx.append(i[:, :top_k])
    return torch.cat(vals), torch.cat(idx)


def softmax_weights(vals: torch.Tensor) -> torch.Tensor:
    """exp(v - v_0) / sum over the top-k axis (last); v_0 is the largest."""
    w = torch.exp(vals - vals[..., :1])
    return w / w.sum(-1, keepdim=True)


def memory_affinity_topk(mk, qk, top_k: int, valid_tokens=None):
    """Top-k memory tokens per query with softmax weights.

    Returns (weights [N, top_k] fp32, indices [N, top_k] int64).
    """
    vals, idx = topk_scores(mk, qk, top_k, valid_tokens)
    return softmax_weights(vals), idx


def weighted_gather(mv, w, idx):
    """mv [K, M, CV], w [N, k] fp32 weights, idx [N, k] -> [K, N, CV] in
    mv.dtype: the selected rows, weighted and summed in fp32."""
    outs = []
    for lo in range(0, idx.shape[0], _QUERY_CHUNK):
        sl = slice(lo, lo + _QUERY_CHUNK)
        gathered = mv[:, idx[sl].long(), :].float()         # [K, n, k, CV]
        outs.append(torch.einsum("nk,bnkc->bnc", w[sl], gathered))
    return torch.cat(outs, dim=1).to(mv.dtype)


def memory_readout(mk, qk, mv, top_k: int = 50, valid_tokens=None,
                   strategy: str = "gather", kernel_cfg=None):
    """Top-k attention readout.

    mk [M, CK] memory keys, qk [N, CK] query keys, mv [K, M, CV] memory
    values (K objects share one affinity).  ``strategy``: 'gather' (take
    the selected rows, weighted sum), 'scatter' (densify the sparse
    softmax into [N, M] and multiply), 'fused' (a selection kernel chained
    into a readout kernel of ``eva_vos_tpu_torch.kernels``, chosen by
    ``kernel_cfg``, a ``KernelConfig``; the JAX package's 'pallas_fused'),
    or 'select' (the split-bank selection kernel, then the gather; the JAX
    package's 'pallas').
    Returns [K, N, CV] in mv.dtype.
    """
    if strategy == "fused":
        from ..kernels.memory_readout import fused_readout

        return fused_readout(mk, qk, mv, top_k, valid_tokens, kernel_cfg)
    if strategy == "select":
        from ..kernels.memory_topk import select_topk

        w, idx = select_topk(mk, qk, top_k, valid_tokens, method="grid")
    else:
        w, idx = memory_affinity_topk(mk, qk, top_k, valid_tokens)
    if strategy in ("gather", "select"):
        return weighted_gather(mv, w, idx)
    if strategy == "scatter":
        n, m = qk.shape[0], mk.shape[0]
        dense = torch.zeros((n, m), dtype=torch.float32, device=mk.device)
        dense.scatter_add_(1, idx, w)
        return torch.einsum("nm,bmc->bnc", dense, mv.float()).to(mv.dtype)
    raise ValueError(f"unknown strategy {strategy!r}")


def memory_affinity_topk_gauss(mk, qk, top_k: int, query_hw, sigma: float,
                               valid_tokens=None):
    """Top-k affinity with gaussian locality (the reference's kernelized
    memory, ``prop_net.py:33-44, 46-51, 92-99``; no entry point reads it).

    Each memory token gets a gaussian prior centred at its best-matching
    query position (the argmax over queries restores the per-query
    ``-|q|^2`` term, which is not constant along that axis); the
    per-query exp-scores are weighted by that prior before the top-k
    selection, ties to the lowest id.

    query_hw: (h, w) of the query grid, whose row-major cells are the
    queries.  Returns (weights [N, top_k] fp32, indices [N, top_k] int64).
    """
    h, w = query_hw
    scores = _scores(mk, qk, valid_tokens)                   # [N, M]
    x_exp = torch.exp(scores - scores.max(dim=1, keepdim=True).values)
    q_sq = (qk.float() ** 2).sum(-1) / math.sqrt(mk.shape[-1])
    best_q = torch.argmax(scores - q_sq[:, None], dim=0)     # [M]
    cy, cx = (best_q // w).float(), (best_q % w).float()
    cells = torch.arange(h * w, device=mk.device)
    qy, qx = (cells // w).float(), (cells % w).float()
    g = torch.exp(-((qy[:, None] - cy[None, :]) ** 2
                    + (qx[:, None] - cx[None, :]) ** 2) / (2.0 * sigma ** 2))
    vals, idx = torch.sort(x_exp * g, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / vals.sum(dim=1, keepdim=True), idx


def full_softmax_affinity(mk, qk, valid_tokens=None) -> torch.Tensor:
    """Dense softmax affinity over the memory axis: [N, M] fp32."""
    return torch.softmax(_scores(mk, qk, valid_tokens), dim=-1)
