"""Memory-bank-sharded top-k attention readout (counterpart of
``eva_vos_tpu/parallel/sharded_attention.py``).

The space-time memory bank is sharded across the ranks of a mesh along its
token axis.  Each rank scores its shard against the replicated query keys
and selects its local top-k; the ranks all-gather the small candidate sets
(fp32 scores, int32 global ids), each merges them to the exact global
top-k, and each contributes the readout terms of the tokens it owns to an
all-reduced sum.  The result equals the single-device read up to the order
of float additions, and the collectives move O(N * top_k) bytes per rank,
whatever the bank size (:func:`comm_model_bytes`).

On a CUDA tensor the local selection is the engine's hand-written one: the
default exact top-k (``kernels.topk_select``, ``csrc/memory_topk.cu``), or
the newest-first or resident selection that ``kernel_cfg.sel_method``
names.  They return what the JAX package's ``lax.top_k`` returns here:
raw scores in descending order, ties to the lowest id.  On the CPU it is
the plain ``topk_scores``.

The readout partial is not a kernel.  The readout kernels normalise the
softmax over the picks they are given and write ``mv``'s dtype, and the
partial needs the global normaliser and fp32 terms, summed across ranks
before the one cast to ``mv``'s dtype.  So the partial is the JAX body's
gather-einsum, in fp32, chunked over queries as ``weighted_gather`` is.
"""

from __future__ import annotations

import torch

from ..ops.memory_attention import softmax_weights, topk_scores, weighted_gather
from .mesh import Mesh, all_gather, all_reduce


def _local_topk(mk, qk, k: int, valid: int, kernel_cfg):
    """This shard's top-k raw scores and local ids, [N, k] fp32 / int32."""
    if mk.device.type == "cpu":
        vals, idx = topk_scores(mk, qk, k, valid)
        return vals, idx.to(torch.int32)
    from ..kernels.config import KernelConfig
    from ..kernels.memory_topk import SELECTORS

    sel, _, sel_notau, _ = (kernel_cfg or KernelConfig()).methods()
    kw = {"no_skip": sel_notau} if sel == "chunked" else {}
    vals, idx = SELECTORS[sel](qk, mk, valid, k, **kw)
    return vals.T, idx.T


def sharded_memory_readout(mk, qk, mv, top_k: int, mesh: Mesh,
                           valid_tokens=None, kernel_cfg=None):
    """mk [M_local, CK] / mv [K, M_local, CV]: this rank's shard of the
    bank, tokens ``[rank * M_local, (rank + 1) * M_local)``; qk [N, CK]
    replicated.  Tokens at or above ``valid_tokens`` (global) are masked.
    Returns [K, N, CV] in mv.dtype, the same on every rank."""
    m_local = mk.shape[0]
    offset = mesh.rank * m_local
    valid = m_local * mesh.size if valid_tokens is None else int(valid_tokens)
    valid_local = min(max(valid - offset, 0), m_local)

    k_local = min(top_k, m_local)
    vals, idx = _local_topk(mk, qk, k_local, valid_local, kernel_cfg)
    glob_idx = idx + offset

    # the candidates, shard-major along each query's row: [N, S * k]
    n = qk.shape[0]
    cand_vals = all_gather(vals.contiguous(), mesh).transpose(0, 1).reshape(n, -1)
    cand_idx = all_gather(glob_idx.contiguous(), mesh).transpose(0, 1).reshape(n, -1)
    # a stable sort keeps equal scores in shard-major order, the lowest
    # global id first, as lax.top_k keeps the lowest position
    k_eff = min(top_k, cand_vals.shape[1])
    top_vals, pos = torch.sort(cand_vals, dim=1, descending=True, stable=True)
    top_vals, pos = top_vals[:, :k_eff], pos[:, :k_eff]
    top_idx = cand_idx.gather(1, pos)
    w = softmax_weights(top_vals)

    # this rank's terms: weight 0 on the picks another rank owns
    local_sel = top_idx - offset
    in_shard = (local_sel >= 0) & (local_sel < m_local)
    sel = local_sel.clamp(0, m_local - 1)
    w_eff = torch.where(in_shard, w, torch.zeros_like(w))
    part = weighted_gather(mv, w_eff, sel, out_dtype=torch.float32)
    return all_reduce(part, mesh).to(mv.dtype)


def comm_model_bytes(n_queries: int, top_k: int, cv: int, k_obj: int,
                     n_shards: int) -> dict:
    """Analytic per-rank collective volume of ``sharded_memory_readout``.

    * all-gather of the candidate sets: every rank receives the others'
      [N, k_local] fp32 scores + int32 global ids
      -> 2 * 4 * N * min(top_k, m_local) * n_shards bytes;
    * all-reduce of the fp32 partial readout [K, N, CV]
      -> 4 * K * N * CV bytes reduced per rank (a ring all-reduce moves
      ~2x the buffer per rank whatever the number of ranks).

    Nothing scales with the bank size M: the bank stays on its ranks, and
    only candidates and the readout cross the interconnect.
    """
    gather = 2 * 4 * n_queries * top_k * n_shards
    psum = 2 * 4 * k_obj * n_queries * cv
    return {"all_gather_bytes": gather, "psum_bytes": psum,
            "total_bytes": gather + psum}


def collective_bytes(fn, mesh: Mesh, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return the result bytes of the
    collectives it issued on ``mesh``, by operation, and their total (the
    counterpart of ``collective_bytes_from_hlo``, which reads them from
    the compiled HLO)."""
    before = dict(mesh.collective_bytes)
    fn(*args, **kwargs)
    out = {op: mesh.collective_bytes[op] - before[op] for op in before}
    out["total_bytes"] = sum(out.values())
    return out
