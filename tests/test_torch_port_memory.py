"""The port's memory read against the JAX package's, on the CPU.

* the plain read (``ops.memory_attention``) against the JAX oracle;
* the selection kernel's plain version against JAX ``tournament_topk_t``
  in interpret mode, and the fused readout's plain version against
  ``pallas_fused_readout`` in interpret mode, on the cases of
  ``tests/test_fused_readout.py``: duplicate-key ties, valid < top_k,
  query padding, a multi-block bank, bf16 inputs;
* the wrappers take their plain versions for CPU tensors.

Tolerances: fp32 scores are computed by two different matmuls, so they
agree to a few ulps (rtol 1e-5 on values of magnitude ~10); ids must agree
exactly (the cases leave gaps between neighbouring scores far wider than
that, and exact duplicates tie identically on both sides).  Readouts are
weighted means of N(0, 1) values: atol 1e-5.  bf16 cases compare scores and
readouts computed from the same bf16-rounded inputs, so fp32 accumulation
order is the only difference (rtol 1e-5), except the readout's final cast
to bf16, which may round one ulp apart: rtol 2e-2 there.

The CUDA kernels themselves run only on the card:
``tests/test_torch_port_kernels.py``.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout
from eva_vos_tpu.kernels.memory_topk import tournament_topk_t
from eva_vos_tpu.ops import memory_attention as jx_mem
from eva_vos_tpu_torch.kernels import (fused_readout, fused_readout_plain,
                                       topk_readout, topk_select,
                                       topk_select_plain)
from eva_vos_tpu_torch.ops import memory_attention as mem


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


# (m, n, ck, cv, top_k, valid, duplicate rows, block_q, block_m)
CASES = {
    "multi_block": (512, 64, 16, 32, 8, None, False, 32, 128),
    "valid_prefix": (256, 16, 8, 24, 5, 100, False, 16, 64),
    "fewer_valid_than_topk": (128, 8, 8, 16, 16, 9, False, 8, 64),
    "ties_at_threshold": (64, 4, 8, 8, 4, None, True, 4, 32),
    "query_padding": (128, 37, 8, 16, 4, None, False, 16, 64),
}


def _inputs(rng, m, n, ck, cv, dup, k_obj=1):
    if dup:  # every memory row repeated 8x -> ties everywhere
        mk = np.tile(rng.standard_normal((m // 8, ck)), (8, 1))
    else:
        mk = rng.standard_normal((m, ck))
    qk = rng.standard_normal((n, ck))
    mv = rng.standard_normal((k_obj, m, cv))
    return [np.asarray(a, np.float32) for a in (mk, qk, mv)]


def _tournament(mk, qk, top_k, valid, block_q, block_m, dtype=jnp.float32):
    """JAX tournament selection on padded inputs -> [k, n] vals, ids."""
    n, ck = qk.shape
    m = mk.shape[0]
    pad_n, pad_m = (-n) % block_q, (-m) % block_m
    qk_p = jnp.pad(_j(qk, dtype), ((0, pad_n), (0, 0)))
    mk_p = jnp.pad(_j(mk, dtype), ((0, pad_m), (0, 0)))
    msq = jnp.sum(mk_p.astype(jnp.float32) ** 2, axis=-1)
    vals, idx = tournament_topk_t(
        qk_p, mk_p, msq, jnp.asarray([m if valid is None else valid], jnp.int32),
        top_k=top_k, block_q=block_q, block_m=block_m, scale=math.sqrt(ck),
        interpret=True)
    return np.asarray(vals)[:, :n], np.asarray(idx)[:, :n]


def _check_selection(vals, idx, ref_vals, ref_idx, valid, rtol=1e-5):
    np.testing.assert_allclose(vals.numpy(), ref_vals, rtol=rtol, atol=1e-5)
    # slots past the valid prefix hold -1e30 with unspecified ids
    live = np.arange(vals.shape[0])[:, None] < (valid or vals.shape[0])
    np.testing.assert_array_equal(np.where(live, idx.numpy(), -1),
                                  np.where(live, ref_idx, -1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_selection_matches_tournament(rng, case):
    m, n, ck, cv, top_k, valid, dup, bq, bm = CASES[case]
    mk, qk, _ = _inputs(rng, m, n, ck, cv, dup)
    vals, idx = topk_select_plain(_t(qk), _t(mk), valid, top_k)
    assert vals.shape == (top_k, n) and idx.dtype == torch.int32
    ref_vals, ref_idx = _tournament(mk, qk, top_k, valid, bq, bm)
    _check_selection(vals, idx, ref_vals, ref_idx, valid)


def test_plain_selection_bf16_inputs(rng):
    m, n, ck, top_k = 512, 32, 16, 8
    mk, qk, _ = _inputs(rng, m, n, ck, 8, False)
    vals, idx = topk_select_plain(_t(qk, torch.bfloat16),
                                  _t(mk, torch.bfloat16), None, top_k)
    ref_vals, ref_idx = _tournament(mk, qk, top_k, None, 32, 128,
                                    dtype=jnp.bfloat16)
    _check_selection(vals, idx, ref_vals, ref_idx, None)


@pytest.mark.parametrize("k_obj", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fused_readout_matches_pallas(rng, case, k_obj):
    m, n, ck, cv, top_k, valid, dup, bq, bm = CASES[case]
    mk, qk, mv = _inputs(rng, m, n, ck, cv, dup, k_obj)
    ours = fused_readout_plain(_t(mk), _t(qk), _t(mv), top_k, valid)
    ref = pallas_fused_readout(_j(mk), _j(qk), _j(mv), top_k=top_k,
                               valid_tokens=valid, block_q=bq, block_m=bm,
                               interpret=True)
    assert ours.shape == (k_obj, n, cv)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_plain_fused_readout_bf16(rng):
    m, n, ck, cv, top_k = 512, 32, 16, 32, 8
    mk, qk, mv = _inputs(rng, m, n, ck, cv, False)
    bf = torch.bfloat16
    ours = fused_readout_plain(_t(mk, bf), _t(qk, bf), _t(mv, bf), top_k)
    ref = pallas_fused_readout(_j(mk, jnp.bfloat16), _j(qk, jnp.bfloat16),
                               _j(mv, jnp.bfloat16), top_k=top_k, block_q=32,
                               block_m=128, interpret=True)
    assert ours.dtype == bf
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("strategy", ["gather", "scatter", "fused"])
@pytest.mark.parametrize("valid", [None, 100])
def test_memory_readout_matches_jax(rng, strategy, valid):
    """Every port strategy against the JAX gather oracle (on the CPU the
    'fused' strategy runs the kernels' plain versions)."""
    mk, qk, mv = _inputs(rng, 256, 40, 16, 24, False, k_obj=2)
    ours = mem.memory_readout(_t(mk), _t(qk), _t(mv), top_k=7,
                              valid_tokens=valid, strategy=strategy)
    ref = jx_mem.memory_readout(_j(mk), _j(qk), _j(mv), top_k=7,
                                valid_tokens=valid, strategy="gather")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_affinity_topk_and_full_softmax(rng):
    mk, qk, _ = _inputs(rng, 128, 24, 16, 8, False)
    w, idx = mem.memory_affinity_topk(_t(mk), _t(qk), 6, valid_tokens=90)
    jw, jidx = jx_mem.memory_affinity_topk(_j(mk), _j(qk), 6, valid_tokens=90)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        mem.full_softmax_affinity(_t(mk), _t(qk), 90).numpy(),
        np.asarray(jx_mem.full_softmax_affinity(_j(mk), _j(qk), 90)),
        rtol=1e-5, atol=1e-7)


def test_scores_mask_with_finite_sentinel(rng):
    mk, qk, _ = _inputs(rng, 32, 4, 8, 8, False)
    s = mem._scores(_t(mk), _t(qk), valid_tokens=10)
    assert torch.all(s[:, 10:] == mem.NEG_INF) and torch.isfinite(s).all()


def test_wrappers_take_plain_version_on_cpu(rng):
    mk, qk, mv = _inputs(rng, 128, 16, 16, 16, False)
    before = (topk_select.launches, topk_readout.launches)
    vals, idx = topk_select(_t(qk), _t(mk), 50, 8)
    pv, pi = topk_select_plain(_t(qk), _t(mk), 50, 8)
    assert torch.equal(vals, pv) and torch.equal(idx, pi)
    out = fused_readout(_t(mk), _t(qk), _t(mv), 8, 50)
    assert torch.equal(out, fused_readout_plain(_t(mk), _t(qk), _t(mv), 8, 50))
    assert (topk_select.launches, topk_readout.launches) == before
