"""The port's other memory reads against the JAX package's, on the CPU.

* ``select_topk(method=m)`` against ``pallas_memory_topk(method=m)`` in
  interpret mode for the four ported methods, on exact ties, partial fills
  (valid < M and valid < top_k), a query count that is not a multiple of
  the block, bf16 inputs, and winners packed into one 128-token group (the
  JAX kernels' escalation case);
* ``memory_readout(strategy="fused", kernel_cfg=KernelConfig(s, r))``
  against ``pallas_fused_readout(kcfg=KernelConfig(s, r))`` in interpret
  mode for every (selection, readout) pair;
* the engine under 'select', the resident selection, and the newest-first
  selection with the chunked readout, against the JAX engine's plain
  'gather' read (the JAX 'pallas' read does not run on a CPU outside
  interpret mode, and it computes the same function);
* the new wrappers refuse a tensor that is on neither the CPU nor a GPU;
* ``KernelConfig.from_env`` and unknown methods.

On the CPU every wrapper takes its plain version, so these hold the plain
versions against each JAX kernel.  Tolerances: ids must be equal on live
slots; fp32 weights agree to rtol 1e-5 (two matmuls, a few ulps apart),
except where the escalation case amplifies queries and keys 30x: its
scores of ~1e4 sit one fp32 ulp (~1e-3) apart between two matmuls, which
moves a weight by up to ~1e-3 relative (rtol 1e-3); bf16 weights 2e-2 (the same bf16 inputs,
fp32 sums in another order, as ``tests/test_pallas_kernel.py``); readouts
1e-5; engine probabilities 1e-4 (``tests/test_torch_port_engine.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.engine.propagation import EngineConfig as JxConfig
from eva_vos_tpu.engine.propagation import InferenceEngine as JxEngine
from eva_vos_tpu.engine.propagation import pad_mask as jx_pad_mask
from eva_vos_tpu.engine.propagation import prepare_video as jx_prepare
from eva_vos_tpu.kernels.config import KernelConfig as JxKernelConfig
from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout
from eva_vos_tpu.kernels.memory_topk import pallas_memory_topk
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.engine import EngineConfig, InferenceEngine
from eva_vos_tpu_torch.kernels import (KernelConfig, fused_readout,
                                       select_topk, topk_readout_chunked,
                                       topk_select_chunked, topk_select_grid,
                                       topk_select_resident)
from eva_vos_tpu_torch.ops import memory_attention as mem
from test_torch_port_engine import (H, MEM_FREQ, ROUNDS, T, TOP_K, W,
                                    _port_session, nets)  # noqa: F401

METHODS = ("grid", "tournament", "chunked", "resident")

# (m, n, ck, top_k, valid, block_q, block_m, inputs)
SELECT_CASES = {
    "random": (512, 64, 16, 8, None, 32, 128, "random"),
    "ties": (512, 64, 16, 8, None, 32, 128, "tiled"),
    "valid_lt_m": (512, 64, 16, 8, 300, 32, 128, "random"),
    "valid_lt_k": (512, 64, 16, 8, 5, 32, 128, "random"),
    "n_not_block_multiple": (512, 37, 16, 8, 200, 32, 128, "random"),
    "bf16": (512, 64, 16, 8, None, 32, 128, "random"),
    "escalation": (512, 64, 16, 16, None, 32, 512, "dominant"),
}


def _keys(rng, m, n, ck, kind):
    if kind == "tiled":  # every row 8 times: exact ties everywhere
        mk = np.tile(rng.standard_normal((m // 8, ck)), (8, 1))
        qk = rng.standard_normal((n, ck))
    elif kind == "dominant":  # tests/test_pallas_kernel.py:42-59
        mk = rng.standard_normal((m, ck))
        mk[20:40] *= 30.0
        qk = 30.0 * rng.standard_normal((n, ck))
    else:
        mk = rng.standard_normal((m, ck))
        qk = rng.standard_normal((n, ck))
    return mk.astype(np.float32), qk.astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_topk_matches_pallas(rng, case, method):
    m, n, ck, top_k, valid, bq, bm, kind = SELECT_CASES[case]
    mk, qk = _keys(rng, m, n, ck, kind)
    bf16 = case == "bf16"
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    w, idx = select_topk(torch.from_numpy(mk).to(tdt),
                         torch.from_numpy(qk).to(tdt), top_k, valid,
                         method=method)
    ref_w, ref_i = pallas_memory_topk(
        jnp.asarray(mk, jdt), jnp.asarray(qk, jdt), top_k, valid, block_q=bq,
        block_m=bm, interpret=True, method=method)
    assert w.shape == idx.shape == (n, top_k) and idx.dtype == torch.int32
    live = min(top_k, m if valid is None else valid)
    np.testing.assert_array_equal(idx.numpy()[:, :live],
                                  np.asarray(ref_i)[:, :live])
    rtol = 2e-2 if bf16 else 1e-3 if case == "escalation" else 1e-5
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=rtol,
                               atol=1e-6)


def test_select_topk_raw_scores(rng):
    mk, qk = _keys(rng, 512, 40, 16, "random")
    vals, idx = select_topk(torch.from_numpy(mk), torch.from_numpy(qk), 8,
                            300, method="grid", return_raw=True)
    ref_v, ref_i = pallas_memory_topk(
        jnp.asarray(mk), jnp.asarray(qk), 8, 300, block_q=32, block_m=128,
        interpret=True, method="grid", return_raw=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_v), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("method", ["iterative", "sort", "bogus"])
def test_select_topk_unported_methods_raise(method):
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="ROADMAP" if method != "bogus"
                       else "unknown"):
        select_topk(x, x, 2, method=method)


@pytest.mark.parametrize("sel", ["tournament", "chunked", "resident"])
@pytest.mark.parametrize("readout", ["grid", "chunked"])
def test_fused_read_kernel_configs_match_pallas(rng, sel, readout):
    m, n, ck, cv, top_k, valid = 512, 64, 16, 32, 8, 300
    mk, qk = _keys(rng, m, n, ck, "random")
    mv = rng.standard_normal((2, m, cv)).astype(np.float32)
    ours = mem.memory_readout(
        torch.from_numpy(mk), torch.from_numpy(qk), torch.from_numpy(mv),
        top_k=top_k, valid_tokens=valid, strategy="fused",
        kernel_cfg=KernelConfig(sel_method=sel, readout_method=readout))
    ref = pallas_fused_readout(
        jnp.asarray(mk), jnp.asarray(qk), jnp.asarray(mv), top_k=top_k,
        valid_tokens=valid, block_q=32, block_m=128, sel_block_q=32,
        sel_block_m=128, interpret=True,
        kcfg=JxKernelConfig(sel_method=sel, readout_method=readout))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def jax_reference(nets):
    """The JAX engine's session under the plain 'gather' read."""
    jstcn, jfusion, sp, fp = nets[0]
    images, masks = synthetic_video(T, H, W, num_objects=2, seed=9)
    jcfg = JxConfig(mem_freq=MEM_FREQ, top_k=TOP_K, max_interactions=4,
                    feature_chunk=2, readout_strategy="gather")
    jengine = JxEngine(jstcn, jfusion, sp, fp, jcfg)
    jpadded, jpad = jx_prepare(images)
    jfeats = jengine.precompute_features(jpadded)
    jstate = jengine.init_state(jfeats, 2)
    probs = []
    for idx in ROUNDS:
        jstate = jengine.interact(
            jstate, jfeats, jx_pad_mask(masks[:, idx].astype(np.float32),
                                        jpad), idx)
        probs.append(np.asarray(jstate.prob))
    return images, masks, probs


READS = {
    "select": ("select", None),
    "fused_resident": ("fused", KernelConfig(sel_method="resident")),
    "fused_chunked_chunked": ("fused", KernelConfig(sel_method="chunked",
                                                    readout_method="chunked")),
}


@pytest.mark.parametrize("read", sorted(READS))
def test_engine_reads_match_jax(nets, jax_reference, read):
    strategy, kcfg = READS[read]
    images, masks, want = jax_reference
    stcn, fusion = nets[1]
    cfg = EngineConfig(mem_freq=MEM_FREQ, top_k=TOP_K, max_interactions=4,
                       feature_chunk=2, readout_strategy=strategy,
                       kernels=kcfg)
    engine = InferenceEngine(stcn, fusion, cfg, device="cpu")
    assert engine.config.readout_strategy == strategy
    got, _, _ = _port_session(engine, images, masks)
    for idx, g, w in zip(ROUNDS, got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=f"after interacting frame {idx}")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: topk_select_chunked(_meta(8, 64), _meta(64, 64), 8, 4),
    lambda: topk_select_resident(_meta(8, 64), _meta(64, 64), 8, 4),
    lambda: topk_select_grid(_meta(8, 64), _meta(64, 64), 8, 4),
    lambda: select_topk(_meta(64, 64), _meta(8, 64), 4, method="resident"),
    lambda: topk_readout_chunked(_meta(1, 64, 64), _meta(4, 8),
                                 _meta(4, 8, dtype=torch.int32)),
    lambda: fused_readout(_meta(64, 64), _meta(8, 64), _meta(1, 64, 64), 4,
                          kcfg=KernelConfig("chunked", "chunked")),
], ids=["chunked", "resident", "grid", "select_topk", "readout_chunked",
        "fused_chunked"])
def test_new_wrappers_refuse_meta_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_kernel_config_from_env(monkeypatch):
    env = {"EVAVOS_SEL_METHOD": "resident", "EVAVOS_READOUT_METHOD": "chunked",
           "EVAVOS_SEL_NOTAU": "1", "EVAVOS_READOUT_NOSKIP": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = KernelConfig.from_env()
    jcfg = JxKernelConfig.from_env()
    assert cfg == KernelConfig("resident", "chunked", True, True)
    assert cfg == tuple(getattr(jcfg, f) for f in KernelConfig._fields)
    assert cfg.methods() == ("resident", "chunked", True, True)
    # the engine snapshots the environment once, at construction
    stcn = torch.nn.Module()
    engine = InferenceEngine(stcn, None, EngineConfig(), device="cpu")
    monkeypatch.setenv("EVAVOS_SEL_METHOD", "chunked")
    assert engine.config.kernels.sel_method == "resident"
    for k in env:
        monkeypatch.delenv(k)
    assert KernelConfig.from_env() == KernelConfig()
    assert KernelConfig().methods() == ("tournament", "grid", False, False)


@pytest.mark.parametrize("field", ["sel_method", "readout_method"])
def test_unknown_kernel_method_raises(monkeypatch, field):
    bad = KernelConfig(**{field: "bogus"})
    with pytest.raises(ValueError, match="unknown"):
        bad.checked()
    with pytest.raises(ValueError, match="unknown"):
        InferenceEngine(torch.nn.Module(), None, EngineConfig(kernels=bad),
                        device="cpu")
    x = torch.zeros((16, 8))
    with pytest.raises(ValueError, match="unknown"):
        fused_readout(x, x, torch.zeros((1, 16, 8)), 4, kcfg=bad)
    monkeypatch.setenv("EVAVOS_" + field.upper(), "bogus")
    with pytest.raises(ValueError, match="unknown"):
        KernelConfig.from_env()
