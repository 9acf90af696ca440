"""The port's CUDA kernels against their plain versions and a numpy oracle.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tests marked ``cuda`` skip without a GPU.  Tolerances: scores are sums of CK
products in fp32, summed in another order by the kernel than by the plain
version's matmul (atol 1e-4 at |score| ~ 10); the fp32 readout is a
weighted mean of N(0, 1) values (atol 1e-5); the bf16 readout may round
one bf16 ulp apart (2^-7 relative, atol 2e-2).
"""

import shutil
from functools import partial

import numpy as np
import pytest
import torch

from eva_vos_tpu_torch.engine import (EngineConfig, InferenceEngine, pad_mask,
                                      prepare_video)
from eva_vos_tpu_torch.data import synthetic_video
from eva_vos_tpu_torch.kernels import (KernelConfig, build, fused_readout,
                                       fused_readout_plain, topk_readout,
                                       topk_readout_chunked,
                                       topk_readout_plain, topk_select,
                                       topk_select_chunked, topk_select_grid,
                                       topk_select_plain,
                                       topk_select_resident)
from eva_vos_tpu_torch.models import FusionNet, PropagationNetwork
from eva_vos_tpu_torch.ops.memory_attention import memory_affinity_topk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _oracle_topk(qk, mk, valid, top_k):
    """fp64 ranking by (score desc, id asc); duplicate rows tie exactly."""
    q = qk.double().cpu().numpy()
    k = mk.double().cpu().numpy()[:valid]
    s = (2 * (q[:, None, :] * k[None, :, :]).sum(-1) - (k * k).sum(-1)) / 8.0
    order = np.lexsort((np.broadcast_to(np.arange(valid), s.shape), -s), axis=1)
    return order[:, :top_k].T


def test_plain_selection_matches_numpy_oracle():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((8, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (8, 1)))          # exact ties
    qk = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    _, idx = topk_select_plain(qk, mk, 60, 12)
    np.testing.assert_array_equal(idx.numpy(), _oracle_topk(qk, mk, 60, 12))


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, never computed by the plain version."""
    qk = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        topk_select(qk, qk, 8, 4)


# the selection kernels of the other memory reads, each as
# (vals [k, N] raw scores, idx [k, N]) and the wrapper that counts it
def _grid_transposed(qk, mk, valid, top_k):
    vals, idx = topk_select_grid(qk, mk, valid, top_k, return_raw=True)
    return vals.T, idx.T


VARIANTS = {
    "chunked": (topk_select_chunked, topk_select_chunked),
    "chunked_notau": (partial(topk_select_chunked, no_skip=True),
                      topk_select_chunked),
    "resident": (topk_select_resident, topk_select_resident),
    "grid": (_grid_transposed, topk_select_grid),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [3000, 1700, 20])
def test_selection_variant_kernels(cuda, variant, dtype, valid):
    fn, counted = VARIANTS[variant]
    g = torch.Generator(device=cuda).manual_seed(valid)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(dtype)
    before = counted.launches
    vals, idx = fn(qk, mk, valid, 50)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    pv, pi = topk_select_plain(qk, mk, valid, 50)
    live = min(valid, 50)
    torch.testing.assert_close(vals[:live], pv[:live], rtol=0, atol=1e-4)
    assert torch.equal(idx[:live], pi[:live])
    assert torch.all(vals[live:] == -1e30)
    assert int(idx.min()) >= 0 and int(idx.max()) < valid


@pytest.mark.cuda
def test_grid_selection_weights(cuda):
    """The softmax weights of the split-bank selection (five splits here)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qk = torch.randn((300, 64), generator=g, device=cuda)
    mk = torch.randn((3000, 64), generator=g, device=cuda)
    w, idx = topk_select_grid(qk, mk, 2500, 50)
    pw, pi = memory_affinity_topk(mk, qk, 50, 2500)
    assert torch.equal(idx, pi.to(torch.int32))
    torch.testing.assert_close(w, pw, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_variants_tie_to_lowest_id(cuda, variant, dtype):
    rng = np.random.default_rng(2)
    base = rng.standard_normal((40, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (50, 1))).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((70, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = VARIANTS[variant][0](qk, mk, 1990, 50)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, 1990, 50))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dominant_tokens", "ties_past_capacity"])
def test_resident_escalation(cuda, case):
    """Winners packed into one slice of the bank, and more exact ties at the
    threshold than a query's list holds: the second forces the escalation to
    the full merge, and both stay exact."""
    rng = np.random.default_rng(3)
    if case == "dominant_tokens":
        mk = rng.standard_normal((3000, 64)).astype(np.float32)
        mk[20:40] *= 30.0
        qk = 30.0 * rng.standard_normal((64, 64)).astype(np.float32)
    else:
        mk = np.tile(rng.standard_normal((10, 64)), (300, 1)).astype(np.float32)
        qk = rng.standard_normal((64, 64)).astype(np.float32)
    mk, qk = torch.from_numpy(mk).to(cuda), torch.from_numpy(qk).to(cuda)
    esc = torch.zeros(1, dtype=torch.int32, device=cuda)
    _, idx = topk_select_resident(qk, mk, 3000, 16, escalations=esc)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, 3000, 16))
    if case == "ties_past_capacity":
        assert int(esc) > 0


def test_build_raises_without_nvcc():
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolkit is present: the build runs instead")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [3000, 1700, 20])
def test_topk_select_kernel(cuda, dtype, valid):
    g = torch.Generator(device=cuda).manual_seed(valid)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(dtype)
    before = topk_select.launches
    vals, idx = topk_select(qk, mk, valid, 50)
    torch.cuda.synchronize()
    assert topk_select.launches == before + 1
    pv, pi = topk_select_plain(qk, mk, valid, 50)
    live = min(valid, 50)
    torch.testing.assert_close(vals[:live], pv[:live], rtol=0, atol=1e-4)
    assert torch.equal(idx[:live], pi[:live])
    assert torch.all(vals[live:] == -1e30)
    assert int(idx.min()) >= 0 and int(idx.max()) < valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_select_kernel_ties_to_lowest_id(cuda, dtype):
    rng = np.random.default_rng(2)
    base = rng.standard_normal((40, 64)).astype(np.float32)
    mk = torch.from_numpy(np.tile(base, (50, 1))).to(cuda, dtype)
    qk = torch.from_numpy(rng.standard_normal((70, 64)).astype(np.float32)
                          ).to(cuda, dtype)
    _, idx = topk_select(qk, mk, 1990, 50)
    np.testing.assert_array_equal(idx.cpu().numpy(),
                                  _oracle_topk(qk, mk, 1990, 50))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_obj", [1, 2])
def test_topk_readout_kernel(cuda, dtype, k_obj):
    g = torch.Generator(device=cuda).manual_seed(k_obj)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(dtype)
    mv = torch.randn((k_obj, 3000, 512), generator=g, device=cuda).to(dtype)
    vals, idx = topk_select(qk, mk, 2500, 50)
    before = topk_readout.launches
    out = topk_readout(mv, vals, idx)
    torch.cuda.synchronize()
    assert topk_readout.launches == before + 1
    ref = topk_readout_plain(mv, vals, idx)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=2e-2)
    # and chained, against the plain chain (fewer valid tokens than top_k)
    out = fused_readout(mk, qk, mv, 50, 20)
    torch.testing.assert_close(out.float(),
                               fused_readout_plain(mk, qk, mv, 50, 20).float(),
                               rtol=2 ** -7, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("no_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_obj", [1, 2])
def test_chunked_readout_kernel(cuda, no_skip, dtype, k_obj):
    """Random selections put ~250 distinct rows of a tile in each 1,024-token
    chunk (several staging rounds); the clustered bank of the second
    selection puts a tile's ids in few chunks, so most are skipped."""
    g = torch.Generator(device=cuda).manual_seed(k_obj)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(dtype)
    mv = torch.randn((k_obj, 3000, 512), generator=g, device=cuda).to(dtype)
    for mk in (torch.randn((3000, 64), generator=g, device=cuda).to(dtype),
               qk[torch.arange(3000, device=cuda) % 300]
               + 0.05 * torch.randn((3000, 64), generator=g, device=cuda
                                    ).to(dtype)):
        for valid in (2500, 20):
            vals, idx = topk_select_plain(qk, mk.contiguous(), valid, 50)
            before = topk_readout_chunked.launches
            out = topk_readout_chunked(mv, vals, idx, no_skip=no_skip)
            torch.cuda.synchronize()
            assert topk_readout_chunked.launches == before + 1
            ref = topk_readout_plain(mv, vals, idx)
            if dtype == torch.float32:
                torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
            else:
                torch.testing.assert_close(out.float(), ref.float(),
                                           rtol=2 ** -7, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("sel", ["tournament", "chunked", "resident"])
@pytest.mark.parametrize("readout", ["grid", "chunked"])
def test_fused_readout_kernel_configs(cuda, sel, readout):
    g = torch.Generator(device=cuda).manual_seed(7)
    qk = torch.randn((300, 64), generator=g, device=cuda).to(torch.bfloat16)
    mk = torch.randn((3000, 64), generator=g, device=cuda).to(torch.bfloat16)
    mv = torch.randn((2, 3000, 512), generator=g, device=cuda).to(
        torch.bfloat16)
    out = fused_readout(mk, qk, mv, 50, 2900, KernelConfig(sel, readout))
    torch.testing.assert_close(
        out.float(), fused_readout_plain(mk, qk, mv, 50, 2900).float(),
        rtol=2 ** -7, atol=2e-2)


def _engine_session(stcn, fusion, cfg, images, masks):
    engine = InferenceEngine(stcn, fusion, cfg)
    padded, pad = prepare_video(images)
    feats = engine.precompute_features(padded)
    state = engine.init_state(feats, masks.shape[0])
    for idx in (0, 4):
        state = engine.interact(state, feats, pad_mask(masks[:, idx], pad), idx)
    return engine, state


# the other memory reads: (strategy, KernelConfig, wrappers that must launch)
READS = {
    "select": ("select", None, (topk_select_grid,)),
    "resident": ("fused", KernelConfig(sel_method="resident"),
                 (topk_select_resident, topk_readout)),
    "chunked_chunked": ("fused", KernelConfig(sel_method="chunked",
                                              readout_method="chunked"),
                        (topk_select_chunked, topk_readout_chunked)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("read", sorted(READS))
def test_engine_on_card_other_reads(cuda, read):
    """The small engine on the card under each other memory read: its
    kernels launch, and the fp32 session matches the plain read's."""
    strategy, kcfg, wrappers = READS[read]
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    fusion = FusionNet()
    cfg = EngineConfig(mem_freq=2, top_k=8, max_interactions=4,
                       feature_chunk=2)
    images, masks = synthetic_video(6, 48, 64, num_objects=2, seed=3)
    before = [w.launches for w in wrappers]
    _, got = _engine_session(stcn, fusion, cfg._replace(
        readout_strategy=strategy, kernels=kcfg), images, masks)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    _, want = _engine_session(stcn, fusion, cfg._replace(
        readout_strategy="gather"), images, masks)
    torch.testing.assert_close(got.prob, want.prob, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("block_frames", [True, False])
def test_engine_on_card_matches_plain_read(cuda, block_frames):
    """The small engine on the card: 'auto' resolves to the kernels, which
    launch, and the fp32 session matches the plain read's."""
    torch.manual_seed(0)
    stcn = PropagationNetwork(key_arch="resnet18", value_arch="resnet18")
    fusion = FusionNet()
    cfg = EngineConfig(mem_freq=2, top_k=8, max_interactions=4,
                       feature_chunk=2, block_frames=block_frames)
    images, masks = synthetic_video(6, 48, 64, num_objects=2, seed=3)
    probs = []
    for strategy in ("auto", "gather"):
        engine = InferenceEngine(stcn, fusion,
                                 cfg._replace(readout_strategy=strategy))
        padded, pad = prepare_video(images)
        feats = engine.precompute_features(padded)
        state = engine.init_state(feats, 2)
        before = topk_select.launches
        for idx in (0, 4):
            state = engine.interact(state, feats, pad_mask(masks[:, idx], pad),
                                    idx)
        if strategy == "auto":
            assert engine.config.readout_strategy == "fused"
            assert topk_select.launches > before
        probs.append(state.prob)
    torch.testing.assert_close(probs[0], probs[1], rtol=0, atol=1e-4)
