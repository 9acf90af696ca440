"""Keys of other widths than 64 on the port's memory read, on the CPU.

* ``key_width``: the padded width CKP the CUDA selection kernels take keys
  CK wide at (the least of KEY_WIDTHS at or above CK), and the cap; each
  selection's libraries, one for each width.
* The padding is exact: keys zero-padded to CKP, scored as the plain
  selection scores (written out in the test) with the true CK's scale,
  select what the JAX package's ``pallas_memory_topk`` (each of its six
  methods, interpret mode) selects on the unpadded keys, at the JAX
  kernel contract's shapes (M = 512, N = 64, k = 8).  Tolerance: ids
  equal; weights within rtol 1e-5, atol 1e-6
  (``tests/test_pallas_kernel.py``'s).
* The wrappers' CPU route: a CPU tensor of any width in range takes the
  plain version, with no launch and no pad counted.
* A ``PropagationNetwork(keydim=32)`` tree of the JAX package carried
  across (``key_proj`` leaf for leaf), then one small frame through
  ``encode_key``, the memory read on a small bank (JAX: the Pallas fused
  read in interpret mode; the port: its 'fused' read, here the wrappers'
  plain versions) and ``decode_with_readout``.  Tolerance: atol 1e-4, as
  ``tests/test_torch_port_entry.py`` holds a step (fp32 convolutions
  summed in other orders by XLA and oneDNN).

Inputs are drawn with numpy from fixed seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.kernels import pallas_memory_topk
from eva_vos_tpu.kernels.memory_readout import pallas_fused_readout
from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu_torch import kernels as K
from eva_vos_tpu_torch.kernels.memory_topk import (KEY_WIDTHS, MAX_KEY_WIDTH,
                                                   key_width, pad_keys)
from eva_vos_tpu_torch.models import PropagationNetwork
from eva_vos_tpu_torch.ops import memory_readout
from eva_vos_tpu_torch.kernels import build
from eva_vos_tpu_torch.ops.memory_attention import softmax_weights
from eva_vos_tpu_torch.utils import stcn_state_dict_from_flax
from test_torch_port_engine import _random_variables

METHODS = ["tournament", "chunked", "resident", "grid", "iterative", "sort"]


@pytest.mark.parametrize("ck,want", [(1, (16, 15)), (16, (16, 0)),
                                     (24, (32, 8)), (64, (64, 0)),
                                     (100, (128, 28)), (256, (256, 0))])
def test_key_width_pads_to_the_next_built_width(ck, want):
    assert key_width(ck) == want
    assert want[0] in KEY_WIDTHS


@pytest.mark.parametrize("ck", [0, MAX_KEY_WIDTH + 1, 300])
def test_key_width_past_the_cap_raises(ck):
    with pytest.raises(ValueError, match=f"{MAX_KEY_WIDTH}"):
        key_width(ck)


def test_pad_keys_appends_zero_channels():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    y = pad_keys(x, 16)
    assert y.shape == (2, 16) and y.is_contiguous()
    assert torch.equal(y[:, :3], x) and not y[:, 3:].any()


@pytest.mark.parametrize("name", build.WIDTH_KERNELS)
def test_each_selection_library_is_built_once_per_width(name):
    """A selection's libraries: one for each of KEY_WIDTHS, compiled from
    its one source with that width alone (``-DTOPK_KEY_WIDTH``), each at a
    path of its own; the readouts' libraries take no width."""
    libs = [x for x in build.LIBRARIES if build.source(x) == name]
    assert libs == [f"{name}@{w}" for w in KEY_WIDTHS]
    assert len({build.library_path(x) for x in libs}) == len(KEY_WIDTHS)
    for x, w in zip(libs, KEY_WIDTHS):
        assert f"-DTOPK_KEY_WIDTH={w}" in build._flags(x)
    for x in build.KERNELS[len(build.WIDTH_KERNELS):]:
        assert x in build.LIBRARIES and build._flags(x) == list(
            build.NVCC_FLAGS)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ck", [16, 24, 32])
def test_padded_keys_select_as_the_jax_kernels(method, ck):
    m, n, top_k = 512, 64, 8
    rng = np.random.default_rng(ck)
    mk = rng.standard_normal((m, ck)).astype(np.float32)
    qk = rng.standard_normal((n, ck)).astype(np.float32)
    ckp, pad = key_width(ck)
    assert pad == (8 if ck == 24 else 0)
    # the plain scores of the padded keys, at the true width's scale
    k = pad_keys(torch.from_numpy(mk), ckp)
    q = pad_keys(torch.from_numpy(qk), ckp)
    scores = (2.0 * q @ k.T - (k * k).sum(-1)) / math.sqrt(ck)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    w, i = pallas_memory_topk(jnp.asarray(mk), jnp.asarray(qk), top_k,
                              block_q=32, block_m=128, interpret=True,
                              method=method)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i))
    np.testing.assert_allclose(softmax_weights(vals).numpy(), np.asarray(w),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ck", [24, 100, 256])
def test_wrappers_take_the_plain_version_on_the_cpu(ck):
    """Every selection wrapper at a width in range, CPU tensors: the plain
    selection, no launch and no pad counted (the kernels run only on the
    card)."""
    g = torch.Generator().manual_seed(ck)
    qk = torch.randn((40, ck), generator=g)
    mk = torch.randn((300, ck), generator=g)
    vals, idx = K.topk_select_plain(qk, mk, 250, 10)
    wrappers = (K.topk_select, K.topk_select_chunked, K.topk_select_resident,
                K.topk_select_grid, K.topk_select_iter, K.topk_select_sort)
    before = [(f.launches, f.pads) for f in wrappers]
    for f in wrappers[:3]:
        v, i = f(qk, mk, 250, 10)
        assert torch.equal(v, vals) and torch.equal(i, idx)
    for f in wrappers[3:]:
        v, i = f(qk, mk, 250, 10, return_raw=True)
        assert torch.equal(v, vals.T) and torch.equal(i, idx.T)
    assert [(f.launches, f.pads) for f in wrappers] == before


def test_keydim_32_network_matches_jax():
    h, w, frames, top_k = 64, 96, 3, 20
    hw = (h // 16) * (w // 16)
    jstcn = JxSTCN(keydim=32, key_arch="resnet18", value_arch="resnet18")
    params = _random_variables(jax.eval_shape(lambda: jstcn.init(
        jax.random.PRNGKey(0), jnp.zeros((h, w, 3)), jnp.zeros((1, h, w)),
        method="init_all")), np.random.default_rng(5))
    net = PropagationNetwork(keydim=32, key_arch="resnet18",
                             value_arch="resnet18")
    state = stcn_state_dict_from_flax(params, "resnet18", "resnet18")
    net.load_state_dict(state)
    net.eval()
    # key_proj leaf for leaf: the HWIO kernel as OIHW, the bias as it is
    jx = params["params"]["key_proj"]["key_proj"]
    proj = net.key_proj.key_proj
    assert proj.weight.shape[0] == 32
    np.testing.assert_array_equal(proj.weight.detach().numpy(),
                                  np.transpose(jx["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(proj.bias.detach().numpy(), jx["bias"])

    rng = np.random.default_rng(6)
    frame = rng.standard_normal((h, w, 3)).astype(np.float32)
    mem_k = rng.standard_normal((frames * hw, 32)).astype(np.float32)
    mem_v = rng.standard_normal((1, frames * hw, 512)).astype(np.float32)

    def jax_step(params, frame, mem_k, mem_v):
        feats = jstcn.apply(params, frame[None], method="encode_key")
        qk = feats.k16[0].reshape(hw, -1)
        readout = pallas_fused_readout(mem_k, qk, mem_v, top_k, block_q=16,
                                       block_m=128, interpret=True)
        readout = readout.reshape(1, h // 16, w // 16, -1)
        prob = jstcn.apply(params, readout, feats.f16_thin[0], feats.f8[0],
                           feats.f4[0], method="decode_with_readout")
        return feats.k16, readout, prob

    want = [np.asarray(x) for x in jax.jit(jax_step)(params, frame, mem_k,
                                                       mem_v)]
    with torch.inference_mode():
        feats = net.encode_key(torch.from_numpy(frame)[None])
        qk = feats.k16[0].reshape(hw, -1).contiguous()
        readout = memory_readout(torch.from_numpy(mem_k), qk,
                                 torch.from_numpy(mem_v), top_k=top_k,
                                 strategy="fused")
        readout = readout.reshape(1, h // 16, w // 16, -1)
        prob = net.decode_with_readout(readout, feats.f16_thin[0],
                                       feats.f8[0], feats.f4[0])
    assert feats.k16.shape[-1] == 32
    for got, ref in zip((feats.k16, readout, prob), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
