"""The PyTorch port's L0 ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both sides.  The
ops are elementwise or short reductions in fp32, so both sides round the
same operations and agree to atol 1e-6 (a few fp32 ulps at these values).

Also: a static check that the port (and ``chip_smoke.py`` and
``scripts/torch_port_profile.py``) never imports JAX, Flax or the JAX
package.
"""

import ast
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from eva_vos_tpu.ops import aggregate as jx_agg
from eva_vos_tpu.ops import normalize as jx_norm
from eva_vos_tpu.ops import padding as jx_pad
from eva_vos_tpu.ops import resize as jx_resize
from eva_vos_tpu_torch.ops import aggregate, normalize, padding, resize

ATOL = 1e-6
REPO = Path(__file__).resolve().parents[1]


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("h,w,d", [(480, 854, 16), (47, 63, 16), (64, 64, 16),
                                   (33, 17, 8)])
def test_compute_pad(h, w, d):
    assert padding.compute_pad(h, w, d) == jx_pad.compute_pad(h, w, d)


def test_pad_unpad_roundtrip(rng):
    x = rng.standard_normal((2, 3, 47, 63)).astype(np.float32)
    ours, pad = padding.pad_divide_by(torch.from_numpy(x))
    theirs, jpad = jx_pad.pad_divide_by(jnp.asarray(x))
    assert pad == jpad
    _close(ours, theirs, atol=0)
    _close(padding.unpad_hw(ours, pad), jx_pad.unpad_hw(theirs, pad), atol=0)
    # channel-last frames pad on axes 1 and 2
    f = rng.standard_normal((2, 47, 63, 3)).astype(np.float32)
    _close(padding.pad_hw(torch.from_numpy(f), pad, h_axis=1, w_axis=2),
           jx_pad.pad_hw(jnp.asarray(f), pad, h_axis=1, w_axis=2), atol=0)


def test_im_normalize(rng):
    img = rng.uniform(0, 1, (4, 16, 24, 3)).astype(np.float32)
    _close(normalize.im_normalize(torch.from_numpy(img)),
           jx_norm.im_normalize(jnp.asarray(img)))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("keep_bg", [True, False])
def test_aggregate_wbg(rng, k, keep_bg):
    prob = rng.uniform(0, 1, (k, 2, 16, 24)).astype(np.float32)
    prob[0, 0, :2] = 0.0      # exercise the eps clamps at both ends
    prob[-1, 1, :2] = 1.0
    _close(aggregate.aggregate_wbg(torch.from_numpy(prob), keep_bg=keep_bg),
           jx_agg.aggregate_wbg(jnp.asarray(prob), keep_bg=keep_bg))


def test_im_denormalize(rng):
    img = rng.standard_normal((4, 16, 24, 3)).astype(np.float32)
    _close(normalize.im_denormalize(torch.from_numpy(img)),
           jx_norm.im_denormalize(jnp.asarray(img)))


def _agg_prob(rng, shape):
    prob = rng.uniform(0, 1, shape).astype(np.float32)
    prob.reshape(shape[0], -1)[0, :2] = 0.0     # the eps clamps, both ends
    prob.reshape(shape[0], -1)[-1, 2:4] = 1.0
    return prob


def _close_hard(ours, theirs, new_prob, axis):
    """The ``hard`` outputs: the softmax of 1000x the logits.  XLA's and
    torch's fp32 ``log`` differ by up to an ulp (here 4.8e-7 on ~9% of the
    logits), which 1000x moves the softmax's argument by up to 1000 times
    that.  Where both packages' logits of every class (the background's
    too) agree bit for bit, the outputs agree to ATOL; elsewhere within 1000x the logits' largest
    difference (softmax moves by less than its argument)."""
    x = np.clip(new_prob, 1e-7, 1 - 1e-7)
    dlog = np.abs(torch.log(torch.from_numpy(x / (1 - x))).numpy()
                  - np.asarray(jnp.log(jnp.asarray(x / (1 - x)))))
    same = np.expand_dims((dlog == 0).all(axis=axis), axis)
    ours, theirs = ours.numpy(), np.asarray(theirs)
    diff = np.abs(ours - theirs)
    assert same.mean() > 0.5
    assert diff[np.broadcast_to(same, diff.shape)].max() <= ATOL
    assert diff.max() <= 1000 * dlog.max() + ATOL


@pytest.mark.parametrize("name", ["aggregate_wbg", "aggregate_sbg"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("keep_bg", [True, False])
@pytest.mark.parametrize("hard", [True, False])
def test_aggregate_variants(rng, name, k, keep_bg, hard):
    prob = _agg_prob(rng, (k, 2, 16, 24))
    ours = getattr(aggregate, name)(torch.from_numpy(prob), keep_bg=keep_bg,
                                    hard=hard)
    theirs = getattr(jx_agg, name)(jnp.asarray(prob), keep_bg=keep_bg,
                                   hard=hard)
    if not hard:
        _close(ours, theirs)
        return
    bg = (np.prod(1 - prob, axis=0, keepdims=True) if name == "aggregate_wbg"
          else np.full_like(prob[:1], 0.5))
    new_prob = np.concatenate([bg, prob])
    _close_hard(ours, theirs, new_prob, 0)


@pytest.mark.parametrize("keep_bg", [True, False])
@pytest.mark.parametrize("hard", [True, False])
def test_aggregate_wbg_channel(rng, keep_bg, hard):
    """(logits, softmax) over axis 1: the logits (x1000 when ``hard``) to
    a relative 1e-6, the softmax as above."""
    prob = _agg_prob(rng, (3, 2, 16, 24)).transpose(1, 0, 2, 3).copy()
    logits, out = aggregate.aggregate_wbg_channel(torch.from_numpy(prob),
                                                  keep_bg=keep_bg, hard=hard)
    jlogits, jout = jx_agg.aggregate_wbg_channel(jnp.asarray(prob),
                                                 keep_bg=keep_bg, hard=hard)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-6, atol=ATOL)
    if not hard:
        _close(out, jout)
        return
    new_prob = np.concatenate(
        [np.prod(1 - prob, axis=1, keepdims=True), prob], axis=1)
    _close_hard(out, jout, new_prob, 1)


@pytest.mark.parametrize("valid", [None, 40])
def test_memory_affinity_topk_gauss(rng, valid):
    from eva_vos_tpu.ops import memory_attention as jx_mem
    from eva_vos_tpu_torch.ops import memory_attention

    h, w, m, ck, top_k = 6, 8, 64, 16, 8
    mk = rng.standard_normal((m, ck)).astype(np.float32)
    qk = rng.standard_normal((h * w, ck)).astype(np.float32)
    wts, idx = memory_attention.memory_affinity_topk_gauss(
        torch.from_numpy(mk), torch.from_numpy(qk), top_k, (h, w), 3.0,
        valid_tokens=valid)
    jw, jidx = jx_mem.memory_affinity_topk_gauss(
        jnp.asarray(mk), jnp.asarray(qk), top_k, (h, w), 3.0,
        valid_tokens=valid)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(wts, jw)
    if valid is not None:
        assert int(idx.max()) < valid


@pytest.mark.parametrize("shape,out_hw", [((2, 6, 8, 5), (24, 32)),
                                          ((3, 5, 7, 2), (20, 28)),
                                          ((4, 4, 1), (8, 8))])
def test_resize_bilinear_upsampling(rng, shape, out_hw):
    """Half-pixel bilinear upsampling, edge rows included."""
    x = rng.standard_normal(shape).astype(np.float32)
    _close(resize.resize_bilinear(torch.from_numpy(x), out_hw),
           jx_resize.resize_bilinear(jnp.asarray(x), out_hw))


def test_upsample2x(rng):
    x = rng.standard_normal((2, 6, 8, 4)).astype(np.float32)
    _close(resize.upsample2x(torch.from_numpy(x)),
           jx_resize.upsample2x(jnp.asarray(x)))


def test_area_downsample(rng):
    x = rng.uniform(0, 1, (2, 48, 64)).astype(np.float32)
    _close(resize.area_downsample(torch.from_numpy(x), 16),
           jx_resize.area_downsample(jnp.asarray(x), 16))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "eva_vos_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "scripts" / "torch_port_profile.py"]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in ("jax", "jaxlib", "flax", "eva_vos_tpu"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
