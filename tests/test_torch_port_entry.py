"""The port's entry points (``eva_vos_tpu_torch/entry.py``) against the JAX
package's (``__graft_entry__.py``), on the CPU, and the evaluation scripts.

* ``entry(device="cpu")`` at 64x96 (resnet50 keys, resnet18 values, fp32,
  a 4-frame bank of 96 tokens, top_k 50) against the JAX modules composed
  as ``__graft_entry__.entry``'s step, with the 'scatter' read that the
  JAX 'auto' resolves to on the CPU; the port's 'auto' is its plain
  'gather' read there.  One random JAX tree (random BatchNorm statistics
  too) carried across by ``stcn_state_dict_from_flax``; the same numpy
  inputs.  Tolerance: max |dp| <= 1e-4, as the engine's parity test (about
  60 fp32 convolutions summed in other orders by XLA and oneDNN).
* ``entry()``'s default inputs: the JAX draws' bf16 bits and shapes.
* (slow) the full-size bf16 step against JAX ``entry()`` itself, under
  the blocked-step gate of ``chip_smoke.py``: at most PROB_FRAC of the
  probabilities off by more than PROB_ATOL.
* the multi-host rehearsal on the CPU, and the dry run's refusal to fall
  back to the CPU unasked.
* ``scripts/eval_*_torch.sh``: the JAX scripts' lines with only the
  module changed, each parsed by the port CLI's ``build_parser``.
"""

import shlex
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eva_vos_tpu.models import PropagationNetwork as JxSTCN
from eva_vos_tpu.ops import aggregate_wbg as jx_aggregate_wbg
from eva_vos_tpu.ops import memory_readout as jx_memory_readout
from eva_vos_tpu_torch.cli.eval_annotation_method import (POLICIES,
                                                          build_parser)
from eva_vos_tpu_torch.entry import dryrun_multichip, entry
from eva_vos_tpu_torch.parallel import dryrun_multihost
from eva_vos_tpu_torch.utils import stcn_state_dict_from_flax
from test_torch_port_engine import _random_variables

REPO = Path(__file__).resolve().parents[1]
H, W, MEM_FRAMES, TOP_K = 64, 96, 4, 50
# chip_smoke.py's gate of a bf16 step against another read
PROB_ATOL, PROB_FRAC = 5e-2, 1e-3


def _jax_step(stcn, params, frame, mem_k, mem_v, top_k, strategy):
    """``__graft_entry__.entry``'s step at any size."""
    h, w = frame.shape[:2]
    h16, w16 = h // 16, w // 16
    feats = stcn.apply(params, frame[None], method="encode_key")
    qk = feats.k16[0].reshape(h16 * w16, -1)
    readout = jx_memory_readout(mem_k, qk, mem_v, top_k=top_k,
                                strategy=strategy)
    readout = readout.reshape(1, h16, w16, -1)
    prob = stcn.apply(params, readout, feats.f16_thin[0], feats.f8[0],
                      feats.f4[0], method="decode_with_readout")
    return jx_aggregate_wbg(prob.astype(jnp.float32), keep_bg=True)


def _jax_draws(h, w, mem_frames, dtype):
    """The JAX entry's inputs, drawn and cast as it draws and casts them."""
    hw = (h // 16) * (w // 16)
    rng = np.random.default_rng(0)
    return (jnp.asarray(rng.standard_normal((h, w, 3)), dtype),
            jnp.asarray(rng.standard_normal((mem_frames * hw, 64)), dtype),
            jnp.asarray(rng.standard_normal((1, mem_frames * hw, 512)),
                        dtype))


def test_entry_matches_the_jax_step():
    jstcn = JxSTCN()
    params = _random_variables(jax.eval_shape(lambda: jstcn.init(
        jax.random.PRNGKey(0), jnp.zeros((H, W, 3)), jnp.zeros((1, H, W)),
        method="init_all")), np.random.default_rng(7))
    step, args = entry(device="cpu", h=H, w=W, mem_frames=MEM_FRAMES,
                       dtype=torch.float32,
                       state_dict=stcn_state_dict_from_flax(params))
    net, frame, mem_k, mem_v = args
    assert not net.training and net.dtype == torch.float32
    assert tuple(mem_k.shape) == (MEM_FRAMES * 4 * 6, 64)
    got = step(*args)
    want = np.asarray(jax.jit(
        lambda *a: _jax_step(jstcn, *a, TOP_K, "scatter"))(
        params, *(jnp.asarray(x.numpy()) for x in (frame, mem_k, mem_v))))
    assert got.shape == (2, H, W) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    # the step reads the memory: 0 / 1 would hide a decode of zeros
    assert 0.0 < got[1].min() and got[1].max() < 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_default_inputs_are_the_jax_bits():
    step, (net, frame, mem_k, mem_v) = entry(device="cpu")
    assert net.dtype == torch.bfloat16
    jx = _jax_draws(480, 864, 4, jnp.bfloat16)
    for got, want in zip((frame, mem_k, mem_v), jx):
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))
    assert tuple(frame.shape) == (480, 864, 3)
    assert tuple(mem_k.shape) == (6480, 64)
    assert tuple(mem_v.shape) == (1, 6480, 512)


@pytest.mark.slow  # the full-size step on the CPU, both packages
def test_full_size_step_matches_jax_entry():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as graft

    fn, (params, frame, mem_k, mem_v) = graft.entry()
    want = np.asarray(jax.jit(fn)(params, frame, mem_k, mem_v))
    step, args = entry(device="cpu",
                       state_dict=stcn_state_dict_from_flax(params))
    for x, y in zip(args[1:], (frame, mem_k, mem_v)):
        np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                      np.asarray(y).view(np.int16))
    got = step(*args).numpy()
    assert got.shape == want.shape == (2, 480, 864)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-3)
    assert np.mean(np.abs(got - want) > PROB_ATOL) <= PROB_FRAC


def test_dryrun_multihost_on_the_cpu():
    out = dryrun_multihost(2, device="cpu")
    assert out["backend"] == "gloo"
    assert [line.split(":")[0] for line in out["lines"]] == [
        "[multihost-rehearsal] proc 0/2", "[multihost-rehearsal] proc 1/2"]
    assert all("all_reduce 1.0 OK on cpu over gloo" in line
               for line in out["lines"])


def test_dryrun_multichip_needs_the_card_or_the_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr("eva_vos_tpu_torch.parallel.dryrun.spawn",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multihost(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert spawned == []


def _policy_lines(path: Path) -> list:
    """The script's policy lines, the ``$PY`` variable expanded."""
    lines = path.read_text().splitlines()
    py = next(line for line in lines if line.startswith("PY="))
    py = py[len("PY="):].strip('"')
    return [line.replace("$PY", py) for line in lines
            if line.startswith("$PY ")]


@pytest.mark.parametrize("db", ["davis", "mose"])
def test_eval_scripts_call_the_port(db):
    jax_script = REPO / "scripts" / f"eval_{db}.sh"
    port_script = REPO / "scripts" / f"eval_{db}_torch.sh"
    # every line the same but the module; the header's comment is the port's
    def code(path):
        return [line for line in path.read_text().splitlines()
                if not line.startswith("# ")]

    assert code(port_script) == [line.replace(
        "eva_vos_tpu.cli.eval_annotation_method",
        "eva_vos_tpu_torch.cli.eval_annotation_method")
        for line in code(jax_script)]
    lines = _policy_lines(port_script)
    assert len(lines) == 11
    assert [line.split("--policy")[1] for line in lines] == [
        line.split("--policy")[1] for line in _policy_lines(jax_script)]
    parser = build_parser()
    for line in lines:
        words = shlex.split(line.replace("$DB", db.upper().replace(
            "DAVIS", "DAVIS_17")).replace("$ROUNDS", "60"))
        assert words[:3] == ["python", "-m",
                             "eva_vos_tpu_torch.cli.eval_annotation_method"]
        args = parser.parse_args(words[3:])
        assert args.policy in POLICIES
        assert args.device == "cuda" and args.rounds == 60
        assert args.db == {"davis": "DAVIS_17", "mose": "MOSE"}[db]
