"""``correct`` comes out true for the sound program and false under the
control and under each fault the stcn cells can have, planted under a
whole run of the harness (its look for a card skipped; CPU, small frames;
the cell's own limits)."""

import time

import pytest
import torch

from benchmark.core.harness import execute
from benchmark.tests._tiny import tiny_cell, tiny_eva_cell

CELLS = ("stcn-480p.session60", "stcn-480p.first-mask")


def _run(name, plant=None, precision=None, seed=2 ** 31 + 99, cell=None,
         seconds=3.0):
    torch.set_num_threads(4)
    return execute(cell or tiny_cell(name), seed, seconds, False,
                   time.perf_counter(), device="cpu", precision=precision,
                   plant=plant, require_card=False)


def state_unchanged(models):
    eng = models["engine"]
    eng.interact = lambda state, feats, mask, idx, donate=False: state


def half_the_batch(models):
    """A blocked step computes the first half of its frames and gives the
    rest their mean."""
    eng = models["engine"]
    seg = eng._segment_frames

    def half(feats, bank_k, bank_v, front, tis):
        if len(tis) < 2:
            return seg(feats, bank_k, bank_v, front, tis)
        out = seg(feats, bank_k, bank_v, front, tis[:len(tis) // 2])
        rest = out.mean(0, keepdim=True).expand(len(tis) - out.shape[0], *out.shape[1:])
        return torch.cat([out, rest])

    eng._segment_frames = half


def answer_altered(models):
    """The last frame of each step comes out with its object and
    background swapped."""
    eng = models["engine"]
    seg = eng._segment_frames

    def altered(*a):
        out = seg(*a).clone()
        out[-1] = 1 - out[-1]
        return out

    eng._segment_frames = altered


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, answer_altered])
def test_fault_is_not_correct(name, fault):
    out = _run(name, plant=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The program's own bfloat16 path, the precision below the
    configuration's float32."""
    out = _run(name, precision="bf16")
    assert not out["correct"], out["checks"]


def sam_mask_altered(models):
    """SAM's decoder returns its first multimask output negated."""
    pred = models["annotator"].sam.predictor
    decode = pred._decode

    def altered(*a):
        masks, iou = decode(*a)
        masks = masks.clone()
        masks[1] = -masks[1]
        return masks, iou

    pred._decode = altered


def qnet_altered(models):
    """QNet's features come out with one frame's row zeroed."""
    net = models["qnet_extract"].__self__
    extract = net.extract_features

    def altered(imgs, masks):
        out = extract(imgs, masks).clone()
        out[-1] = 0
        return out

    models["qnet_extract"] = altered


def agent_altered(models):
    """The agent's value comes out shifted."""
    net = models["rl_agent"].net
    forward = net.forward
    net.forward = lambda *a: (lambda lv: (lv[0], lv[1] + 0.5))(forward(*a))


def test_eva_sound_run_is_correct(monkeypatch):
    out = _run(None, cell=tiny_eva_cell(monkeypatch), seconds=6.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", [sam_mask_altered, qnet_altered, agent_altered])
def test_eva_fault_is_not_correct(monkeypatch, fault):
    """The policy's own networks; the engine's faults are the stcn cells'
    (the eva cell compares no number of the engine's output that its
    control separates, and is not in BENCHMARK.json yet)."""
    out = _run(None, cell=tiny_eva_cell(monkeypatch), plant=fault, seconds=6.0)
    assert not out["correct"], out["checks"]


def test_eva_control_is_not_correct(monkeypatch):
    """The program under torch.autocast to bfloat16 (its own bf16 path
    stops in SAM's prompt encoder)."""
    out = _run(None, cell=tiny_eva_cell(monkeypatch), precision="bf16-autocast",
               seconds=6.0)
    assert not out["correct"], out["checks"]
