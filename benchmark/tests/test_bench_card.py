"""On the card, at each cell's own size: a short run reads correct, and
its control does not.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.core.spec import ROOT, read_json

CONTROLS = {"stcn-480p.session60": "bf16", "stcn-480p.first-mask": "bf16"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(cell, seed, precision=None):
    cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
           str(seed), "--seconds", "8", "--trace", "0"]
    if precision:
        cmd += ["--precision", precision]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_cell_correct_and_control_not(card, cell):
    assert cell in {w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]}
    sound = _run(cell, 2 ** 31 + 5)
    assert sound["correct"], sound["checks"]
    control = _run(cell, 2 ** 31 + 6, CONTROLS[cell])
    assert not control["correct"], control["checks"]
