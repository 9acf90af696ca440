"""The port's process-group helpers (``eva_vos_tpu_torch/parallel``)
against the JAX package's, on the CPU: the shard arithmetic, the
single-process no-op, and the two-process gloo rehearsal of the eval CLI's
``--multihost`` path (subprocesses on a free local port, each bounded by a
60 s timeout)."""

import socket
import subprocess
import sys
from pathlib import Path

import pytest

from eva_vos_tpu.parallel.mesh import host_shard_range as jx_shard_range
from eva_vos_tpu_torch.parallel import host_shard_range, init_distributed

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_items", [0, 1, 7, 10, 11, 64])
@pytest.mark.parametrize("process_count", [1, 2, 3, 4, 8])
def test_host_shard_range_matches_jax(n_items, process_count):
    shards = [host_shard_range(n_items, i, process_count)
              for i in range(process_count)]
    assert shards == [jx_shard_range(n_items, i, process_count)
                      for i in range(process_count)]
    # the half-open shards cover the items once, in order
    assert [i for lo, hi in shards for i in range(lo, hi)] == \
        list(range(n_items))


def test_single_process_is_a_no_op(monkeypatch):
    monkeypatch.delenv("EVAVOS_NUM_PROCESSES", raising=False)
    assert init_distributed() is False
    assert init_distributed(num_processes=1, backend="gloo") is False
    monkeypatch.setenv("EVAVOS_NUM_PROCESSES", "1")
    assert init_distributed() is False
    # no group: rank 0 of 1 takes everything
    assert host_shard_range(10) == (0, 10)


def test_several_processes_need_a_coordinator(monkeypatch):
    monkeypatch.delenv("EVAVOS_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, process_id=0, backend="gloo")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_rehearsal():
    nproc = 2
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "eva_vos_tpu_torch.parallel._multihost_rehearsal", str(pid),
         str(nproc), port],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        per = -(-10 // nproc)
        lo, hi = min(pid * per, 10), min(pid * per + per, 10)
        assert (f"proc {pid}/{nproc}: shard [{lo},{hi}), all_reduce "
                f"{float(sum(range(nproc)))} OK") in out, out
