"""One process of the two-process rehearsal of the eval CLI's
``--multihost`` path (counterpart of
``eva_vos_tpu/parallel/_multihost_rehearsal.py``).

It runs the real code path on the CPU: ``init_distributed`` over gloo,
``host_shard_range`` checked for this rank, and one cross-process
``all_reduce`` of the ranks checked against their sum.

Usage (one command per process, all with the same free port):
    python -m eva_vos_tpu_torch.parallel._multihost_rehearsal <pid> <nproc> <port>
"""

import sys


def main(process_id: int, num_processes: int, port: str):
    import torch
    import torch.distributed as dist

    from eva_vos_tpu_torch.parallel.mesh import (host_shard_range,
                                                 init_distributed)

    if not init_distributed(coordinator_address=f"localhost:{port}",
                            num_processes=num_processes,
                            process_id=process_id, backend="gloo"):
        raise RuntimeError("init_distributed did not join a group")
    try:
        if dist.get_world_size() != num_processes:
            raise RuntimeError(f"world size {dist.get_world_size()}")
        lo, hi = host_shard_range(10)
        per = -(-10 // num_processes)
        want = (min(process_id * per, 10), min(process_id * per + per, 10))
        if (lo, hi) != want:
            raise RuntimeError(f"shard {(lo, hi)}, expected {want}")
        x = torch.tensor([float(process_id)])
        dist.all_reduce(x)
        expect = float(sum(range(num_processes)))
        if x.item() != expect:
            raise RuntimeError(f"all_reduce gave {x.item()}, not {expect}")
        print(f"[multihost-rehearsal] proc {process_id}/{num_processes}: "
              f"shard [{lo},{hi}), all_reduce {x.item()} OK", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
