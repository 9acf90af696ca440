"""One process of the two-process rehearsal of the eval CLI's
``--multihost`` path (counterpart of
``eva_vos_tpu/parallel/_multihost_rehearsal.py``).

It runs the real code path: ``init_distributed``, ``host_shard_range``
checked for this rank, and one cross-process ``all_reduce`` of the ranks
through the mesh, checked against their sum.  With no device, or 'cpu',
the processes run on the CPU over gloo.  With 'cuda', process p's tensor
lies on card p modulo the card count, over NCCL when every process has
its own card and over gloo (staged through the host) when they share.

Usage (one command per process, all with the same free port):
    python -m eva_vos_tpu_torch.parallel._multihost_rehearsal <pid> <nproc> <port> [device]
"""

import sys


def main(process_id: int, num_processes: int, port: str,
         device: str = "cpu"):
    import torch
    import torch.distributed as dist

    from eva_vos_tpu_torch.parallel.mesh import (all_reduce, group_backend,
                                                 host_shard_range,
                                                 init_distributed, make_mesh)

    backend = group_backend(num_processes, device)
    if not init_distributed(coordinator_address=f"localhost:{port}",
                            num_processes=num_processes,
                            process_id=process_id, backend=backend):
        raise RuntimeError("init_distributed did not join a group")
    try:
        if dist.get_world_size() != num_processes:
            raise RuntimeError(f"world size {dist.get_world_size()}")
        mesh = make_mesh(num_processes, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        lo, hi = host_shard_range(10)
        per = -(-10 // num_processes)
        want = (min(process_id * per, 10), min(process_id * per + per, 10))
        if (lo, hi) != want:
            raise RuntimeError(f"shard {(lo, hi)}, expected {want}")
        x = all_reduce(torch.tensor([float(process_id)], device=mesh.device),
                       mesh)
        expect = float(sum(range(num_processes)))
        if x.device != mesh.device or x.item() != expect:
            raise RuntimeError(f"all_reduce gave {x.item()} on {x.device}, "
                               f"not {expect} on {mesh.device}")
        print(f"[multihost-rehearsal] proc {process_id}/{num_processes}: "
              f"shard [{lo},{hi}), all_reduce {x.item()} OK on "
              f"{mesh.device} over {backend}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], *sys.argv[4:5])
