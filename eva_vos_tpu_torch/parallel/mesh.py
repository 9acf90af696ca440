"""Process group and per-process shards on ``torch.distributed``
(counterpart of ``eva_vos_tpu/parallel/mesh.py``'s ``init_distributed`` and
``host_shard_range``).

The JAX module's mesh and sharding objects (``make_mesh``,
``data_sharding``, ``replicated_sharding``, ``shard_batch``) have no
counterpart here: their torch form is the trainers' data parallelism.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join this process to a ``torch.distributed`` group (the reference's
    NCCL rendezvous, ``util/dist.py:18-21``).

    The arguments default to ``EVAVOS_COORDINATOR`` (``host:port``, or a
    ``tcp://`` address), ``EVAVOS_NUM_PROCESSES`` and
    ``EVAVOS_PROCESS_ID``, as in the JAX package.  Returns False, and does
    nothing, for a single process, so callers can wire it unconditionally.
    ``backend``: 'nccl' (the default, for processes on CUDA devices) or
    'gloo' (CPU callers); a failure to join raises.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("EVAVOS_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return False
    address = coordinator_address or os.environ.get("EVAVOS_COORDINATOR")
    if not address:
        raise ValueError("init_distributed: several processes need a "
                         "coordinator address (EVAVOS_COORDINATOR)")
    if process_id is None:
        process_id = int(os.environ.get("EVAVOS_PROCESS_ID", "0"))
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    dist.init_process_group(backend or "nccl", init_method=address,
                            world_size=num_processes, rank=process_id)
    return True


def host_shard_range(n_items: int, process_index: int | None = None,
                     process_count: int | None = None) -> tuple[int, int]:
    """This process's contiguous ``[min_idx, max_idx)`` slice of an
    experiment's video list: the derived form of the reference's manual
    ``--min-idx/--max-idx`` sharding (``annotation_dataset.py:56-58``).
    The rank and size default to the initialised group's (0 and 1
    without one)."""
    joined = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if joined else 0
    if process_count is None:
        process_count = dist.get_world_size() if joined else 1
    per = -(-n_items // process_count)
    lo = min(process_index * per, n_items)
    return lo, min(lo + per, n_items)
