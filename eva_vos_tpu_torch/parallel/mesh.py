"""Process group, mesh and collectives on ``torch.distributed``
(counterpart of ``eva_vos_tpu/parallel/mesh.py``).

The JAX package runs one process over a named device mesh and lets XLA
insert the collectives.  Here a mesh is the group of processes, one device
each: :func:`make_mesh` describes this process's place in it,
:func:`shard_batch` takes its rows of a global batch, and
:func:`all_gather` / :func:`all_reduce` are the collectives that the
sharded memory read and the data-parallel trainers issue.  On an NCCL group
they run on the device.  A gloo group is a host backend: CUDA tensors are
copied to the host, reduced there and copied back, which lets several
processes share one card.  Each collective adds the bytes of its result to
``mesh.collective_bytes``.

``data_sharding`` and ``replicated_sharding`` return XLA placement objects
and have no counterpart.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


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


@dataclass
class Mesh:
    """This process's place in a one-axis mesh of processes.

    ``group`` is the initialised ``torch.distributed`` group, or None for a
    lone process (a mesh of size 1, whose collectives are the identity).
    ``device`` is where this rank computes.  ``collective_bytes`` counts the
    result bytes of each collective issued on the mesh, by operation.
    """

    size: int
    rank: int
    axis: str
    group: object
    device: torch.device
    collective_bytes: dict = field(
        default_factory=lambda: {"all-gather": 0, "all-reduce": 0})


def group_backend(n_procs: int, device) -> str:
    """The backend of ``n_procs`` processes on ``device``: 'nccl' when each
    has a card of its own, 'gloo' when they share cards or run on the CPU
    (NCCL will not put two ranks of one communicator on one GPU).  A CUDA
    ``device`` with no card raises: nothing falls back to the CPU unasked."""
    if torch.device(device).type != "cuda":
        return "gloo"
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "processes on the CPU")
    return "nccl" if n_procs <= count else "gloo"


def _default_device(rank: int, device) -> torch.device:
    """``device`` as given; 'cuda' (or None) is ``cuda:<local rank>``, the
    local rank (``LOCAL_RANK``, else the rank) modulo the card count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % count)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh of the initialised process group (every rank, one device
    each), or of this process alone when no group is initialised.
    ``n_devices`` other than the group's size raises."""
    joined = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the process "
                         f"group has {size}")
    return Mesh(size=size, rank=rank, axis=axis,
                group=dist.group.WORLD if joined else None,
                device=_default_device(rank, device))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous rows of every array (numpy or torch) in
    ``batch``, as tensors on ``mesh.device``.  A leading axis that does not
    divide by the mesh size raises, as the JAX trainers' sharded steps do."""
    out = {}
    for name, x in batch.items():
        rows = x.shape[0]
        if rows % mesh.size:
            raise ValueError(f"shard_batch: {name!r} has {rows} rows, not "
                             f"divisible by the mesh size {mesh.size}")
        per = rows // mesh.size
        part = x[mesh.rank * per:(mesh.rank + 1) * per]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out[name] = part.to(mesh.device)
    return out


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    """A CUDA tensor on a gloo group goes through the host."""
    return x.device.type != "cpu" and dist.get_backend(mesh.group) == "gloo"


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked by rank: [size, *x.shape] on x's device."""
    if mesh.group is None:
        return x[None]
    src = x.cpu() if _staged(mesh, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.stack(parts).to(x.device)
    mesh.collective_bytes["all-gather"] += out.numel() * out.element_size()
    return out


def _sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``x`` in a new tensor on x's device."""
    src = x.cpu() if _staged(mesh, x) else x
    out = src.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    mesh.collective_bytes["all-reduce"] += out.numel() * out.element_size()
    return out.to(x.device)


class _StagedSum(torch.autograd.Function):
    """The host-staged sum as one autograd node on x's device.  Staged
    through ``torch.distributed.nn``'s form, the collective would be a
    node on the host: the autograd engine runs host and device nodes in
    two threads, so two ranks could issue their backward collectives in
    different orders, which a gloo group cannot match."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh), None


def all_reduce(x: torch.Tensor, mesh: Mesh, grad: bool = False):
    """The sum of every rank's ``x``, in a new tensor on x's device.  With
    ``grad`` the gradient flows back through the sum: the backward
    all-reduces the incoming gradients (``torch.distributed.nn``'s
    autograd-aware collective, or its host-staged counterpart
    :class:`_StagedSum` for a CUDA tensor on a gloo group)."""
    if mesh.group is None:
        return x.clone()
    if not grad:
        return _sum(x, mesh)
    if _staged(mesh, x):
        return _StagedSum.apply(x, mesh)
    with warnings.catch_warnings():     # its deprecation notice
        warnings.simplefilter("ignore", FutureWarning)
        out = dist_nn.all_reduce(x, group=mesh.group)
    mesh.collective_bytes["all-reduce"] += out.numel() * out.element_size()
    return out
