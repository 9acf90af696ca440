"""Multi-process layer (counterpart of ``eva_vos_tpu/parallel``): the
process group and its mesh, per-process batch and video shards, the
collectives, the bank-sharded memory readout, the multi-host rehearsal,
and the dry run that holds every data-parallel and sharded path to its
one-process result."""

from .dryrun import dryrun_multichip, dryrun_multihost
from .mesh import (Mesh, all_gather, all_reduce, host_shard_range,
                   init_distributed, make_mesh, shard_batch)
from .sharded_attention import (collective_bytes, comm_model_bytes,
                                sharded_memory_readout)

__all__ = ["Mesh", "make_mesh", "shard_batch", "init_distributed",
           "host_shard_range", "all_gather", "all_reduce",
           "sharded_memory_readout", "comm_model_bytes", "collective_bytes",
           "dryrun_multichip", "dryrun_multihost"]
