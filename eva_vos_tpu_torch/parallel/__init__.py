"""Multi-process helpers (counterpart of ``eva_vos_tpu/parallel``): the
process group of the eval CLI's ``--multihost`` and its per-process video
shard.  The bank-sharded readout and the trainers' data parallelism are
not ported yet."""

from .mesh import host_shard_range, init_distributed

__all__ = ["init_distributed", "host_shard_range"]
