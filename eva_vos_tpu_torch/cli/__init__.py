"""Command-line entry points (counterpart of ``eva_vos_tpu/cli``): the two
dataset generators and the two trainers, with the JAX CLIs' flags and
on-disk trees plus ``--device`` (default ``cuda``)."""
