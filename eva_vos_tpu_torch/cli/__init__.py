"""Command-line entry points (counterpart of ``eva_vos_tpu/cli``): the main
experiment CLI (``eval_annotation_method``), the two dataset generators,
the two trainers and the two download CLIs, with the JAX CLIs' flags and
on-disk trees; the ones that run models add ``--device`` (default
``cuda``)."""
