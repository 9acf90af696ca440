"""The import guard: nothing a run loads may be JAX or the JAX package.

Modules are compared by their whole top-level name, the part before the
first dot, so ``eva_vos_tpu_torch`` (the port) is not ``eva_vos_tpu`` (the
JAX package it was ported from).
"""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "eva_vos_tpu")


def top_level(name: str) -> str:
    return name.partition(".")[0]


def forbidden_modules(module_names) -> list[str]:
    """The names among ``module_names`` whose top-level name is forbidden,
    sorted."""
    return sorted(n for n in module_names if top_level(n) in FORBIDDEN)
