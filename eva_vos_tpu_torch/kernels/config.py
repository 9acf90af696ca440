"""Which memory-read kernels the fused read runs (counterpart of
``eva_vos_tpu/kernels/config.py``).

:class:`KernelConfig` keeps the JAX package's knobs that choose a function
or a skip, under the same names: the selection kernel, the readout kernel,
and the two exactness-preserving ablations.  The engine resolves
:meth:`KernelConfig.from_env` once, at construction, unless it is given
``EngineConfig(kernels=KernelConfig(...))``; a field left ``None`` falls
back to its ``EVAVOS_*`` variable and then to the default when the read
runs (:func:`resolve`).

The JAX package's tile-geometry knobs (``sel_block_q/m``, ``ro_block_q``,
``ro_win``, ``tour_group/rounds/defer``) size VMEM tiles of the TPU kernels
and have no counterpart in the CUDA kernels, whose tiles are fixed by the
card: they are not fields here.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

SEL_METHODS = ("tournament", "chunked", "resident")
READOUT_METHODS = ("grid", "chunked")


class KernelConfig(NamedTuple):
    """The fused read's kernels; ``None`` = the ``EVAVOS_*`` variable, else
    the default (tournament selection, grid readout, both skips on)."""

    sel_method: Optional[str] = None      # tournament | chunked | resident
    readout_method: Optional[str] = None  # grid | chunked
    sel_notau: Optional[bool] = None      # ablation: no running-tau skip
    #   (the chunked selector's; the tournament and resident kernels of
    #   the port have no tau skip to turn off)
    readout_noskip: Optional[bool] = None  # ablation: no chunk skip

    @classmethod
    def from_env(cls) -> "KernelConfig":
        """Snapshot the EVAVOS_* variables (engine construction)."""
        return cls(
            sel_method=os.environ.get("EVAVOS_SEL_METHOD") or None,
            readout_method=os.environ.get("EVAVOS_READOUT_METHOD") or None,
            sel_notau=bool(os.environ.get("EVAVOS_SEL_NOTAU")) or None,
            readout_noskip=(bool(os.environ.get("EVAVOS_READOUT_NOSKIP"))
                            or None),
        ).checked()

    def methods(self) -> tuple:
        """(selection, readout, sel_notau, readout_noskip), resolved; an
        unknown method raises."""
        sel = resolve(self.sel_method, "EVAVOS_SEL_METHOD", "tournament")
        readout = resolve(self.readout_method, "EVAVOS_READOUT_METHOD", "grid")
        if sel not in SEL_METHODS:
            raise ValueError(f"unknown selection method {sel!r}: one of "
                             f"{SEL_METHODS}")
        if readout not in READOUT_METHODS:
            raise ValueError(f"unknown readout method {readout!r}: one of "
                             f"{READOUT_METHODS}")
        return (sel, readout,
                bool(resolve(self.sel_notau, "EVAVOS_SEL_NOTAU", False)),
                bool(resolve(self.readout_noskip, "EVAVOS_READOUT_NOSKIP",
                             False)))

    def checked(self) -> "KernelConfig":
        """This configuration, after :meth:`methods` found its methods
        known."""
        self.methods()
        return self


def resolve(value, env_name: str, default):
    """Explicit value > env var (process-start override) > default; a flag
    (bool default) is on when its variable is set to anything non-empty."""
    if value is not None:
        return value
    v = os.environ.get(env_name)
    if v:
        return True if isinstance(default, bool) else v
    return default
