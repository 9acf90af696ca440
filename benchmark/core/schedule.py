"""The harness's own reckoning of the work of one ``interact``.

An interaction at frame ``idx`` propagates forward to the next interacted
frame (or the video's end) and backward to the previous one (or its start),
each pass segmenting every frame strictly between.  It stores one certain
memory (the interaction's mask) and, in each pass, a transient memory every
``mem_freq`` frames, never at the pass's last frame; the frames between two
stores read one bank.  A pass bounded by an interacted frame on its far
side fuses each frame it segments with the prior prediction (MiVOS's
``inference_core.py``).  The counts come from this schedule, never from
the program.
"""

from __future__ import annotations

from typing import NamedTuple


class Pass(NamedTuple):
    frames: int        # frames segmented
    fused: int         # of them, fused with the prior prediction
    stores: int        # transient memories stored
    reads: tuple       # ((frames, memories in the bank), ...), in order


class Interaction(NamedTuple):
    idx: int
    lo: int            # the frames written: lo..hi-1 (idx among them)
    hi: int
    passes: tuple      # (forward Pass, backward Pass)

    @property
    def frames(self) -> int:
        return sum(p.frames for p in self.passes)

    @property
    def fused(self) -> int:
        return sum(p.fused for p in self.passes)

    @property
    def stores(self) -> int:
        """Memories stored: the certain one and the transients."""
        return 1 + sum(p.stores for p in self.passes)

    @property
    def reads(self) -> tuple:
        return tuple(r for p in self.passes for r in p.reads)


def _pass(n: int, bounded: bool, certain: int, mem_freq: int) -> Pass:
    full, rest = divmod(n, mem_freq)
    reads, stores = [], 0
    for b in range(full):
        reads.append((mem_freq, certain + stores))
        if (b + 1) * mem_freq != n:
            stores += 1
    reads += [(1, certain + stores)] * rest
    return Pass(n, n if bounded else 0, stores, tuple(reads))


def plan(t: int, interacted, idx: int, mem_freq: int) -> Interaction:
    """The work of an interaction at ``idx`` of a ``t``-frame video after
    the interactions at ``interacted`` (each one certain memory)."""
    fwd = min([j for j in interacted if j > idx] + [t])
    bwd = max([j for j in interacted if j < idx] + [-1])
    certain = len(interacted) + 1
    passes = (_pass(fwd - idx - 1, fwd != t, certain, mem_freq),
              _pass(idx - bwd - 1, bwd != -1, certain, mem_freq))
    return Interaction(idx, bwd + 1, fwd, passes)


def plan_session(t: int, frames, mem_freq: int) -> list:
    """The plans of interactions at ``frames``, in order, from a fresh
    session."""
    out = []
    for i, f in enumerate(frames):
        out.append(plan(t, frames[:i], f, mem_freq))
    return out
