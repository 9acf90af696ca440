"""Tracing and profiling helpers (counterpart of
``eva_vos_tpu/utils/profiling.py``): wall-clock spans and counters, and a
device trace on ``torch.profiler``.

A span accumulates its wall-clock total, and while a ``torch.profiler``
session records it is also a ``record_function`` range, so that it lands on
the profiler's clock over the kernels it launched.  With no profiler
recording, a span costs one flag read beside its totals.

``TRACE`` is the process's own clock: the engine, the feature cache, the
kernel build and the model build report to it (the names are listed in
README.md, "Timers").  ``Session.timers`` is a clock of each session's own.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


class _Span:
    """One ``WallClock.span``: a class rather than a generator, so that a
    span with no profiler recording pays no ``record_function``."""

    __slots__ = ("clock", "name", "t0", "range")

    def __init__(self, clock: "WallClock", name: str):
        self.clock, self.name = clock, name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        self.clock.totals[self.name] += dt
        self.clock.counts[self.name] += 1
        return False


class WallClock:
    """Accumulates named wall-clock spans and counters; ``summary()`` ->
    dict of (total_s, count, mean_s) a span."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.counters.clear()

    def summary(self) -> dict:
        return {
            name: {"total_s": round(self.totals[name], 4),
                   "count": self.counts[name],
                   "mean_s": round(self.totals[name] / self.counts[name], 4)}
            for name in self.totals
        }

    def report(self) -> str:
        lines = ["timer                      total      n     mean"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{name:<24} {s['total_s']:>8.2f}s {s['count']:>5} "
                         f"{s['mean_s']:>8.4f}s")
        if self.counters:
            lines.append("counter                    value")
            lines += [f"{name:<24} {n:>10}"
                      for name, n in sorted(self.counters.items())]
        return "\n".join(lines)


# the process's clock
TRACE = WallClock()


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """A ``torch.profiler`` trace of the host and, where there is one, the
    CUDA device, written to ``logdir`` as a Chrome trace when a logdir is
    given; no-op otherwise."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
