"""Tracing and profiling helpers (counterpart of
``eva_vos_tpu/utils/profiling.py``): wall-clock spans, and a device trace
on ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class WallClock:
    """Accumulates named wall-clock spans; ``summary()`` -> dict of
    (total_s, count, mean_s)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

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
        return "\n".join(lines)


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
