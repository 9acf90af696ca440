"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line.

A driver (``drivers/<name>.py``, named by the traffic file) supplies
``Run``'s steps; the harness owns the clock, the profiler and the result.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

from . import bounds, device as card, guard
from .trace import SLICE, Trace, load_events

# the traced slice, after the measured window: at least this long, and
# ended at the first step boundary past it
TRACE_SECONDS = 3.0


@contextlib.contextmanager
def strict_fp32(torch):
    """TF32 off for convolutions and matrix products (the reference's)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Ctx:
    """What a driver is given: the cell, the run's arguments, the device,
    and ``sync``.  ``plant`` (tests only) is called with the program's
    models after set-up builds them."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", precision: str | None = None,
                 plant=None):
        import torch

        self.torch = torch
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.precision, self.plant = device, precision, plant
        self.cuda = device.startswith("cuda")

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


class Profiled:
    """A ``torch.profiler`` run over the traced slice, read back as a
    ``Trace``; the export goes to a temporary directory and is deleted."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def read(self) -> tuple:
        """(Trace, first and last microsecond of the slice on the trace's
        clock)."""
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            events = load_events(path)
        tr = Trace(events)
        marks = [e for e in tr.host if e["name"] == SLICE]
        lo = marks[0]["ts"] if marks else min(e["ts"] for e in events)
        hi = (marks[0]["ts"] + marks[0]["dur"]) if marks else \
            max(e["ts"] + e["dur"] for e in events)
        return tr, lo, hi


def execute(cell, seed: int, seconds: float, trace: bool, t_start: float,
            device: str = "cuda", precision: str | None = None,
            plant=None, require_card: bool = True) -> dict:
    """Run ``cell`` and return the result line's object (with ``checks``
    last).  ``require_card=False`` (tests) skips the look for a card."""
    import torch

    chips = cell.workload["chips"]
    if require_card:
        card.require_cards(torch, chips)
    ctx = Ctx(cell, seed, seconds, trace, device, precision, plant)
    run = cell.driver().Run(ctx)
    run.setup()
    ctx.sync()
    power = card.power_limit_w() if ctx.cuda else None
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    deadline = run.deadline = t0 + seconds
    while time.perf_counter() < deadline:
        run.step(counted=True)
    window_s = time.perf_counter() - t0
    ctx.sync()
    peak = torch.cuda.max_memory_allocated() if ctx.cuda else 0

    readings = {"window_s": window_s}
    breakdown = device_extra = None
    if trace:
        with Profiled(torch) as prof:
            with torch.profiler.record_function(SLICE):
                with run.tracing():
                    end = run.deadline = time.perf_counter() + TRACE_SECONDS
                    while time.perf_counter() < end:
                        run.step(counted=False)
                    ctx.sync()
        tr, lo, hi = prof.read()
        busy = tr.device_busy_s(lo, hi)
        readings.update(trace=tr, slice_us=(lo, hi), busy_s=busy,
                        slice_s=(hi - lo) / 1e6, peak_tf32=bounds.PEAK_TF32_FLOPS)
        device_extra = {"busy_s": busy, "window_s": (hi - lo) / 1e6}
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps(lo, hi)}
    readings.update(run.readings())

    run.release()
    t_check = time.perf_counter()
    checks = run.check()
    check_s = time.perf_counter() - t_check
    limits = cell.limits["limits"]
    correct = bool(checks) and all(k in checks and checks[k] <= limits[k]
                                   for k in limits)

    found = guard.forbidden_modules(list(__import__("sys").modules))
    if found:
        raise ImportError(f"the run loaded {found}")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(run.end_to_end(window_s, peak), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = card.describe(torch, chips, peak, power) if ctx.cuda else \
        {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if device_extra:
        dev.update(device_extra)
    attempted, failed = run.attempts()
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown:
        out["breakdown"] = breakdown
    out["seconds"] = {"setup": setup_s, "window": window_s, "check": check_s}
    out["readings"] = {k: v for k, v in readings.items()
                       if isinstance(v, (int, float))}
    out["not_compared"] = {k: v for k, v in checks.items() if k not in limits}
    out["check_info"] = getattr(run, "info", {})
    out["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                     for k in limits}
    return out
