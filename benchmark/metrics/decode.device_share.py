"""Decoder: the share of the device's busy time in the traced slice spent in
kernels launched inside the program's ``engine.decode`` spans
(``decode_with_readout``), in %."""

from benchmark.core.trace import busy_us


def device_share(r, name):
    """% of the slice's busy time in kernels launched inside host spans
    ``name``; None without a trace or without such a kernel."""
    tr = r.get("trace")
    if tr is None or not r.get("busy_s"):
        return None
    kernels = tr.range_kernels(name)
    if not kernels:
        return None
    lo, hi = r["slice_us"]
    inside = busy_us((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                     for e in kernels if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    return inside / 1e6 / r["busy_s"] * 100


def read(r):
    return device_share(r, "engine.decode")
