"""Memory read: the share of the device's busy time in the traced slice
spent in kernels launched inside the ``memory_read`` ranges, in %."""


def read(r):
    tr = r.get("trace")
    if tr is None or not r.get("busy_s"):
        return None
    kernels = tr.range_kernels("memory_read")
    if not kernels:
        return None
    lo, hi = r["slice_us"]
    from benchmark.core.trace import busy_us

    inside = busy_us((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                     for e in kernels if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    return inside / 1e6 / r["busy_s"] * 100
