"""Engine: the share of the traced slice in which no operation ran on the
card while the host's main thread was inside an ``engine.interact`` or
``engine.precompute`` span (the program's own ``record_function`` ranges,
``utils/profiling.py``), in %.  The device's busy intervals are merged as
``device.idle_share.stcn`` merges them, and their complement in the slice is
intersected with the union of the spans; so it is at most
``device.idle_share.stcn``, and the gap between the two is idle time outside
the engine."""

from benchmark.core.trace import merged

SPANS = ("engine.interact", "engine.precompute")


def idle_inside(r, names):
    """% of the slice idle on the card inside host spans ``names``; None
    without a trace or without such a span."""
    tr = r.get("trace")
    if tr is None or not r.get("slice_s"):
        return None
    lo, hi = r["slice_us"]
    spans = merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in tr.host if e["name"] in names
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    if not spans:
        return None
    busy = merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                  for e in tr.device
                  if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    covered, i = 0.0, 0
    for s, t in spans:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < t:
            covered += min(t, busy[j][1]) - max(s, busy[j][0])
            j += 1
    idle = sum(t - s for s, t in spans) - covered
    return idle / (hi - lo) * 100


def read(r):
    return idle_inside(r, SPANS)
