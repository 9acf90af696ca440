"""Reading a ``torch.profiler`` trace: device busy time, the kernels of a
named host range, and the breakdown of a traced slice.

``busy_us`` is ``scripts/torch_port_profile.py``'s union of kernel
intervals.  The trace is read from the profiler's Chrome-trace export, in
which each kernel carries the correlation id of the host call that launched
it; a kernel belongs to a host range (a ``record_function``) when its launch
lies inside one.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "bench.slice"  # the harness's range around the whole traced slice


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def load_events(path) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class Trace:
    """The complete events of one trace, split by kind."""

    def __init__(self, events):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("cat") in HOST_CATS]
        counts = defaultdict(int)
        for e in host:
            if e.get("cat") == "cpu_op":
                counts[e.get("tid")] += 1
        # the host thread that ran the program: the one with most ops
        main = max(counts, key=counts.get) if counts else None
        self.host = sorted((e for e in host if e.get("tid") == main),
                           key=lambda e: e["ts"])
        self._starts = [e["ts"] for e in self.host]
        # the outermost harness ranges, which nest no deeper than one
        # another: disjoint, sorted by start
        self._tops, end = [], float("-inf")
        for e in self.host:
            if (e.get("cat") == "user_annotation" and e["ts"] >= end
                    and e["name"] != SLICE):
                self._tops.append(e)
                end = e["ts"] + e["dur"]
        self._top_starts = [e["ts"] for e in self._tops]
        self.launches = {e["args"]["correlation"]: e for e in events
                         if e.get("cat") in LAUNCH_CATS
                         and "correlation" in e.get("args", {})}

    def device_busy_s(self, lo_us=None, hi_us=None) -> float:
        """Seconds in which a device operation ran, within [lo, hi]."""
        iv = []
        for e in self.device:
            s, t = e["ts"], e["ts"] + e["dur"]
            if lo_us is not None:
                s, t = max(s, lo_us), min(t, hi_us)
            if t > s:
                iv.append((s, t))
        return busy_us(iv) / 1e6

    def range_kernels(self, name: str) -> list:
        """The device operations launched inside host ranges ``name``."""
        ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.host
                        if e["name"] == name)
        starts = [s for s, _ in ranges]
        out = []
        for e in self.device:
            launch = self.launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch["ts"]) - 1
            if i >= 0 and launch["ts"] <= ranges[i][1]:
                out.append(e)
        return out

    def top_device_ops(self, n: int = 10) -> list:
        """[[kernel name, seconds], ...] of the ``n`` names with most
        device time."""
        by = defaultdict(float)
        for e in self.device:
            by[e["name"][:120]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def host_label(self, t_us: float, scan: int = 500) -> str:
        """What the host was doing at ``t_us``: the outermost harness range
        (``record_function``) and the innermost host op around it."""
        k = bisect.bisect_right(self._top_starts, t_us) - 1
        outer = (self._tops[k]["name"] if k >= 0 and t_us <= self._tops[k]["ts"]
                 + self._tops[k]["dur"] else None)
        i = bisect.bisect_right(self._starts, t_us) - 1
        inner = None
        for j in range(i, max(-1, i - scan), -1):
            e = self.host[j]
            if e["ts"] + e["dur"] >= t_us:
                inner = e["name"]
                break
        inner = inner or "python"
        return inner if outer in (None, inner) else f"{outer} > {inner}"

    def idle_gaps(self, lo_us: float, hi_us: float, n: int = 10) -> list:
        """[[what the host was doing, idle seconds], ...]: the device's
        idle gaps within [lo, hi] summed by the host's activity at each
        gap's midpoint, the ``n`` largest."""
        busy = merged((max(e["ts"], lo_us), min(e["ts"] + e["dur"], hi_us))
                      for e in self.device
                      if e["ts"] + e["dur"] > lo_us and e["ts"] < hi_us)
        edges = [lo_us] + [x for iv in busy for x in iv] + [hi_us]
        by = defaultdict(float)
        for s, t in zip(edges[0::2], edges[1::2]):
            if t > s:
                by[self.host_label((s + t) / 2)] += (t - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
