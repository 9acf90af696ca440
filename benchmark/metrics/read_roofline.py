"""Memory read: the share of its roofline that the read (#1 + #2) reaches, in %
(``<kernel>_roofline``).

The least time of every read in the traced slice (``bounds.read_bound_ms``
at its queries, valid tokens, top_k, key and value widths, objects and key
bytes) over the device time of the kernels launched inside the harness's
``memory_read`` ranges around the engine's ``memory_readout``."""

from benchmark.core.bounds import read_bound_ms


def read(r):
    tr = r.get("trace")
    if tr is None or not r.get("reads"):
        return None
    kernels = tr.range_kernels("memory_read")
    device_ms = sum(e["dur"] for e in kernels) / 1e3
    if device_ms <= 0:
        return None
    least = sum(read_bound_ms(n, valid, k, ck, k_obj, cv, itemsize)
                for n, valid, k, ck, k_obj, cv, itemsize in r["reads"])
    return least / device_ms * 100
