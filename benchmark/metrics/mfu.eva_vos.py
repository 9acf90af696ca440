"""Whole round: operations the algorithm needs for the measured window's
work (the reference's networks counted on meta tensors, times the
harness's own counts of frames encoded, decoded, stored and fused, of each
read, of SAM's image encodes and prompt decodes, QNet's frames and the
agent's decisions) over the window's seconds at the TF32 peak, in %."""


def read(r):
    if not r.get("flops"):
        return None
    return r["flops"] / (r["window_s"] * r["peak_tf32"]) * 100
