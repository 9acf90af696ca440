"""Whole step: operations the algorithm needs for the measured window's
work (the reference's networks counted on meta tensors, times the
harness's own counts of frames encoded, frames decoded, memories stored,
frames fused, and each read's scores and weighted sum) over the window's
seconds at the TF32 peak, in %."""


def read(r):
    if not r.get("flops"):
        return None
    return r["flops"] / (r["window_s"] * r["peak_tf32"]) * 100
