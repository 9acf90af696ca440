"""Device: the share of the traced slice in which no operation ran on the
card, in % (1 - the union of device operations over the slice)."""


def read(r):
    if r.get("trace") is None or not r.get("slice_s"):
        return None
    return (1 - r["busy_s"] / r["slice_s"]) * 100
