"""Engine: the median wall time of the measured window's
``Session.interact`` calls, in ms; steadier than the 95th percentile
beside it."""


def read(r):
    return r.get("interact_median_ms")
