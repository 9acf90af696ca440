"""Engine networks: milliseconds of ``precompute_features`` a frame (the
key encoder, its projections and the decoder's skip convolutions), timed
by the harness to a synchronise over the opens of the window and of the
traced slice of a ``--trace 1`` run."""


def read(r):
    if not r.get("encode_frames"):
        return None
    return r["encode_s"] / r["encode_frames"] * 1e3
