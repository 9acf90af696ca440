"""Fusion: the share of the device's busy time in the traced slice spent in
kernels launched inside the program's ``engine.fuse`` spans (one fused
frame: ``get_attention`` and ``_fuse_frame``), in %."""

from pathlib import Path

from benchmark.core.spec import load_module

_decode = load_module(Path(__file__).with_name("decode.device_share.py"),
                      "bench_metric_decode_device_share")


def read(r):
    return _decode.device_share(r, "engine.fuse")
