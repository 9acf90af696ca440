"""Fusion: the share of the traced slice in which no operation ran on the
card while the host's main thread was inside an ``engine.fuse`` span (one
fused frame: ``get_attention`` and ``_fuse_frame``), in %; computed as
``engine.idle_share``, whose spans hold these, so it is at most that."""

from pathlib import Path

from benchmark.core.spec import load_module

_engine = load_module(Path(__file__).with_name("engine.idle_share.py"),
                      "bench_metric_engine_idle_share")


def read(r):
    return _engine.idle_inside(r, ("engine.fuse",))
