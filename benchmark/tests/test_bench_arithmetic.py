"""The copied bound arithmetic and the busy-union arithmetic on known
shapes and intervals."""

import pytest

from benchmark.core import bounds
from benchmark.core.trace import Trace, busy_us, merged


def test_bound_takes_the_larger_time():
    assert bounds.bound_ms(3.35e9, 0.0) == (pytest.approx(1.0), "bytes")
    assert bounds.bound_ms(0.0, 495e9) == (pytest.approx(1.0), "operations")


def test_selection_bound_at_fill_72():
    # chip_smoke.py's fill-72 case: N 8,100 queries, 116,640 tokens, CK 64:
    # 2 N M CK = 120.9 GFLOP, 0.1223 ms at 989 TFLOP/s (its bf16 peak),
    # twice that at the TF32 peak
    ms, by = bounds.selection_bound(8100, 116640, 50, 64, itemsize=2)
    assert by == "operations"
    assert ms == pytest.approx(2 * 8100 * 116640 * 64 / 495e12 * 1e3)
    assert ms == pytest.approx(0.1223 * 989 / 495, rel=1e-3)


def test_readout_bound_counts_rows_once():
    # K = 1, CV 512, fp32: 1,000 rows + 50 (score, id) pairs a query + the
    # output, against 2 flops a gathered element
    ms, by = bounds.readout_bound(n=100, k=50, k_obj=1, cv=512, rows=1000,
                                  picks=5000, itemsize=4)
    n_bytes = 1000 * 512 * 4 + 8 * 50 * 100 + 100 * 512 * 4
    assert by == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)


def test_read_bound_is_selection_plus_readout():
    sel, _ = bounds.selection_bound(1620, 3240, 50, 64, 4)
    out, _ = bounds.readout_bound(1620, 50, 1, 512, 50, 1620 * 50, 4)
    assert bounds.read_bound_ms(1620, 3240, 50, 64, 1, 512, 4) == pytest.approx(sel + out)
    # fewer valid tokens than top_k: k is the tokens there are
    assert bounds.read_bound_ms(10, 20, 50, 64, 1, 512, 4) == pytest.approx(
        bounds.selection_bound(10, 20, 20, 64, 4)[0]
        + bounds.readout_bound(10, 20, 1, 512, 20, 200, 4)[0])


def test_busy_union():
    assert busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert busy_us([(5, 6), (0, 10)]) == 10
    assert busy_us([]) == 0
    assert merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
         "pid": 1, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_trace_ranges_busy_and_gaps():
    events = [
        _x("user_annotation", "session.interact", 0, 100),
        _x("user_annotation", "memory_read", 10, 10),
        _x("cpu_op", "aten::conv", 30, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 32, 1, corr=2),
        _x("kernel", "topk_prune_block_kernel", 40, 5, tid=7, corr=1),
        _x("kernel", "conv_kernel", 50, 10, tid=7, corr=2),
    ]
    tr = Trace(events)
    assert [e["name"] for e in tr.range_kernels("memory_read")] == ["topk_prune_block_kernel"]
    assert tr.device_busy_s(0, 100) == pytest.approx(15e-6)
    assert tr.device_busy_s(42, 55) == pytest.approx(8e-6)
    assert tr.top_device_ops() == [["conv_kernel", 10e-6], ["topk_prune_block_kernel", 5e-6]]
    gaps = dict(tr.idle_gaps(0, 100))
    # 0-40 (midpoint 20: inside memory_read), 45-50, 60-100
    assert gaps["session.interact > memory_read"] == pytest.approx(40e-6)
    assert gaps["session.interact > aten::conv"] == pytest.approx(5e-6)
    assert gaps["session.interact"] == pytest.approx(40e-6)
