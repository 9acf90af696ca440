"""The yardstick's peaks and least-time arithmetic.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity), which assume the card's full 700 W; each run states the card's
power limit beside its numbers.  The configurations run float32, and cuDNN
runs float32 convolutions in TF32 by default, so every operations bound and
every ``mfu`` is taken against the TF32 peak: the fastest rate the card
offers float32 inputs (float32 outside the tensor cores is 67 TFLOP/s, which
a TF32 kernel would exceed).

``bound_ms``, ``selection_bound`` and ``readout_bound`` are the arithmetic
of ``chip_smoke.py`` of the same names, taken from shapes and counts
instead of tensors, and against these peaks.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_TF32_FLOPS):
    """(least ms, 'bytes' or 'operations'): the larger of the two times."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def selection_bound(n: int, valid: int, k: int, ck: int, itemsize: int = 4):
    """Bound of an exact top-k selection: read the queries and the valid
    keys (``ck`` wide) once, write k (score, id) pairs a query; 2 * ck
    flops a (query, token)."""
    n_bytes = itemsize * ck * (n + valid) + 8 * k * n
    return bound_ms(n_bytes, 2.0 * n * valid * ck)


def readout_bound(n: int, k: int, k_obj: int, cv: int, rows: int,
                  picks: int, itemsize: int = 4):
    """Bound of the readout: each of ``rows`` distinct selected rows once
    an object, the selection once, the output once; 2 flops a gathered
    element of each of ``picks`` picks."""
    n_bytes = k_obj * rows * cv * itemsize + 8 * k * n + k_obj * n * cv * itemsize
    return bound_ms(n_bytes, 2.0 * k_obj * picks * cv)


def read_bound_ms(n: int, valid: int, k: int, ck: int, k_obj: int, cv: int,
                  itemsize: int = 4) -> float:
    """Least ms of one memory read (a selection, then its readout) of ``n``
    queries over ``valid`` tokens.  The rows the readout needs depend on
    which tokens the queries pick, which the fused read does not return, so
    the least count is taken: ``min(valid, k)`` distinct rows (each query
    picks k distinct tokens), every pick weighing."""
    k = min(k, valid)
    sel, _ = selection_bound(n, valid, k, ck, itemsize)
    out, _ = readout_bound(n, k, k_obj, cv, rows=min(valid, k), picks=n * k,
                           itemsize=itemsize)
    return sel + out
