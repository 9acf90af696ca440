"""Experiment tables in CSV, in pandas' text, on the ``csv`` module.

The JAX CLI writes its results with ``pd.DataFrame.from_dict(columns)
.to_csv(index=False)`` and reads them back with ``pd.read_csv``; these
functions write and read the same text without pandas.  A column of numbers
with a float in it is a float column (its ints written as floats, NaN as an
empty cell); every other cell is ``str(value)`` (``repr`` for a float, the
list's text for a list).  Read back, a column whose cells are all integers
is ints, one whose cells all parse as floats (an empty cell as NaN) is
floats, and any other column keeps its text.
"""

from __future__ import annotations

import csv
import math
import re
from numbers import Integral, Real

_INT = re.compile(r"[+-]?\d+")


def _cells(values: list) -> list[str]:
    floats = (all(isinstance(v, Real) and not isinstance(v, bool)
                  for v in values)
              and not all(isinstance(v, Integral) for v in values))
    if not floats:
        return [str(v) for v in values]
    return ["" if math.isnan(v) else repr(float(v)) for v in values]


def write_columns(path, columns: dict[str, list]):
    """``columns`` (name -> values, all of one length) as CSV at ``path``,
    in the order given."""
    lengths = {len(v) for v in columns.values()}
    if len(lengths) > 1:
        raise ValueError(f"columns of different lengths: {sorted(lengths)}")
    cells = [_cells(v) for v in columns.values()]
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*cells))


def _parse(cells: list[str]) -> list:
    if cells and all(_INT.fullmatch(c) for c in cells):
        return [int(c) for c in cells]
    try:
        return [float(c) if c else math.nan for c in cells]
    except ValueError:
        return cells


def read_columns(path) -> dict[str, list]:
    """The columns of a CSV with a header row, typed as above."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = list(reader)
    return {name: _parse([row[i] for row in rows])
            for i, name in enumerate(header)}
