"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything particular to a configuration, a traffic mix, a cell or a
per-layer metric lives in a file of its own, found by name:

* ``configs/<config>.json``: the configuration (``BENCHMARK.json`` names
  the file), with its plain reference ``reference/<reference>.py``;
* ``traffic/<traffic>.json``: a traffic mix, parameters for the driver it
  names (``drivers/<driver>.py``);
* ``limits/<cell>.json``: the limits of the numbers that decide a cell's
  ``correct``;
* ``metrics/<metric>.py``: the reader of a per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and limits, and the metrics it reports."""

    def __init__(self, workload: dict, config: dict, traffic: dict,
                 limits: dict, end_to_end: list, per_layer: list):
        self.name = workload["name"]
        self.workload, self.config, self.traffic = workload, config, traffic
        self.limits = limits
        self.end_to_end = [m for m in end_to_end if self._mine(m)]
        self.per_layer = [m for m in per_layer if self._mine(m)]

    @classmethod
    def load(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = read_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}: one of {sorted(cells)}")
        w = cells[name]
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        return cls(w, read_json(root / entry["file"]),
                   read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                   read_json(BENCH / "limits" / f"{name}.json"),
                   bench["end_to_end"], bench["per_layer"])

    def _mine(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self):
        d = self.traffic["driver"]
        return load_module(BENCH / "drivers" / f"{d}.py", f"bench_driver_{d}")

    def reference(self):
        r = self.config["reference"]
        return load_module(BENCH / "reference" / f"{r}.py", f"bench_reference_{r}")

    def reader(self, metric: str):
        return load_module(BENCH / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")
