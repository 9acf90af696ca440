"""Experiment metric logging: CSV always, wandb when importable (a copy of
``eva_vos_tpu/utils/logging.py``).

``log()`` is O(1): rows append to the open file.  If a row introduces keys
unseen so far, the file is rewritten once under the widened header, so a
long run stays append-only once its schema settles.
"""

from __future__ import annotations

import csv
import os
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, project: str, config=None, out_dir="logs"):
        self.project = project
        self.rows = []
        self._keys: list[str] = []
        self._fh = None
        self._writer = None
        self.out_path = Path(out_dir) / f"{project}_{int(time.time())}.csv"
        self._wandb = None
        try:
            import wandb  # pragma: no cover - not installed in this image

            self._wandb = wandb.init(project=project, config=config or {})
        except Exception:
            pass

    def log(self, metrics: dict):
        row = dict(metrics)
        self.rows.append(row)
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics)
        new_keys = [k for k in row if k not in self._keys]
        if new_keys or self._writer is None:
            self._keys = sorted(set(self._keys) | set(row))
            self._reopen()
        self._writer.writerow(row)
        self._fh.flush()

    def _reopen(self):
        """(Re)write the file under the current header and keep it open."""
        if self._fh is not None:
            self._fh.close()
        os.makedirs(self.out_path.parent, exist_ok=True)
        self._fh = open(self.out_path, "w", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self._keys,
                                      restval="")
        self._writer.writeheader()
        self._writer.writerows(self.rows[:-1])

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._writer = None

    def __del__(self):  # best-effort flush on GC
        try:
            self.close()
        except Exception:
            pass
