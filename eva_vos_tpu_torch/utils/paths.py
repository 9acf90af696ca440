"""Dataset / weight path configuration (a copy of
``eva_vos_tpu/utils/paths.py``).

One env-overridable data root (``EVAVOS_DATA_ROOT``, default ``data/``) and
a weights root (``EVAVOS_WEIGHTS_ROOT``, default ``model_weights/``).
"""

from __future__ import annotations

import os
from pathlib import Path


class DataPaths:
    @staticmethod
    def data_root() -> Path:
        return Path(os.environ.get("EVAVOS_DATA_ROOT", "data"))

    @staticmethod
    def db_root(dataset: str = "DAVIS_17") -> Path:
        return DataPaths.data_root() / dataset

    @staticmethod
    def weights_root() -> Path:
        return Path(os.environ.get("EVAVOS_WEIGHTS_ROOT", "model_weights"))
