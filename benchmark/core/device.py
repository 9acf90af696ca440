"""The card: the checks a run makes before it starts, what it reports of
the card, and where builds and kernel caches go.

Every build and kernel cache stays at a fixed path inside the checkout, so
that only the first run of a cell there builds: the port's ``nvcc``
libraries go to ``.kernel_build/`` (its ``kernels/build.py``), and the
caches of Triton, torch extensions and the CUDA driver's JIT under it.
"""

from __future__ import annotations

import os
import subprocess

from .spec import ROOT

CACHE_DIRS = {
    "TRITON_CACHE_DIR": ROOT / ".kernel_build" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / ".kernel_build" / "torch_extensions",
    "CUDA_CACHE_PATH": ROOT / ".kernel_build" / "cuda_jit",
}


def set_cache_dirs() -> None:
    """Point every cache at its directory in the checkout (before torch
    is imported)."""
    for var, path in CACHE_DIRS.items():
        os.environ[var] = str(path)


class NoDevice(RuntimeError):
    """The cards this cell needs are not there."""


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} found")


def power_limit_w():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(torch, chips: int, peak_bytes: int, power_w) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes),
            "power_limit_w": power_w}
