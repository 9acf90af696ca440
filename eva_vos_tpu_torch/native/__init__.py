"""ctypes bindings of the native click-robot functions (counterpart of
``eva_vos_tpu/native``).

``click_ops.cpp`` is compiled at first use (``g++ -O3 -shared -fPIC``) into
``<repo>/.kernel_build/click_ops-<hash>.so``, keyed by a hash of the source
and the flags, and loaded from there afterwards.  A build that fails
raises with the compiler's output: nothing falls back to scipy here (the
robots choose scipy only when ``EVAVOS_NATIVE=0``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "click_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"click_ops-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; a failure raises."""
    lib = ctypes.CDLL(str(build()))
    lib.largest_component_center.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.largest_component_center.restype = None
    lib.nearest_true.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.nearest_true.restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _as_u8(mask: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(np.asarray(mask, dtype=bool).astype(np.uint8))
    if m.ndim != 2:
        raise ValueError(f"a 2-d mask is needed, got shape {m.shape}")
    return m


def largest_component_center(mask: np.ndarray):
    """-> (center_x, center_y, size) of the largest 8-connected component,
    or None when the mask is empty."""
    lib = load()
    m = _as_u8(mask)
    h, w = m.shape
    ox, oy, osz = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    lib.largest_component_center(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        ctypes.byref(ox), ctypes.byref(oy), ctypes.byref(osz))
    if osz.value == 0:
        return None
    return int(ox.value), int(oy.value), int(osz.value)


def nearest_true(mask: np.ndarray, x: int, y: int):
    """Nearest true pixel to (x, y); ties resolve like np.argmin over
    row-major np.where output.  Returns (x, y), or None if the mask is
    empty."""
    lib = load()
    m = _as_u8(mask)
    h, w = m.shape
    ox, oy = ctypes.c_int(), ctypes.c_int()
    lib.nearest_true(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        int(x), int(y), ctypes.byref(ox), ctypes.byref(oy))
    if ox.value < 0:
        return None
    return int(ox.value), int(oy.value)
