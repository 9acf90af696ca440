"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``<repo>/.kernel_build/<name>-<hash>.so`` for ``sm_90a``.  The hash
covers the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited kernel is rebuilt at its first use and an unchanged one is loaded as
it is.  Nothing is built at import:
the first launch, or :func:`build_all`, builds.  A build that fails raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
KERNELS = ("memory_topk", "memory_topk_grid", "memory_topk_resident",
           "memory_readout", "memory_readout_chunked")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the shared library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """The compiler's resource report (registers, shared memory, spills)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=KERNELS) -> dict:
    """Build every missing library, one ``nvcc`` per source, all at once.

    Returns {name: seconds the build took (0.0 when it was already built)}.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # compile to a private name, then rename: concurrent builds never
        # load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(name: str, lib: ctypes.CDLL, status: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        msg = getattr(lib, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({status})")
