"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``<repo>/.kernel_build/<library>-<hash>.so`` for ``sm_90a``: one
library ``<name>``, or, for the selections of WIDTH_KERNELS, one library
``<name>@<CKP>`` for each padded key width CKP of KEY_WIDTHS (built with
``-DTOPK_KEY_WIDTH=<CKP>``: that width's instances alone, so that the
widths compile side by side).  The hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt at
its first use and an unchanged one is loaded as it is.  Nothing is built at import:
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

from ..utils.profiling import TRACE

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
KEY_WIDTHS = (16, 32, 64, 128, 256)  # topk_common.cuh's padded widths CKP
WIDTH_KERNELS = ("memory_topk", "memory_topk_grid", "memory_topk_resident",
                 "memory_topk_iter", "memory_topk_sort")
KERNELS = WIDTH_KERNELS + ("memory_readout", "memory_readout_chunked")
# every library: a source of KERNELS, or a selection at one key width
LIBRARIES = tuple(f"{name}@{w}" for name in WIDTH_KERNELS
                  for w in KEY_WIDTHS) + KERNELS[len(WIDTH_KERNELS):]
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


def source(library: str) -> str:
    """The source name of a library of LIBRARIES (``memory_topk@64`` ->
    ``memory_topk``): its ``csrc/<name>.cu`` and the prefix of its C
    interface's functions."""
    return library.partition("@")[0]


def _flags(library: str) -> list:
    width = library.partition("@")[2]
    return [*NVCC_FLAGS, *([f"-DTOPK_KEY_WIDTH={width}"] if width else [])]


def library_path(library: str) -> Path:
    """Where the shared library ``library`` of LIBRARIES lives."""
    digest = hashlib.sha256((CSRC / f"{source(library)}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(library)).encode())
    return BUILD_DIR / f"{library}-{digest.hexdigest()[:16]}.so"


def ptxas_log(library: str) -> str:
    """The compiler's resource report (registers, shared memory, spills)."""
    log = library_path(library).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=LIBRARIES) -> dict:
    """Build every missing library, one ``nvcc`` per library, all at once.

    Returns {library: seconds its build took (0.0 when it was already
    built)}.  A call that runs ``nvcc`` is the span ``kernels.build`` of
    ``utils.profiling.TRACE`` and counts ``kernel_builds``, one a library.
    """
    seconds = {name: 0.0 for name in names}
    missing = [name for name in names if not library_path(name).exists()]
    if missing:
        with TRACE.span("kernels.build"):
            seconds.update(_build(missing))
        TRACE.count("kernel_builds", len(missing))
    return seconds


def _build(names) -> dict:
    """Compile ``names`` side by side -> {library: seconds}.

    Each compiler writes its report to its own log file, so that none waits
    on a full pipe while another is read.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        # compile to a private name, then rename: concurrent builds never
        # load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = tmp.with_suffix(".log")
        cmd = [nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{source(name)}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, log, out, time.perf_counter())
    seconds = {}
    pending = dict(procs)
    while pending:
        for name, (proc, *_, t0) in list(pending.items()):
            if proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
                del pending[name]
        time.sleep(0.05)
    failed = []
    for name, (proc, tmp, log, out, _) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.read_text()}")
            log.unlink()
            continue
        os.replace(log, out.with_suffix(".log"))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(library: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library ``library`` of
    LIBRARIES."""
    build_all((library,))
    lib = ctypes.CDLL(str(library_path(library)))
    err = getattr(lib, f"{source(library)}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(name: str, lib: ctypes.CDLL, status: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        msg = getattr(lib, f"{name}_error_string")(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({status})")
