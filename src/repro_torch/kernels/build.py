"""Build the port's CUDA C++ kernels from the repo's sources, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with `ctypes`.  The
output lands in ``build/repro_torch_kernels/`` at the repo root, keyed by a
hash of the source and of every shared header in ``csrc/`` (``*.cuh``), so
an edited source or header rebuilds and an unchanged one loads at once.  A failed build raises with the compiler's stderr; nothing
falls back to a plain version.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))

_LOCK = threading.Lock()
_LIBS: dict = {}
# ptxas resource report (registers, shared memory, spills) per source
BUILD_LOGS: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the port's "
            "CUDA kernels are built from csrc/ at first use")
    return found


def _target(name: str) -> tuple:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is built; returns
    (lib path, Popen or None)."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.tmp = tmp
    return lib, proc


def _finish(name: str, lib: Path, proc) -> None:
    if proc is None:
        return
    out, err = proc.communicate()
    if proc.returncode != 0:
        proc.tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu "
            f"(exit {proc.returncode}):\n{err}{out}")
    BUILD_LOGS[name] = err + out
    os.replace(proc.tmp, lib)


def build(names) -> None:
    """Build every named source, all ``nvcc`` processes started together."""
    with _LOCK:
        started = [(n, *_start(n)) for n in names if n not in _LIBS]
        for name, lib, proc in started:
            _finish(name, lib, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        if name not in _LIBS:
            lib, proc = _start(name)
            _finish(name, lib, proc)
            _LIBS[name] = ctypes.CDLL(str(lib))
        return _LIBS[name]
