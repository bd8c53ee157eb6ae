"""Build and load the port's hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
``paddle_tpu_torch/_build/lib<name>-<hash>.so``, and loaded with
``ctypes``.  The file name carries a hash of the source, of every shared
header ``csrc/*.cuh`` and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded.
Nothing is built at import: the first call that needs a kernel builds
it, and ``build_all()`` builds every source at once, one ``nvcc`` per
source, all started together.

A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas's register/shared-memory report per library, from the last build
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def headers() -> List[str]:
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for f in [name + ".cu"] + headers():
        h.update(f.encode())
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def nvcc_command(name: str, out_path: str, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out_path,
            os.path.join(CSRC_DIR, name + ".cu")]


def _start(name: str, nvcc: str):
    """Start one nvcc into a temp file; returns (proc, tmp, final)."""
    final = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(nvcc_command(name, tmp, nvcc),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, final


def _finish(name: str, proc, tmp: str, final: str):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, final)  # atomic: a concurrent loader sees all or none
    build_logs[name] = out


def build_all() -> Dict[str, float]:
    """Build every source that has no up-to-date library, one nvcc per
    source in parallel.  Returns seconds spent per built source."""
    pending = [n for n in sources() if not os.path.exists(library_path(n))]
    if not pending:
        return {}
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    started = [(n, *_start(n, nvcc)) for n in pending]
    secs = {}
    for name, proc, tmp, final in started:
        _finish(name, proc, tmp, final)
        secs[name] = time.perf_counter() - t0
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not os.path.exists(path):
            _finish(name, *_start(name, find_nvcc()))
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib
