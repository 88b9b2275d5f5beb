"""Build and load the hand-written CUDA kernels in ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``ops/_build/lib<name>.so`` at
first use, then loaded with ``ctypes``.  A library is rebuilt when its
source or a shared header (``csrc/*.cuh``) is newer.  Nothing here runs
at import time: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$NVCC``, ``PATH``, or the default
    toolkit location)."""
    path = os.environ.get("NVCC") or shutil.which("nvcc")
    if path:
        return path
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of mash_tpu_torch need the CUDA "
        "toolkit (set NVCC or put nvcc on PATH)"
    )


def _paths(name: str):
    return (
        os.path.join(_CSRC, name + ".cu"),
        os.path.join(_BUILD, "lib%s.so" % name),
    )


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
               if f.endswith(".cuh")]
    newest = max(os.path.getmtime(p) for p in [src, *headers])
    return os.path.getmtime(so) < newest


def build(names: Iterable[str]) -> None:
    """Compile the stale libraries among ``names``, one ``nvcc`` process
    per source, all started together."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    os.makedirs(_BUILD, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name in todo:
        src, so = _paths(name)
        tmp = "%s.%d.tmp" % (so, os.getpid())
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )))
    errors = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append("%s:\n%s" % (name, out.decode(errors="replace")))
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("nvcc failed for " + "\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (what, status))
