"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``_build/lib<name>.so``, a shared library with a plain C interface
loaded through ``ctypes`` — no PyTorch headers, so a build takes seconds.
Builds happen at first use (or all at once, in parallel, through
:func:`build_all`), never at import; a library newer than its source is
reused. ``_build/`` is generated and not under version control.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "load", "nvcc_path", "BUILD_LOG"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("fused_bn", "flash_attention")
# -split-compile=0: the device code's optimisation passes on every core
# (the flash library's 18 kernels build in ~15 s instead of ~37 s on the
# H100 machine's 8 cores, the same tensor-core instruction counts)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0"]

# name -> {"seconds": build wall time, "ptxas": compiler's -v report}
BUILD_LOG = {}
_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, /usr/local/cuda's,
    else the one on PATH."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin and PATH): the CUDA kernels cannot "
                     "be built")


def _paths(name):
    return (os.path.join(SRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, "lib%s.so" % name))


def _stale(name):
    """A library is stale when it is missing or older than its source or
    any header under ``csrc/`` (the sources include them)."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                    if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(f) for f in deps)


def build_all(names=SOURCES, force=False):
    """Compile every named source that is stale (all of them with
    ``force``), one nvcc process per source, all started together.
    Returns ``BUILD_LOG``; raises ``MXNetError`` with the compiler's
    output when a build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        src, lib = _paths(n)
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, src]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib, time.perf_counter())
    failed = []
    for n, (p, tmp, lib, t0) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (n, p.returncode, out))
            continue
        os.replace(tmp, lib)
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def load(name):
    """The loaded ``ctypes.CDLL`` for kernel library ``name``, building it
    first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all((name,))
            lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
        return lib
