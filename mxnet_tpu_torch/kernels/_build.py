"""Build and load the hand-written CUDA kernels and the native host code.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``_build/lib<name>.so``, a shared library with a plain C interface
loaded through ``ctypes`` — no PyTorch headers, so a build takes seconds.
The host sources (``csrc/<name>.cc``, :data:`HOST_SOURCES`: the RecordIO
loader, the dependency engine and the pooled host storage) are compiled the same way by the host C++ compiler (``$CXX``,
else ``c++``). The C ABI (:data:`EMBED_SOURCES`: ``csrc/c_api.cc``,
``c_predict_api.cc`` and ``embed_common.cc``) is one library,
``_build/libmxnet.so``, compiled by the host compiler against the running
interpreter's headers. It does not link libpython: loaded into a Python
process its ``Py*`` symbols resolve against that interpreter (a second
libpython in a process whose ``python3`` is linked statically would
start a second interpreter), and a standalone C or C++ program links
libpython itself with :func:`driver_link_flags`. Builds happen at first
use (or all at once, in parallel, through :func:`build_all`), never at
import; a library newer than its
source is reused. Each build writes a name of its own and renames it into
place, so processes that build at once never load a half-written
library. ``_build/`` is generated and not under version control.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import sysconfig
import threading
import time

from ..base import MXNetError

__all__ = ["SOURCES", "HOST_SOURCES", "EMBED_SOURCES", "build_all", "load",
           "nvcc_path", "cxx_path", "lib_path", "ensure_built",
           "driver_link_flags", "libpython_kind", "BUILD_LOG"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("fused_bn", "flash_attention")
HOST_SOURCES = ("recordio", "engine", "storage")
# library -> its sources: the embedded-interpreter C ABI, one library as
# the reference's libmxnet.so
EMBED_SOURCES = {"mxnet": ("c_api", "c_predict_api", "embed_common")}
# -split-compile=0: the device code's optimisation passes on every core
# (the flash library's 18 kernels build in ~15 s instead of ~37 s on the
# H100 machine's 8 cores, the same tensor-core instruction counts)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0"]
# the JAX package's Makefile flags for its native libraries
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

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


def cxx_path():
    """The host C++ compiler: ``$CXX``, else ``c++`` on PATH."""
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if not found:
        raise MXNetError("host C++ compiler %r not found ($CXX, else c++ on "
                         "PATH): the native host libraries (%s) cannot be "
                         "built" % (cxx, ", ".join(HOST_SOURCES)))
    return found


def _sources(name):
    if name in EMBED_SOURCES:
        return [os.path.join(SRC_DIR, s + ".cc") for s in EMBED_SOURCES[name]]
    ext = ".cc" if name in HOST_SOURCES else ".cu"
    return [os.path.join(SRC_DIR, name + ext)]


def lib_path(name):
    """The path of library ``name`` under ``_build/`` (built or not)."""
    return os.path.join(BUILD_DIR, "lib%s.so" % name)


def _stale(name):
    """A library is stale when it is missing or older than its sources or,
    for a CUDA source, any ``.cuh`` header under ``csrc/`` (for the C
    ABI, ``embed_common.h``)."""
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = _sources(name)
    if name in EMBED_SOURCES:
        deps.append(os.path.join(SRC_DIR, "embed_common.h"))
    elif name not in HOST_SOURCES:
        deps += [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                 if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(f) for f in deps)


def _python_include():
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise MXNetError("Python.h not found in %s: the C ABI library "
                         "(csrc/c_api.cc) needs the interpreter's headers"
                         % inc)
    return inc


def _command(name, out):
    if name in EMBED_SOURCES:
        return [cxx_path()] + CXX_FLAGS + ["-I", _python_include(),
                                           "-o", out] + _sources(name)
    src = _sources(name)[0]
    if name in HOST_SOURCES:
        return [cxx_path()] + CXX_FLAGS + ["-o", out, src]
    return [nvcc_path()] + NVCC_FLAGS + ["-o", out, src]


def libpython_kind():
    """``"shared"`` when the running interpreter was built with a shared
    libpython, else ``"static"``."""
    return "shared" if sysconfig.get_config_var("Py_ENABLE_SHARED") \
        else "static"


def driver_link_flags():
    """Link flags for a standalone C or C++ program over the C ABI: the
    library (with an rpath to ``_build/``) and the running interpreter's
    libpython, as ``python3-config --embed --ldflags`` of that
    interpreter gives it (sysconfig's ``LIBDIR``, ``LDLIBRARY``, ``LIBS``
    and ``SYSLIBS``) with an rpath; for a static libpython the whole
    archive and ``-rdynamic``, so that extension modules and the library
    resolve their ``Py*`` symbols against the program. Put them after
    the program's sources. The program's ``PYTHONPATH`` must hold the
    repo and the interpreter's ``site.getsitepackages()``: an embedded
    interpreter does not see a virtual environment on its own."""
    var = sysconfig.get_config_var
    libdir, ver = var("LIBDIR"), var("LDVERSION") or var("VERSION")
    flags = ["-L" + BUILD_DIR, "-lmxnet", "-Wl,-rpath," + BUILD_DIR,
             "-Wl,--no-as-needed"]
    if libpython_kind() == "shared":
        flags += ["-L" + libdir, "-lpython" + ver, "-Wl,-rpath," + libdir]
    else:
        name = var("LIBRARY") or "libpython%s.a" % ver
        archive = next((os.path.join(d, name) for d in (var("LIBPL"), libdir)
                        if d and os.path.exists(os.path.join(d, name))),
                       None)
        if archive is None:
            raise MXNetError("static libpython %s not found in LIBPL or "
                             "LIBDIR: a standalone program cannot embed "
                             "this interpreter" % name)
        flags += ["-rdynamic", "-Wl,--whole-archive", archive,
                  "-Wl,--no-whole-archive"]
    return flags + (var("LIBS") or "").split() + (var("SYSLIBS") or "").split()


def build_all(names=SOURCES, force=False):
    """Compile every named source that is stale (all of them with
    ``force``), one compiler process per source, all started together.
    Returns ``BUILD_LOG``; raises ``MXNetError`` with the compiler's
    output when a build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        lib = lib_path(n)
        tmp = "%s.%d.%d.tmp" % (lib, os.getpid(), threading.get_ident())
        procs[n] = (subprocess.Popen(_command(n, tmp),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib, time.perf_counter())
    failed = []
    for n, (p, tmp, lib, t0) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (n, p.returncode, out))
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, lib)
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise MXNetError("the build failed for " + "\n".join(failed))
    return BUILD_LOG


def ensure_built(name):
    """Build library ``name`` if it is stale. Processes that ask at once
    take turns on a lock of the ``_build/`` directory itself (no file is
    left behind), so one builds and the others find it fresh."""
    if not _stale(name):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd = os.open(BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if _stale(name):
            build_all((name,))
    finally:
        os.close(fd)        # closing releases the lock


def load(name):
    """The loaded ``ctypes.CDLL`` for library ``name``, building it first
    if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            ensure_built(name)
            lib = _libs[name] = ctypes.CDLL(lib_path(name))
        return lib
