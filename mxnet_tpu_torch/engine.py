"""Engine: the host-side dependency scheduler and the engine knobs.

Counterpart of ``mxnet_tpu/engine.py`` (parity: reference
``python/mxnet/engine.py``'s ``set_bulk_size``/``bulk``, plus a Python
face for the native dependency engine). The native half is the port's
copy of the JAX package's ``src/engine.cc``, ``kernels/csrc/engine.cc``,
built with the host C++ compiler at first use (``kernels/_build.py``).

Division of labour: device work is ordered by PyTorch on its CUDA
streams, in program order, so the reference's per-device worker threads
have nothing to do; ``mx.nd.waitall`` synchronises the card. Host work
(record prefetch, augmentation, checkpoint writes, the next batch's data)
still wants dataflow scheduling, and that is this engine: ``push`` a
callable with read and write variable sets; per-variable queues grant
concurrent readers and exclusive writers in push order (the reference's
ThreadedVar discipline, threaded_engine.h:66-217).

``MXNET_ENGINE_TYPE=NaiveEngine`` runs pushed work synchronously in the
caller (the reference's debugging mode, threaded_engine.h:355-368);
``MXNET_CPU_WORKER_NTHREADS`` sizes the worker pool.

Unlike the JAX package, which runs pushed work synchronously in Python
when its library is missing, the port raises ``MXNetError`` when the
library cannot be built or loaded. An exception raised by pushed work is
kept and raised again, as ``MXNetError`` with the original as its cause,
by the next ``wait_for_var`` or ``wait_all`` (the JAX package prints it
and drops it).
"""
from __future__ import annotations

import ctypes
import os
import threading

from .base import MXNetError, get_env

__all__ = ["Engine", "get", "set_bulk_size", "bulk", "NaiveEngine"]

_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_lib_lock = threading.Lock()
_LIB = None


def _lib():
    """The loaded native engine, built first if it is missing or older
    than its source."""
    global _LIB
    with _lib_lock:
        if _LIB is not None:
            return _LIB
        from .kernels import _build
        try:
            L = _build.load("engine")
        except OSError as e:
            raise MXNetError("the native engine does not load: %s" % e)
        L.eng_create.restype = ctypes.c_void_p
        L.eng_create.argtypes = [ctypes.c_int, ctypes.c_int]
        L.eng_destroy.argtypes = [ctypes.c_void_p]
        L.eng_new_var.restype = ctypes.c_int64
        L.eng_new_var.argtypes = [ctypes.c_void_p]
        L.eng_delete_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.eng_push.argtypes = [
            ctypes.c_void_p, _CB, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
        L.eng_wait_for_var.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.eng_wait_all.argtypes = [ctypes.c_void_p]
        _LIB = L
        return _LIB


class Var:
    """An engine variable: names one unit of mutable host state."""

    __slots__ = ("id", "_engine")

    def __init__(self, vid, engine):
        self.id = vid
        self._engine = engine


class Engine:
    """The native threaded dependency engine over host worker threads.

    ``push(fn, const_vars=[...], mutable_vars=[...])`` runs ``fn()`` once
    every earlier writer of a variable it reads, and every earlier
    accessor of a variable it writes, has completed."""

    def __init__(self, num_workers=None, naive=None):
        if num_workers is None:
            num_workers = get_env("MXNET_CPU_WORKER_NTHREADS",
                                  os.cpu_count() or 4, int)
        if naive is None:
            naive = get_env("MXNET_ENGINE_TYPE", "") == "NaiveEngine"
        self._naive = bool(naive)
        self._L = _lib()
        self._pending = {}          # token -> python fn, until it runs
        self._pending_lock = threading.Lock()
        self._next_token = 1        # 0 would arrive as NULL/None in C
        self._error = None          # the first exception of pushed work
        # ONE persistent CFUNCTYPE per engine; each op's fn is looked up
        # by the token passed through the C ``void* arg``, so no per-op
        # trampoline is freed while C still returns through it
        self._cb = _CB(self._dispatch)
        self._h = ctypes.c_void_p(
            self._L.eng_create(int(num_workers), int(self._naive)))

    @property
    def naive(self):
        """Whether pushed work runs synchronously in the caller."""
        return self._naive

    # -- vars -------------------------------------------------------------
    def new_var(self):
        return Var(self._L.eng_new_var(self._h), self)

    def delete_var(self, var):
        """Drop ``var`` once every op pushed on it has completed."""
        self._L.eng_delete_var(self._h, var.id)

    # -- push -------------------------------------------------------------
    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        """Schedule ``fn()`` with the given read and write sets. Raises if
        the sets overlap or a variable is written twice (the reference's
        CheckDuplicate, threaded_engine.h:409: either would deadlock the
        variable's queue)."""
        cids = [v.id for v in const_vars]
        mids = [v.id for v in mutable_vars]
        if set(cids) & set(mids):
            raise MXNetError("const_vars and mutable_vars overlap")
        if len(set(mids)) != len(mids):
            raise MXNetError("duplicate mutable vars")
        with self._pending_lock:
            token = self._next_token
            self._next_token += 1
            self._pending[token] = fn
        c_arr = (ctypes.c_int64 * max(len(cids), 1))(*(cids or [0]))
        m_arr = (ctypes.c_int64 * max(len(mids), 1))(*(mids or [0]))
        self._L.eng_push(self._h, self._cb, ctypes.c_void_p(token), c_arr,
                         len(cids), m_arr, len(mids), int(priority))
        if self._naive:
            self._raise_error()

    def _dispatch(self, arg):
        # runs on a native worker thread (ctypes takes the GIL)
        with self._pending_lock:
            fn = self._pending.pop(int(arg or 0), None)
        if fn is None:
            return
        try:
            fn()
        except Exception as e:      # never let an exception cross into C
            with self._pending_lock:
                if self._error is None:
                    self._error = e

    def _raise_error(self):
        with self._pending_lock:
            err, self._error = self._error, None
        if err is not None:
            raise MXNetError("work pushed to the engine raised: %r"
                             % (err,)) from err

    def wait_for_var(self, var):
        """Block until every op pushed so far that writes ``var`` has
        completed; raise the first error of pushed work."""
        self._L.eng_wait_for_var(self._h, var.id)
        self._raise_error()

    def wait_all(self):
        """Block until every pushed op has completed; raise the first
        error of pushed work."""
        self._L.eng_wait_all(self._h)
        self._raise_error()

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._L.eng_destroy(h)


def NaiveEngine():
    """A synchronous engine (parity: ``MXNET_ENGINE_TYPE=NaiveEngine``)."""
    return Engine(naive=True)


_default = None
_default_lock = threading.Lock()


def get():
    """The process-wide engine (parity: ``Engine::Get``), made at first
    call from ``MXNET_ENGINE_TYPE`` and ``MXNET_CPU_WORKER_NTHREADS``."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Engine()
        return _default


# ---------------------------------------------------------------------------
# Bulk-execution knobs (parity: mx.engine.set_bulk_size / bulk). PyTorch
# dispatches op by op, so nothing reads the size: it is kept for the
# reference's API, as in the JAX package (whose jit scope bundles ops).
# ---------------------------------------------------------------------------

_bulk_size = 15


def set_bulk_size(size):
    """Set the size limit on bulk execution; returns the previous one."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


class _BulkScope:
    def __init__(self, size):
        self._size = size
        self._old_size = None

    def __enter__(self):
        self._old_size = set_bulk_size(self._size)
        return self

    def __exit__(self, ptype, value, trace):
        set_bulk_size(self._old_size)


def bulk(size):
    """A scope in which the bulk size is ``size``."""
    return _BulkScope(size)
