"""ctypes bindings for the native RecordIO loader (``csrc/recordio.cc``).

Counterpart of ``mxnet_tpu/_native.py``. The library is the port's own
copy of the JAX package's ``src/recordio.cc``: a RecordIO scan and a
threaded batch assembler (``(x * scale - mean) / std`` into float32 CHW
batches, shuffled by its own ``mt19937_64(seed)``). ``kernels/_build.py``
builds it with the host C++ compiler at first use. Unlike the JAX
package, nothing here is optional: a build or load that fails raises
``MXNetError`` with the compiler's output, and the caller does not fall
back to Python in silence.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from .base import MXNetError

_LIB = None
_lock = threading.Lock()


def lib():
    """The loaded native library, built first if it is missing or older
    than its source."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        from .kernels import _build
        try:
            L = _build.load("recordio")
        except OSError as e:
            raise MXNetError("the native RecordIO loader does not load: %s"
                             % e)
        # the functions the loader calls (the library also exports the
        # JAX package's rio_num_records/rio_record_* scan calls)
        L.rio_open.restype = ctypes.c_void_p
        L.rio_open.argtypes = [ctypes.c_char_p]
        L.rio_close.argtypes = [ctypes.c_void_p]
        L.loader_create.restype = ctypes.c_void_p
        L.loader_create.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_uint64, ctypes.c_float,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_float)]
        L.loader_next.restype = ctypes.c_int
        L.loader_next.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_float)]
        L.loader_reset.argtypes = [ctypes.c_void_p]
        L.loader_destroy.argtypes = [ctypes.c_void_p]
        _LIB = L
        return _LIB


class NativeRecordLoader:
    """Threaded native batch loader over a local RecordIO file: float32
    ``(batch, C, H, W)`` data and ``(batch,)`` labels per :meth:`next`,
    whole batches only (the partial tail is dropped)."""

    def __init__(self, path, batch_size, data_shape, num_threads=4,
                 shuffle=False, seed=0, scale=1.0, mean=(0, 0, 0),
                 std=(1, 1, 1)):
        L = self._L = lib()
        self._file = L.rio_open(path.encode())
        if not self._file:
            raise MXNetError("the native loader cannot read RecordIO file %r"
                             % path)
        c, h, w = data_shape
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        mean_a = (ctypes.c_float * 3)(*[float(m) for m in mean])
        std_a = (ctypes.c_float * 3)(*[float(s) for s in std])
        self._loader = L.loader_create(self._file, batch_size, c, h, w,
                                       num_threads, int(shuffle), seed,
                                       float(scale), mean_a, std_a)

    def next(self):
        c, h, w = self.data_shape
        data = np.empty((self.batch_size, c, h, w), np.float32)
        label = np.empty((self.batch_size,), np.float32)
        ok = self._L.loader_next(
            self._loader,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not ok:
            raise StopIteration
        return data, label

    def reset(self):
        self._L.loader_reset(self._loader)

    def __del__(self):
        try:
            if getattr(self, "_loader", None):
                self._L.loader_destroy(self._loader)
            if getattr(self, "_file", None):
                self._L.rio_close(self._file)
        except Exception:
            pass
