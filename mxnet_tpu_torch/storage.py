"""The storage manager.

Counterpart of ``mxnet_tpu/storage.py`` (parity: reference
``include/mxnet/storage.h``, ``Storage::Get()->Alloc/Free/DirectFree``,
and ``src/storage/``). The split of duties:

* **Device memory** belongs to PyTorch's caching allocator, which pools
  device blocks itself, so the framework runs no device free-list of its
  own. ``device_stats`` reads ``torch.cuda.memory_stats`` where the JAX
  package reads PJRT's per-device stats, and ``ledger_report`` holds the
  port's buffer ledger (``telemetry.ledger``) against it.
* **Host staging memory** (batch assembly, ``resource`` temp space) is
  the framework's: a size-bucketed pooled allocator of pageable host
  memory, the port's copy of the JAX package's ``src/storage.cc``
  (``kernels/csrc/storage.cc``), built with the host C++ compiler at
  first use. Where the JAX package falls back to numpy when its library
  is missing, the port raises ``MXNetError``.

``alloc`` returns a ``Handle`` whose ``array(shape, dtype)`` is a numpy
view of the pooled buffer: a producer fills it in place and hands it to
``mx.nd.array`` for the copy to the card.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .base import MXNetError

__all__ = ["Handle", "Storage"]

_LIB = None
_lock = threading.Lock()


def _native():
    """The loaded native pool, built first if it is missing or older
    than its source."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        from .kernels import _build
        try:
            L = _build.load("storage")
        except OSError as e:
            raise MXNetError("the native host storage does not load: %s" % e)
        L.sto_alloc.restype = ctypes.c_void_p
        L.sto_alloc.argtypes = [ctypes.c_size_t]
        L.sto_free.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        L.sto_direct_free.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        L.sto_stats.argtypes = [ctypes.POINTER(ctypes.c_size_t)] * 3
        L.sto_release_all.argtypes = []
        _LIB = L
        return _LIB


class Handle:
    """One allocation (parity: ``Storage::Handle``: pointer and size)."""

    __slots__ = ("ptr", "size", "_freed")

    def __init__(self, ptr, size):
        self.ptr = ptr
        self.size = size
        self._freed = False

    def array(self, shape, dtype=np.float32):
        """A numpy view of the buffer (fill it in place, then ship it)."""
        if self._freed:
            raise MXNetError("use-after-free of a storage handle")
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if n > self.size:
            raise MXNetError("view of %d bytes exceeds allocation of %d"
                             % (n, self.size))
        buf = (ctypes.c_uint8 * n).from_address(self.ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _cuda_index(device):
    """The CUDA device index of ``device`` (a Context, a torch device or
    an int; None: the current one); None when it is not a CUDA device."""
    if device is None:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else None
    if isinstance(device, int):
        return device
    if hasattr(device, "torch_device"):
        device = device.torch_device()
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None \
        else torch.cuda.current_device()


class Storage:
    """The process-wide facade (parity: ``Storage::Get()``)."""

    _instance = None

    @staticmethod
    def get():
        with _lock:
            if Storage._instance is None:
                Storage._instance = Storage()
        return Storage._instance

    def alloc(self, nbytes):
        """(parity: ``Storage::Alloc``) a pooled host buffer of at least
        ``nbytes`` (a power-of-two bucket of at least 4 KB)."""
        ptr = _native().sto_alloc(nbytes)
        if not ptr:
            raise MXNetError("host storage allocation of %d bytes failed"
                             % nbytes)
        return Handle(ptr, nbytes)

    def free(self, handle):
        """(parity: ``Storage::Free``) return the buffer to the pool."""
        if handle._freed:
            return
        handle._freed = True
        _native().sto_free(handle.ptr, handle.size)

    def direct_free(self, handle):
        """(parity: ``Storage::DirectFree``) give the buffer back to the
        OS, bypassing the pool."""
        if handle._freed:
            return
        handle._freed = True
        _native().sto_direct_free(handle.ptr, handle.size)

    def release_all(self):
        """Give every parked buffer back to the OS."""
        _native().sto_release_all()

    def stats(self):
        """The host pool's counters in bytes: ``allocated`` (handed out),
        ``pooled`` (parked) and ``peak`` (most ever handed out)."""
        a, p, k = (ctypes.c_size_t(), ctypes.c_size_t(), ctypes.c_size_t())
        _native().sto_stats(ctypes.byref(a), ctypes.byref(p),
                            ctypes.byref(k))
        return {"allocated": a.value, "pooled": p.value, "peak": k.value}

    @staticmethod
    def device_stats(device=None):
        """The caching allocator's counters of one card
        (``torch.cuda.memory_stats``, where the JAX package reads PJRT's),
        with PJRT's key names beside them: ``bytes_in_use``
        (allocated.all.current), ``peak_bytes_in_use``, ``bytes_reserved``
        and ``bytes_limit`` (the card's total memory). ``{}`` for a host
        device or where there is no card."""
        idx = _cuda_index(device)
        if idx is None or not torch.cuda.is_available():
            return {}
        stats = dict(torch.cuda.memory_stats(idx))
        stats.update({
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                idx).total_memory})
        return stats

    @staticmethod
    def ledger_report():
        """The live device-buffer ledger (telemetry's per-context alive
        and peak counters: the framework's view of device memory) held
        against the allocator's own counters of every card:
        ``delta_bytes`` is allocator-held minus ledger-tracked bytes,
        memory the framework does not account for (activations and
        workspaces inside a call, tensors made outside NDArrays) — the
        first thing to read when an allocation fails."""
        from . import telemetry
        led = telemetry.ledger()
        report = {"contexts": led, "devices": {},
                  "top_buffers": telemetry.ledger_top(8)}
        ledger_alive = sum(st["alive_bytes"] for st in led.values())
        in_use = 0
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        for i in range(n):
            stats = Storage.device_stats(i)
            report["devices"]["gpu(%d)" % i] = stats
            in_use += int(stats["bytes_in_use"])
        if n:
            report["reconciliation"] = {
                "allocator_bytes_in_use": in_use,
                "ledger_alive_bytes": ledger_alive,
                "delta_bytes": in_use - ledger_alive,
            }
        return report
