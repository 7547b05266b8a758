"""Resource manager: per-device temp-space and random-generator resources.

Counterpart of ``mxnet_tpu/resource.py`` (the reference's
``include/mxnet/resource.h`` and ``src/resource.cc``): a consumer requests
``temp_space`` scratch buffers or a ``random`` generator through
``ResourceManager.get().request(ctx, req)``; ``MXNET_EXEC_NUM_TEMP``
bounds the temp-space slots handed out round-robin per device.

``temp_space`` is host scratch: PyTorch's caching allocator owns device
scratch, so what remains is host-visible staging such as
``image.ImageIter``'s batch buffer, taken from the pooled host storage
(``Storage.get().alloc``/``free``, ``storage.py``) as in the JAX
package. ``random`` hands out the port's
``torch.Generator`` of the resource's device (``random.generator``,
seeded by ``mx.random.seed``), where the JAX package hands out a split
key.
"""
from __future__ import annotations

import threading

import numpy as np

from .base import MXNetError, get_env
from .context import current_context
from . import random as _random
from .storage import Storage

__all__ = ["Resource", "ResourceManager", "request", "Storage"]


class Resource:
    """One granted resource (parity: struct Resource)."""

    _MAX_RETIRED = 4

    def __init__(self, kind, ctx):
        self.kind = kind
        self.ctx = ctx
        self._buf = None
        self._retired = []

    def get_space(self, shape, dtype=np.float32):
        """A scratch numpy array over this slot's pooled buffer, reused
        across requests. A larger request takes a larger buffer; the
        outgrown one is parked (the last ``_MAX_RETIRED`` of them, then
        freed oldest first) so that views handed out just before never
        alias a buffer the pool hands out again."""
        if self.kind != "temp_space":
            raise MXNetError("get_space on a %r resource" % self.kind)
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if self._buf is None or self._buf.size < nbytes:
            if self._buf is not None:
                self._retired.append(self._buf)
                while len(self._retired) > self._MAX_RETIRED:
                    Storage.get().free(self._retired.pop(0))
            self._buf = Storage.get().alloc(max(nbytes, 1))
        return self._buf.array(shape, dtype)

    def get_generator(self):
        """The ``torch.Generator`` of this resource's device (parity:
        ``Resource::get_random``; the JAX package's ``get_key``)."""
        if self.kind != "random":
            raise MXNetError("get_generator on a %r resource" % self.kind)
        return _random.generator(self.ctx.torch_device())

    def release(self):
        for h in self._retired:
            Storage.get().free(h)
        self._retired = []
        if self._buf is not None:
            Storage.get().free(self._buf)
            self._buf = None


class ResourceManager:
    """(parity: ResourceManager::Get()->Request)"""

    _instance = None
    _lock = threading.Lock()

    @staticmethod
    def get():
        with ResourceManager._lock:
            if ResourceManager._instance is None:
                ResourceManager._instance = ResourceManager()
        return ResourceManager._instance

    def __init__(self):
        self._num_temp = int(get_env("MXNET_EXEC_NUM_TEMP", 1))
        self._temp = {}
        self._next = {}

    def request(self, ctx=None, req="temp_space"):
        ctx = ctx or current_context()
        key = (ctx.device_type, ctx.device_id)
        if req == "random":
            return Resource("random", ctx)
        if req != "temp_space":
            raise MXNetError("unknown resource request %r" % req)
        with ResourceManager._lock:
            slots = self._temp.setdefault(key, [])
            if len(slots) < self._num_temp:
                slots.append(Resource("temp_space", ctx))
                return slots[-1]
            i = self._next.get(key, 0)
            self._next[key] = (i + 1) % self._num_temp
            return slots[i]


def request(ctx=None, req="temp_space"):
    """``ResourceManager.get().request(ctx, req)``."""
    return ResourceManager.get().request(ctx, req)
