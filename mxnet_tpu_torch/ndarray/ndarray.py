"""NDArray — the imperative tensor.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``: an NDArray wraps one
``torch.Tensor`` on its context's device. PyTorch's CUDA ops are already
asynchronous and stream-ordered, so ``asnumpy`` is the sync point, as in
the reference. In-place writes (``a[:] = x``) copy into the wrapped
storage.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context, context_of
from ..ops.common import torch_dtype, numpy_dtype

__all__ = ["NDArray", "array", "zeros", "ones"]


class NDArray:
    """Multi-dimensional array on a device."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %s"
                             % type(data).__name__)
        self._data = data
        self._ctx = ctx if ctx is not None else context_of(data)

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype where numpy has one; ``torch.bfloat16`` otherwise."""
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return self._ctx

    def asnumpy(self):
        """Copy to a numpy array; synchronises. bfloat16 widens exactly to
        float32 (numpy has no bfloat16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    # -- conversion / movement --------------------------------------------
    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def as_in_context(self, ctx):
        """This array on ``ctx`` (itself when already there, else a copy)."""
        if ctx == self._ctx:
            return self
        return NDArray(self._data.to(ctx.torch_device(), copy=True), ctx)

    # -- arithmetic used by model code -------------------------------------
    def __add__(self, other):
        if isinstance(other, NDArray):
            from . import elemwise_add
            return elemwise_add(self, other)
        return NDArray(self._data + other, self._ctx)

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        """Basic indexing returns a view sharing storage (reference
        NDArray slices alias their parent)."""
        return NDArray(self._data[key], self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, np.ndarray):
            value = np.ascontiguousarray(value)
            if not value.flags.writeable:   # torch takes writable arrays
                value = value.copy()
            value = torch.from_numpy(value)
        with torch.no_grad():
            if isinstance(value, torch.Tensor):
                self._data[key] = value.to(self._data.device,
                                           self._data.dtype)
            else:
                self._data[key] = value

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)


def _device(ctx):
    ctx = ctx or current_context()
    return ctx, ctx.torch_device()


def array(source_array, ctx=None, dtype=None):
    """Create an NDArray (always a copy) from any array-like. Python
    lists and float64 sources default to float32 (MXNet convention)."""
    if isinstance(source_array, NDArray):
        src = source_array._data
    elif isinstance(source_array, torch.Tensor):
        src = source_array
    else:
        a = np.asarray(source_array)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # torch takes writable arrays
            a = a.copy()
        src = torch.from_numpy(a)
    dt = torch_dtype(dtype)
    if dt is None:
        dt = torch.float32 if src.dtype == torch.float64 else src.dtype
    ctx, dev = _device(ctx)
    return NDArray(src.detach().to(dev, dt, copy=True), ctx)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    if isinstance(shape, numbers.Number):
        shape = (int(shape),)
    ctx, dev = _device(ctx)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype)
                               or torch.float32, device=dev), ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    if isinstance(shape, numbers.Number):
        shape = (int(shape),)
    ctx, dev = _device(ctx)
    return NDArray(torch.ones(tuple(shape), dtype=torch_dtype(dtype)
                              or torch.float32, device=dev), ctx)
