"""NDArray serialization: save, load and load_frombuffer.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` with the SAME file format:
an NPZ container of name -> array (a list saves under
``__mx_list__:<i>`` keys), so the port reads the JAX package's
``-0000.params`` files and the JAX package reads the port's. NPZ has no
bfloat16: a bfloat16 array is saved widened to float32 (exactly, as
``asnumpy`` widens it) and loads back as float32.
"""
from __future__ import annotations

import io as _io

import numpy as np

from ..base import MXNetError
from ..filesystem import open_uri
from .ndarray import NDArray, array

_LIST_PREFIX = "__mx_list__:"


def save(fname, data):
    """Save an NDArray, a list or a dict of NDArrays (bfloat16 widened to
    float32)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = data.items()
    elif isinstance(data, (list, tuple)):
        items = ((_LIST_PREFIX + str(i), v) for i, v in enumerate(data))
    else:
        raise MXNetError("save: data must be NDArray, list, or dict")
    arrays = {}
    for k, v in items:
        if not isinstance(v, NDArray):
            raise MXNetError("save: values must be NDArrays")
        arrays[k] = v.asnumpy()
    with open_uri(fname, "wb") as f:
        np.savez(f, **arrays)


def load(fname, ctx=None):
    """Load NDArrays saved by :func:`save` (or by the JAX package) onto
    ``ctx`` (default: the current context)."""
    try:
        f = open_uri(fname, "rb")
    except FileNotFoundError:
        raise MXNetError("load: no such file %r" % fname)
    with f:
        # a registered scheme's stream may not seek: buffer it
        src = f if f.seekable() else _io.BytesIO(f.read())
        return _load_npz(src, ctx)


def load_frombuffer(buf, ctx=None):
    """Load NDArrays from the bytes of a :func:`save` file (parity:
    mx.nd.load_frombuffer, the C ``MXNDArrayLoadFromBuffer``) onto
    ``ctx`` (default: the current context). Either package's files load
    in the other; a bfloat16 array comes back as float32."""
    return _load_npz(_io.BytesIO(bytes(buf)), ctx)


def _load_npz(src, ctx):
    with np.load(src, allow_pickle=False) as npz:
        keys = list(npz.keys())
        if keys and all(k.startswith(_LIST_PREFIX) for k in keys):
            keys.sort(key=lambda k: int(k[len(_LIST_PREFIX):]))
            return [array(npz[k], ctx=ctx) for k in keys]
        return {k: array(npz[k], ctx=ctx) for k in keys}
