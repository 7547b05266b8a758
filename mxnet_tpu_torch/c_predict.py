"""Python side of the C predict API (``kernels/csrc/c_predict_api.cc``).

Counterpart of ``mxnet_tpu/c_predict.py`` (parity: reference
``include/mxnet/c_predict_api.h`` / ``src/c_api/c_predict_api.cc``, the
standalone inference ABI of the amalgamation builds). The port's C
library embeds CPython and calls these primitive-typed helpers (strings,
ints, raw host addresses); the forward is the port's own
:class:`~mxnet_tpu_torch.predictor.Predictor`, so a C program runs the
same PyTorch operators and hand-written kernels as a Python caller.

``dev_type`` follows the reference: 1 is the host (``mx.cpu(dev_id)``),
2 the CUDA card (``mx.gpu(dev_id)``); any other value raises.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .base import MXNetError
from .context import Context, cpu
from .predictor import Predictor

__all__ = ["create", "set_input", "forward", "reshape", "output_ndim",
           "output_shape", "output_size", "copy_output", "num_outputs",
           "ndlist_create", "ndlist_len", "ndlist_entry", "device"]


def device(dev_type, dev_id):
    """The Context of a reference ``dev_type``: 1 the host, 2 the card."""
    if dev_type == 1:
        return Context("cpu", int(dev_id))
    if dev_type == 2:
        return Context("gpu", int(dev_id))
    raise MXNetError("dev_type %r: the C predict API takes 1 (cpu) or 2 "
                     "(gpu)" % (dev_type,))


def create(symbol_json, param_bytes, dev_type, dev_id, names, shapes,
           output_keys=None):
    """(parity: MXPredCreate / MXPredCreatePartialOut) names/shapes
    describe the input nodes; ``output_keys`` (if given) selects internal
    nodes as the outputs, reference-style ``name`` or ``name_output``."""
    ctx = device(dev_type, dev_id)
    input_shapes = {n: tuple(int(d) for d in s)
                    for n, s in zip(names, shapes)}
    symbol = symbol_json
    if output_keys:
        from . import symbol as _sym
        if not isinstance(symbol, _sym.Symbol):
            symbol = _sym.load_json(symbol)
        internals = symbol.get_internals()
        avail = set(internals.list_outputs())
        picked = []
        for key in output_keys:
            name = key if key in avail else key + "_output"
            if name not in avail:
                raise MXNetError("unknown output node %r" % key)
            picked.append(internals[name])
        symbol = picked[0] if len(picked) == 1 else _sym.Group(picked)
    return Predictor(symbol, bytes(param_bytes), input_shapes, ctx=ctx)


def set_input(pred, name, addr, size):
    """(parity: MXPredSetInput) size = number of float32 elements."""
    if name not in pred._input_shapes:
        raise MXNetError("unknown input %r" % name)
    shape = pred._input_shapes[name]
    if int(size) != int(np.prod(shape)):
        raise MXNetError("input %r: %d floats given, the bound shape %s "
                         "holds %d" % (name, size, shape, np.prod(shape)))
    buf = (ctypes.c_float * size).from_address(addr)
    arr = np.frombuffer(buf, np.float32).copy()
    pred.set_input(name, arr.reshape(shape))


def forward(pred):
    pred.forward()


def reshape(pred, names, shapes):
    """(parity: MXPredReshape) — a new predictor for new input shapes,
    sharing the donor's device-resident parameters."""
    return pred.reshape({n: tuple(int(d) for d in s)
                         for n, s in zip(names, shapes)})


def num_outputs(pred):
    return len(pred._executor.outputs)


def output_ndim(pred, index):
    return len(pred.get_output(index).shape)


def output_shape(pred, index):
    return [int(d) for d in pred.get_output(index).shape]


def output_size(pred, index):
    return int(np.prod(pred.get_output(index).shape))


def copy_output(pred, index, addr, size):
    """(parity: MXPredGetOutput) copy float32 output into caller memory."""
    out = pred.get_output(index).asnumpy().astype(np.float32, copy=False)
    flat = np.ascontiguousarray(out).ravel()
    if size < flat.size:
        raise MXNetError("output buffer too small: %d < %d"
                         % (size, flat.size))
    ctypes.memmove(addr, flat.ctypes.data, flat.size * 4)


# -- NDArray-list blob access (parity: MXNDListCreate/Get/Free) -------------
# The C handle owns the Python list returned by ndlist_create; every
# pointer handed to C (name bytes, float32 data, uint32 shape) is backed
# by a host object stored IN that list, so it stays valid until
# MXNDListFree drops the handle.

def ndlist_create(param_bytes):
    """Parse an ``nd.save`` blob on the host into
    [(name_bytes, f32_data, u32_shape)]: ``MXNDListGet`` hands out host
    pointers, so nothing goes to the card."""
    from .ndarray import utils as _nd_utils
    loaded = _nd_utils.load_frombuffer(bytes(param_bytes), ctx=cpu())
    if isinstance(loaded, dict):
        items = list(loaded.items())
    else:
        items = [("", v) for v in loaded]
    out = []
    for name, arr in items:
        data = np.ascontiguousarray(arr.asnumpy().astype(np.float32,
                                                         copy=False))
        shape = np.asarray(data.shape, np.uint32)
        out.append((name.encode("utf-8"), data.ravel(), shape))
    return out


def ndlist_len(lst):
    return len(lst)


def ndlist_entry(lst, index):
    """-> (name_bytes, data_addr, shape_addr, ndim) for the C side."""
    name, data, shape = lst[index]
    return (name, int(data.ctypes.data), int(shape.ctypes.data),
            int(shape.size))
