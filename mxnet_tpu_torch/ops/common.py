"""Shared helpers for operator implementations.

Counterpart of ``mxnet_tpu/ops/common.py``: the reference's kwargs
conventions (tuples serialized as strings in symbol JSON — both Python
tuples and their string forms are accepted), dtype names, and the
thread-local execution state (train mode, recording, the aux-update
collector, the random-number provider).
"""
from __future__ import annotations

import ast
import threading

import numpy as np
import torch

from ..base import MXNetError

_DTYPE_MAP = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype):
    """Normalise a dtype spec (name, numpy dtype or torch dtype) to a
    ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPE_MAP:
        raise MXNetError("unknown dtype %r" % (dtype,))
    return _DTYPE_MAP[name]


def numpy_dtype(dtype):
    """The numpy dtype a host copy of ``dtype`` data takes: bfloat16 has
    no numpy type and widens (exactly) to float32."""
    dtype = torch_dtype(dtype)
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def channels_last(layout, ndim):
    """True for NWC/NHWC/NDHWC-style layouts; layout=None means the
    reference default (channels-first)."""
    if not layout:
        return False
    layout = str(layout).upper()
    if layout not in ("NCW", "NWC", "NCHW", "NHWC", "NCDHW", "NDHWC"):
        raise MXNetError("unsupported layout %r" % layout)
    if len(layout) != ndim + 2:
        raise MXNetError("layout %r does not match %dD kernel"
                         % (layout, ndim))
    return layout.endswith("C")


def as_tuple(v, ndim=None, name="param"):
    """Parse kernel/stride/pad style params: tuple, int, or '(2, 2)' string."""
    if v is None:
        return None
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if v == () or v == []:
        return None
    if isinstance(v, int):
        v = (v,) * (ndim or 1)
    v = tuple(int(x) for x in v)
    if ndim is not None and len(v) == 1 < ndim:
        v = v * ndim
    if ndim is not None and len(v) != ndim:
        raise MXNetError("%s must have %d elements, got %r" % (name, ndim, v))
    return v


def as_axis(axis):
    """Normalise reduce-style axis params: None, int, tuple, or string forms."""
    if axis is None or axis == "()" or axis == ():
        return None
    if isinstance(axis, str):
        axis = ast.literal_eval(axis)
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def reduce_axes(axis, ndim, exclude=False):
    """MXNet reduce semantics (axis + exclude) as a concrete axis tuple."""
    axis = as_axis(axis)
    if axis is None:
        return () if exclude else tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    axes = tuple(sorted(a % ndim for a in axis))
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


# ---------------------------------------------------------------------------
# Execution state: train mode, recording, aux-update collection
# ---------------------------------------------------------------------------

class _ExecState(threading.local):
    """Per-thread execution state (counterpart of the JAX package's
    ``ops/common.py`` ``_ExecState``)."""

    def __init__(self):
        self.train_mode = False
        self.recording = False
        # callable (torch.device) -> torch.Generator installed by
        # rng_scope; None: the global per-device generator (random.py)
        self.rng_provider = None
        # list of (NDArray, new value): stateful aux updates (BatchNorm
        # moving stats) collected instead of written while a pure
        # function is extracted (gluon.block.make_pure_fn)
        self.aux_collector = None


_STATE = _ExecState()


def state():
    return _STATE


def is_train():
    return _STATE.train_mode


def take_rng(device):
    """The ``torch.Generator`` a random op on ``device`` draws from: the
    one an ``rng_scope`` installed, else the global generator of that
    device (``mxnet_tpu_torch.random``). A ``meta`` tensor draws
    nothing: None."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    if _STATE.rng_provider is not None:
        return _STATE.rng_provider(device)
    from .. import random as _random
    return _random.generator(device)


class rng_scope:
    """Route every random op to ``gen`` (a ``torch.Generator``) while
    active (parity: the JAX package's ``rng_scope``, which installs a
    traced key); ``gen=None`` leaves the global generators in place."""

    def __init__(self, gen):
        self._gen = gen
        self._old = None

    def __enter__(self):
        self._old = _STATE.rng_provider
        if self._gen is not None:
            gen = self._gen
            _STATE.rng_provider = lambda device: gen
        return self

    def __exit__(self, *exc):
        _STATE.rng_provider = self._old
