"""Reduction, ordering and broadcasting operators.

Counterpart of ``mxnet_tpu/ops/reduce.py`` (parity: the reference's
``broadcast_reduce_op_value.cc``, ``broadcast_reduce_op_index.cc`` and
``ordering_op.cc``). MXNet reduce semantics: ``axis`` may be an int, a
tuple or None, with ``keepdims`` and ``exclude`` (reduce over the
complement). Index outputs are float32, as the reference returns them;
ties take the first index, and orderings are stable.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .common import as_axis, as_tuple, reduce_axes, torch_dtype
from .registry import register

_REDUCE_DEFAULTS = {"axis": None, "keepdims": False, "exclude": False}


def _prod(data, axis, keepdim):
    out = data
    for a in sorted(axis, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdim)
    return out


def _nanprod(data, axis, keepdim):
    return _prod(torch.where(torch.isnan(data), torch.ones_like(data), data),
                 axis, keepdim)


def _mean(data, axis, keepdim):
    if not data.is_floating_point():
        data = data.float()
    return torch.mean(data, dim=axis, keepdim=keepdim)


def _keep_int(fn):
    """An integer input keeps its dtype (``jnp.sum`` of int32 is int32;
    torch widens to int64)."""
    def op(data, axis, keepdim):
        out = fn(data, dim=axis, keepdim=keepdim)
        return out if data.is_floating_point() else out.to(data.dtype)
    return op


def _reduce(fn):
    def op(data, axis=None, keepdims=False, exclude=False):
        axes = reduce_axes(axis, data.ndim, exclude)
        if axes == ():
            return data
        return fn(data, axes, bool(keepdims))
    return op


register("sum", defaults=_REDUCE_DEFAULTS, aliases=("sum_axis",))(
    _reduce(_keep_int(torch.sum)))
register("mean", defaults=_REDUCE_DEFAULTS)(_reduce(_mean))
register("prod", defaults=_REDUCE_DEFAULTS)(_reduce(_prod))
register("nansum", defaults=_REDUCE_DEFAULTS)(_reduce(_keep_int(torch.nansum)))
register("nanprod", defaults=_REDUCE_DEFAULTS)(_reduce(_nanprod))
register("max", defaults=_REDUCE_DEFAULTS, aliases=("max_axis",))(
    _reduce(lambda d, a, k: torch.amax(d, dim=a, keepdim=k)))
register("min", defaults=_REDUCE_DEFAULTS, aliases=("min_axis",))(
    _reduce(lambda d, a, k: torch.amin(d, dim=a, keepdim=k)))


@register("_square_sum", defaults=_REDUCE_DEFAULTS)
def _square_sum(data, axis=None, keepdims=False, exclude=False):
    """Sum of squares: row_sparse input only in the reference, which has
    no dense kernel. A row_sparse input is taken by the storage dispatch
    (``ndarray/sparse.py`` ``square_sum``) before this body runs; a
    dense input is refused as there."""
    raise MXNetError("_square_sum: only row_sparse input is supported "
                     "(reference square_sum-inl.h has no dense kernel)")


@register("norm")
def norm(data):
    """L2 norm over all elements, shape (1,) (reference 0.12)."""
    return torch.sqrt(torch.sum(torch.square(data))).reshape((1,))


def _arg(fn):
    def op(data, axis=None, keepdims=False):
        axis = as_axis(axis)
        if axis is None:
            out = fn(data.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * data.ndim)
        else:
            out = fn(data, dim=axis, keepdim=bool(keepdims))
        return out.to(torch.float32)
    return op


register("argmax", defaults={"axis": None, "keepdims": False},
         no_grad=True)(_arg(torch.argmax))
register("argmin", defaults={"axis": None, "keepdims": False},
         no_grad=True)(_arg(torch.argmin))


@register("argmax_channel", no_grad=True)
def argmax_channel(data):
    """argmax over axis 1 (parity: broadcast_reduce_op_index.cc)."""
    return torch.argmax(data, dim=1).to(torch.float32)


@register("pick", nin=2, arg_names=["data", "index"],
          defaults={"axis": -1, "keepdims": False})
def pick(data, index, axis=-1, keepdims=False):
    """Pick elements along ``axis`` by index (negative indices wrap)."""
    axis = int(axis) % data.ndim
    idx = index.long()
    if idx.ndim == data.ndim:
        idx = idx.squeeze(axis)
    n = data.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


@register("broadcast_to", defaults={"shape": ()})
def broadcast_to(data, shape=()):
    shape = as_tuple(shape) or ()
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(tgt).clone()


@register("broadcast_axis", defaults={"axis": (), "size": ()},
          aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axes = as_tuple(axis) or ()
    sizes = as_tuple(size) or ()
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a % data.ndim] = s
    return data.expand(tuple(tgt)).clone()


# ---------------------------------------------------------------------------
# Ordering ops (parity: ordering_op.cc)
# ---------------------------------------------------------------------------

def _flat_axis(data, axis):
    axis = as_axis(axis)
    if axis is None:
        return data.reshape(-1), 0
    return data, int(axis)


@register("sort", defaults={"axis": -1, "is_ascend": True}, no_grad=True)
def sort(data, axis=-1, is_ascend=True):
    data, axis = _flat_axis(data, axis)
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", defaults={"axis": -1, "is_ascend": True,
                               "dtype": "float32"}, no_grad=True)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    data, axis = _flat_axis(data, axis)
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register("topk", defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                            "is_ascend": False, "dtype": "float32"},
          no_grad=True)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """Top-k along ``axis``; ret_typ "value" | "indices" | "mask" |
    "both" (parity: ordering_op.cc TopK)."""
    axis = data.ndim - 1 if axis is None else int(axis) % data.ndim
    k = int(k) if int(k) > 0 else data.shape[axis]
    key = data if is_ascend else -data
    idx = torch.argsort(key, dim=axis, stable=True).narrow(axis, 0, k)
    dt = torch_dtype(dtype)
    if ret_typ == "indices":
        return idx.to(dt)
    vals = torch.gather(data, axis, idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(dt)
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, idx, 1)
    raise MXNetError("topk: unknown ret_typ %r" % ret_typ)
