"""User-defined operators in Python.

Counterpart of ``mxnet_tpu/operator.py`` (reference
``python/mxnet/operator.py``: ``CustomOp``, ``CustomOpProp``,
``register``, and the legacy ``PythonOp``/``NumpyOp``/``NDArrayOp``).
The ``Custom`` op runs the user's ``forward`` and ``backward`` inside a
``torch.autograd.Function``: the inputs (and, for the backward, the head
gradients and outputs) are copied to host NDArrays, the user's code
writes its results through ``assign`` with the ``req`` it is given, and
the results are copied back to the inputs' device on PyTorch's current
stream. So a Custom op runs eagerly, under ``autograd.record``, inside
symbol graphs and in ``Module``, on the card or on the CPU. On ``meta``
tensors (shape inference) only the op's ``infer_shape`` runs.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .ops.registry import register as _register_op, get_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "PythonOp", "NumpyOp", "NDArrayOp"]

_custom_props = {}


class CustomOp:
    """Base class of a custom op's implementation (parity:
    operator.CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says: nothing for
        ``null``, overwrite for ``write``/``inplace``, add for ``add``."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """A custom op's metadata and factory (parity: operator.CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, (in_shape[0],) * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a ``CustomOpProp`` subclass under ``reg_name``, the
    ``op_type`` of ``nd.Custom``/``sym.Custom``."""

    def do_register(prop_cls):
        _custom_props[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered():
    return dict(_custom_props)


def _host(tensors):
    from .ndarray.ndarray import NDArray
    from .context import cpu
    return [NDArray(t.detach().to("cpu", copy=True), cpu()) for t in tensors]


def _host_zeros(shapes, dtype):
    from .ndarray.ndarray import NDArray
    from .context import cpu
    return [NDArray(torch.zeros(tuple(s), dtype=dtype), cpu())
            for s in shapes]


class _CustomFn(torch.autograd.Function):
    """The user's forward and backward on host copies."""

    @staticmethod
    def forward(ctx, prop, is_train, oshapes, *inputs):
        dev, dtype = inputs[0].device, inputs[0].dtype
        in_shapes = [tuple(x.shape) for x in inputs]
        op = prop.create_operator(None, in_shapes, [x.dtype for x in inputs])
        ins = _host(inputs)
        outs = _host_zeros(oshapes, dtype)
        op.forward(is_train=is_train, req=["write"] * len(outs),
                   in_data=ins, out_data=outs, aux=[])
        results = tuple(o._data.to(dev, dtype) for o in outs)
        ctx.prop, ctx.in_shapes = prop, in_shapes
        ctx.save_for_backward(*inputs, *results)
        ctx.n_in = len(inputs)
        return results

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        inputs, outputs = saved[:ctx.n_in], saved[ctx.n_in:]
        dev, dtype = inputs[0].device, inputs[0].dtype
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outputs)]
        op = ctx.prop.create_operator(None, ctx.in_shapes,
                                      [x.dtype for x in inputs])
        igs = _host_zeros(ctx.in_shapes, dtype)
        op.backward(req=["write"] * len(inputs), out_grad=_host(grads),
                    in_data=_host(inputs), out_data=_host(outputs),
                    in_grad=igs, aux=[])
        return (None, None, None) + tuple(g._data.to(dev, dtype)
                                          for g in igs)


def _make_prop(op_type, params):
    if op_type not in _custom_props:
        raise MXNetError("custom op %r is not registered" % (op_type,))
    return _custom_props[op_type](**{k: str(v) for k, v in params.items()})


def _custom_impl(*inputs, op_type=None, _train=False, **params):
    """The ``Custom`` op: the registered prop's operator, run by
    ``_CustomFn``."""
    prop = _make_prop(op_type, params)
    _, oshapes, _ = prop.infer_shape([list(x.shape) for x in inputs])
    oshapes = [tuple(int(d) for d in s) for s in oshapes]
    if inputs[0].device.type == "meta":
        outs = tuple(torch.empty(s, dtype=inputs[0].dtype, device="meta")
                     for s in oshapes)
    else:
        outs = _CustomFn.apply(prop, bool(_train), oshapes, *inputs)
    return outs if len(outs) > 1 else outs[0]


_register_op("Custom", nin=-1, defaults={"op_type": None})(_custom_impl)
get_op("Custom").visible_outputs = lambda p: len(_make_prop(
    p.get("op_type"), {k: v for k, v in p.items()
                       if k not in ("op_type", "_train")}).list_outputs())

# the nd/sym namespaces were generated before this module registered
# Custom (the JAX package injects it the same way)
from . import ndarray as _nd_mod            # noqa: E402
from .ndarray import register as _nd_reg    # noqa: E402
from . import symbol as _sym_mod            # noqa: E402
from .symbol import register as _sym_reg    # noqa: E402
_nd_mod.Custom = _nd_reg.make_op_func(get_op("Custom"))
_sym_mod.Custom = _sym_reg.make_sym_func(get_op("Custom"))


# ---------------------------------------------------------------------------
# The legacy Python operators, bridged onto CustomOp
# ---------------------------------------------------------------------------

class PythonOp:
    """Base class of the legacy Python operators (parity:
    operator.PythonOp)."""

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise MXNetError("backward is not implemented")

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_


class _LegacyAdapter(CustomOp):
    """A CustomOp running a legacy op's numpy or NDArray callbacks."""

    def __init__(self, legacy, as_numpy):
        self._legacy = legacy
        self._np = as_numpy

    def _unwrap(self, xs):
        # numpy mode hands the legacy op writable copies; results are
        # copied back through dst[:]
        return [np.array(x.asnumpy()) if self._np else x for x in xs]

    def forward(self, is_train, req, in_data, out_data, aux):
        outs = self._unwrap(out_data)
        self._legacy.forward(in_data=self._unwrap(in_data), out_data=outs)
        if self._np:
            for dst, src in zip(out_data, outs):
                dst[:] = src

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        igs = self._unwrap(in_grad)
        self._legacy.backward(out_grad=self._unwrap(out_grad),
                              in_data=self._unwrap(in_data),
                              out_data=self._unwrap(out_data), in_grad=igs)
        if self._np:
            for dst, src in zip(in_grad, igs):
                dst[:] = src


def _legacy_get_symbol(legacy, as_numpy, args, kwargs):
    class _Prop(CustomOpProp):
        def __init__(self, **_):
            super().__init__(need_top_grad=legacy.need_top_grad())

        def infer_shape(self, in_shape):
            shapes = legacy.infer_shape(in_shape)
            return shapes[0], shapes[1], []

        def list_arguments(self):
            return legacy.list_arguments()

        def list_outputs(self):
            return legacy.list_outputs()

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return _LegacyAdapter(legacy, as_numpy)

    reg_name = "_legacy_%s_%x" % (type(legacy).__name__, id(legacy))
    register(reg_name)(_Prop)
    return _sym_mod.Custom(*args, op_type=reg_name, **kwargs)


class NumpyOp(PythonOp):
    """Legacy numpy operator (parity: operator.NumpyOp): forward and
    backward receive numpy arrays."""

    def get_symbol(self, *args, **kwargs):
        return _legacy_get_symbol(self, True, args, kwargs)


class NDArrayOp(PythonOp):
    """Legacy NDArray operator (parity: operator.NDArrayOp): forward and
    backward receive NDArrays."""

    def get_symbol(self, *args, **kwargs):
        return _legacy_get_symbol(self, False, args, kwargs)

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps
