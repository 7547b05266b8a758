"""The ``mx.nd`` namespace: NDArray + generated operator functions.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: one function per
registered op, the module-level arithmetic helpers (``add``,
``maximum``, ``equal``, ... that also take scalars) and the fluent
methods (``x.relu()`` is ``nd.relu(x)``).
"""
import numpy as _np

from .. import ops as _ops  # noqa: F401  (registers the operators)
from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      concatenate, moveaxis, waitall, onehot_encode)
from .utils import save, load
from . import register as _register

_register.populate(globals())
from . import random  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
from . import sparse  # noqa: E402,F401
from .sparse import RowSparseNDArray, CSRNDArray  # noqa: E402,F401
# the reference exposes cast_storage as an op of mx.nd
from .sparse import cast_storage  # noqa: E402,F401


def _binary(name, arr_fn, np_fn):
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray):
            return arr_fn(lhs, rhs)
        if isinstance(rhs, NDArray):
            return arr_fn(full(rhs.shape, lhs, ctx=rhs.context,
                               dtype=rhs._data.dtype), rhs)
        return np_fn(lhs, rhs)
    fn.__name__ = name
    fn.__doc__ = "(parity: mx.nd.%s)" % name
    return fn


def _max_min(bcast, scalar):
    def fn(a, b):
        if isinstance(b, NDArray):
            return globals()[bcast](a, b)
        return globals()[scalar](a, scalar=b)
    return fn


add = _binary("add", lambda a, b: a + b, _np.add)
subtract = _binary("subtract", lambda a, b: a - b, _np.subtract)
multiply = _binary("multiply", lambda a, b: a * b, _np.multiply)
divide = _binary("divide", lambda a, b: a / b, _np.divide)
true_divide = divide
modulo = _binary("modulo", lambda a, b: a % b, _np.mod)
power = _binary("power", lambda a, b: a ** b, _np.power)
maximum = _binary("maximum", _max_min("broadcast_maximum", "_maximum_scalar"),
                  _np.maximum)
minimum = _binary("minimum", _max_min("broadcast_minimum", "_minimum_scalar"),
                  _np.minimum)
equal = _binary("equal", lambda a, b: a == b, lambda a, b: float(a == b))
not_equal = _binary("not_equal", lambda a, b: a != b,
                    lambda a, b: float(a != b))
greater = _binary("greater", lambda a, b: a > b, lambda a, b: float(a > b))
greater_equal = _binary("greater_equal", lambda a, b: a >= b,
                        lambda a, b: float(a >= b))
lesser = _binary("lesser", lambda a, b: a < b, lambda a, b: float(a < b))
lesser_equal = _binary("lesser_equal", lambda a, b: a <= b,
                       lambda a, b: float(a <= b))

# fluent methods: x.relu() == nd.relu(x)
_FLUENT_METHODS = [
    "reshape_like", "zeros_like", "ones_like", "broadcast_axes", "repeat",
    "pad", "split", "slice", "take", "one_hot", "pick", "sort", "topk",
    "argsort", "argmax_channel", "flip", "nansum", "nanprod", "rint",
    "fix", "floor", "ceil", "trunc", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "degrees", "radians", "sinh", "cosh", "tanh",
    "arcsinh", "arccosh", "arctanh", "expm1", "log10", "log2", "log1p",
    "rsqrt", "cbrt", "rcbrt", "reciprocal", "relu", "sigmoid", "softmax",
    "log_softmax", "swapaxes", "argmax", "argmin", "clip", "abs", "sign",
    "expand_dims", "broadcast_to", "tile", "prod", "max", "min", "norm",
    "round", "exp", "log", "sqrt", "square", "flatten",
]


def _attach_fluent(cls, ns, names):
    def make(op_name, fn):
        def method(self, *args, **kwargs):
            return fn(self, *args, **kwargs)
        method.__name__ = op_name
        method.__doc__ = "Fluent form of %s(self, ...)" % op_name
        return method
    for op_name in names:
        if op_name in ns and not hasattr(cls, op_name):
            setattr(cls, op_name, make(op_name, ns[op_name]))


_attach_fluent(NDArray, globals(), _FLUENT_METHODS)
