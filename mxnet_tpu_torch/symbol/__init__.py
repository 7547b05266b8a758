"""The ``mx.sym`` namespace: Symbol, Variable and one function per op.

Counterpart of ``mxnet_tpu/symbol/__init__.py``, with its creation and
arithmetic helpers and the fluent methods (``s.relu()`` is
``sym.relu(s)``).
"""
from .. import ops as _ops  # noqa: F401  (registers the operators)
from .symbol import Symbol, Variable, var, Group, load, load_json
from . import register as _register

_register.populate(globals())
from . import sparse  # noqa: E402,F401


def zeros(shape, dtype="float32", **kwargs):
    return globals()["_zeros"](shape=shape, dtype=dtype, **kwargs)


def ones(shape, dtype="float32", **kwargs):
    return globals()["_ones"](shape=shape, dtype=dtype, **kwargs)


def full(shape, val, dtype=None, **kwargs):
    return globals()["_full"](shape=shape, value=float(val),
                              dtype=dtype or "float32", **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", **kwargs):
    return globals()["_arange"](start=start, stop=stop, step=step,
                                repeat=repeat, dtype=dtype, **kwargs)


def _sym_binary(bcast, scalar, py_fn):
    def fn(left, right):
        if isinstance(left, Symbol) and isinstance(right, Symbol):
            return globals()[bcast](left, right)
        if isinstance(left, Symbol):
            return globals()[scalar](left, scalar=right)
        if isinstance(right, Symbol):
            return globals()[scalar](right, scalar=left)
        return py_fn(left, right)
    return fn


maximum = _sym_binary("broadcast_maximum", "_maximum_scalar", max)
minimum = _sym_binary("broadcast_minimum", "_minimum_scalar", min)
hypot = _sym_binary("broadcast_hypot", "_hypot_scalar",
                    lambda a, b: (a * a + b * b) ** 0.5)


def pow(base, exp):
    """(parity: mx.sym.pow)"""
    if isinstance(base, Symbol):
        return base ** exp
    if isinstance(exp, Symbol):
        return globals()["_rpower_scalar"](exp, scalar=base)
    return base ** exp


from ..ndarray import _FLUENT_METHODS as _FLUENT, _attach_fluent  # noqa: E402
_attach_fluent(Symbol, globals(), _FLUENT)
