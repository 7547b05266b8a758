"""Code-generation of the ``nd.*`` operator namespace from the registry.

Counterpart of ``mxnet_tpu/ndarray/register.py``: tensor arguments go
positionally or by their reference names (``data=``, ``weight=`` …);
trailing positional values map onto the op's params in declaration
order. Each call goes through ``imperative.invoke`` (train mode, aux
updates, the tape) and returns the op's visible outputs, or writes them
into ``out=``.
"""
from __future__ import annotations

from ..imperative import invoke
from ..ops import registry as _registry


def make_op_func(op):
    arg_names = op.arg_names
    param_order = list(op.defaults)

    def generic_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        from .ndarray import NDArray
        inputs = []
        i = 0
        while i < len(args) and isinstance(args[i], NDArray):
            inputs.append(args[i])
            i += 1
        for j, val in enumerate(args[i:]):
            if j < len(param_order):
                kwargs.setdefault(param_order[j], val)
        if op.nin == -1:
            kwargs.pop("num_args", None)
        elif len(inputs) < len(arg_names):
            for name in arg_names[len(inputs):]:
                if name in kwargs and isinstance(kwargs[name], NDArray):
                    inputs.append(kwargs.pop(name))
                else:
                    break
        return invoke(op, inputs, kwargs, out=out)

    generic_op.__name__ = op.name
    generic_op.__doc__ = op.doc
    return generic_op


def populate(namespace):
    """Install one function per registered op into ``namespace``."""
    for name in _registry.list_ops():
        namespace[name] = make_op_func(_registry.get_op(name))
    return namespace
