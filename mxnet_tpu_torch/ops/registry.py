"""Operator registry — the single source of truth for the op surface.

Counterpart of ``mxnet_tpu/ops/registry.py``: every op is ONE plain
function on ``torch.Tensor``s. It runs on whatever device its inputs
live on: a CUDA tensor goes through cuDNN/cuBLAS (or a hand-written
kernel, see ``kernels/``), a CPU tensor through PyTorch's CPU operators,
and a ``meta`` tensor only propagates shapes and dtypes — the port's
counterpart of ``jax.eval_shape`` for shape inference. The ``mx.nd.*``
and ``mx.sym.*`` namespaces are generated from this registry.
"""
from __future__ import annotations

import inspect

from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "list_ops", "alias"]

_OPS = {}


class OpDef:
    """One operator.

    name : canonical MXNet op name (e.g. ``"FullyConnected"``).
    fn : plain function ``fn(*tensors, **params) -> tensor | tuple``.
    nin : number of tensor inputs; -1 = variadic.
    nout : number of outputs (static).
    arg_names : names of the tensor inputs, in order.
    no_grad : the op is not differentiable; the tape does not record it.
    mutate : indices of inputs the imperative call writes its outputs
        back into, in order (the optimizer update ops).
    """

    def __init__(self, name, fn, nin=1, nout=1, arg_names=None,
                 defaults=None, no_grad=False, mutate=()):
        self.name = name
        self.fn = fn
        self.nin = nin
        self.nout = nout
        self.arg_names = list(arg_names) if arg_names is not None else (
            ["data"] if nin in (1, -1) else ["lhs", "rhs"] if nin == 2 else
            ["arg%d" % i for i in range(max(nin, 0))])
        self.defaults = dict(defaults or {})
        self.no_grad = no_grad
        self.mutate = tuple(mutate)
        self.doc = fn.__doc__ if fn is not None else None
        # ops that behave differently at train time declare a `_train`
        # kwarg, random ops a `_rng` kwarg (a torch.Generator)
        try:
            sig = inspect.signature(fn).parameters
            self.takes_train = "_train" in sig
            self.takes_rng = "_rng" in sig
        except (TypeError, ValueError):
            self.takes_train = self.takes_rng = False
        # how many outputs user code sees (BatchNorm computes 3, shows 1):
        # a count, or a function of the params (RNN's state_outputs)
        self.visible_outputs = None
        # indices of inputs that are auxiliary states (BN moving stats)
        self.aux_inputs = ()
        # hook(raw_inputs, raw_outputs, params) -> {input_idx: new value}:
        # the in-place aux update of a training-mode call (BN moving stats)
        self.stateful_update = None
        # hook(input_shapes, params) -> {input_idx: shape} for learnable
        # inputs (reference FInferShape; see ops/shape_infer.py)
        self.param_shape_infer = None
        # hook(input_dtypes, params) -> {input_idx: dtype} for learnable
        # inputs that do not follow the data dtype (BN stats stay fp32)
        self.param_dtype_infer = None

    def __repr__(self):
        return "OpDef(%s)" % self.name

    def n_visible(self, params):
        """The visible output count for these params (None: all)."""
        vis = self.visible_outputs
        return vis(params) if callable(vis) else vis

    def accepted_params(self):
        """Names this op accepts as keyword params (from the registry
        defaults and the fn signature); None when the fn takes **kwargs."""
        cached = getattr(self, "_accepted_params", False)
        if cached is not False:
            return cached
        keys = set(self.defaults) | {"num_args", "num_outputs"}
        try:
            for p in inspect.signature(self.fn).parameters.values():
                if p.kind == inspect.Parameter.VAR_KEYWORD:
                    self._accepted_params = None
                    return None
                if p.kind in (inspect.Parameter.KEYWORD_ONLY,
                              inspect.Parameter.POSITIONAL_OR_KEYWORD) \
                        and p.default is not inspect.Parameter.empty:
                    keys.add(p.name)
        except (TypeError, ValueError):
            pass
        keys -= set(self.arg_names)
        keys -= {"_train", "_rng"}
        self._accepted_params = keys
        return keys

    def apply(self, tensors, params):
        """Run the op on raw tensors. Returns a tuple of outputs."""
        out = self.fn(*tensors, **params)
        return out if isinstance(out, tuple) else (out,)


def register(name, nin=1, nout=1, arg_names=None, defaults=None, aliases=(),
             no_grad=False, mutate=()):
    """Decorator registering a plain tensor function as an operator."""

    def _reg(fn):
        op = OpDef(name, fn, nin=nin, nout=nout, arg_names=arg_names,
                   defaults=defaults, no_grad=no_grad, mutate=mutate)
        if name in _OPS:
            raise MXNetError("op %r already registered" % name)
        _OPS[name] = op
        for a in aliases:
            _OPS[a] = op
        return fn

    return _reg


def alias(existing, *names):
    op = get_op(existing)
    for n in names:
        _OPS[n] = op


def get_op(name):
    if name not in _OPS:
        raise MXNetError("operator %r is not registered" % (name,))
    return _OPS[name]


def list_ops():
    return sorted(_OPS)
