"""Gluon Parameter / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``: a Parameter holds one
NDArray, may defer its initialisation until a forward pass reveals its
shape, and is named by its block's prefix so exported graphs and saved
parameter files use the same names as the JAX package. Unless its
``grad_req`` is ``'null'`` its array is a leaf of the autograd tape with
a gradient buffer attached at initialisation.
"""
from __future__ import annotations

from collections import OrderedDict

from ..base import MXNetError
from ..context import current_context
from .. import initializer as init
from .. import imperative as _imp
from ..initializer import InitDesc
from ..ndarray.ndarray import zeros as nd_zeros

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    """(parity: gluon.Parameter)"""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self._data = None
        self._grad = None
        self._deferred_init = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("invalid grad_req %r" % req)
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._data is not None:
            if req == "null":
                self._grad = None
                self._data._grad = None
                self._data._grad_req = None
                self._data._alias = None
            else:
                self._init_grad()

    def _shape_complete(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """(parity: Parameter.initialize)"""
        if default_init is None:
            default_init = _default_init()
        if self._data is not None and not force_reinit:
            return
        ctx = ctx or current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if not self._shape_complete():
            if not self.allow_deferred_init:
                raise MXNetError("Cannot initialize %r: shape unknown (%s)"
                                 % (self.name, self.shape))
            self._deferred_init = (init, ctx, default_init)
            return
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, initializer, ctx, default_init):
        arr = nd_zeros(self.shape, ctx=ctx, dtype=self.dtype)
        desc = InitDesc(self.name, {"__init__": ""})
        # a param-specific init applies as a WEIGHT init regardless of the
        # name suffix; only the global default goes through suffix dispatch
        specific = initializer or self.init
        if specific is None:
            default_init(desc, arr)
        else:
            init.create(specific)._init_weight(desc, arr)
        self._data = arr
        if self._grad_req != "null":
            self._init_grad()
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                "Parameter %r has unknown shape" % self.name)
        if not self._shape_complete():
            raise DeferredInitializationError(
                "Parameter %r still has unknown shape %s"
                % (self.name, self.shape))
        self._finish_init(*self._deferred_init)

    def _init_grad(self):
        self._grad = nd_zeros(self._data.shape, ctx=self._data.context,
                              dtype=self._data._data.dtype)
        _imp.mark_variables([self._data], [self._grad], [self._grad_req])

    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %r deferred; run a forward pass first"
                    % self.name)
            raise MXNetError("Parameter %r is not initialized; call "
                             ".initialize()" % self.name)

    def _update_shape(self, shape):
        """Fill a deferred shape from real input (called by layers)."""
        shape = tuple(int(s) for s in shape)
        if self.shape is not None:
            self.shape = tuple(n if o == 0 else o
                               for o, n in zip(self.shape, shape))
        else:
            self.shape = shape
        if self._deferred_init is not None and self._shape_complete():
            self._finish_deferred_init()

    # -- access ------------------------------------------------------------
    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad is None:
            raise MXNetError("Parameter %r has grad_req='null'" % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self.data().context]

    def set_data(self, data):
        """Set the value (an NDArray); before initialisation this fixes the
        shape and placement, afterwards it copies into the existing array
        (dtype and device kept)."""
        if self._data is None:
            self.shape = tuple(data.shape)
            self._data = data.copy()
            self._deferred_init = None
            if self._grad_req != "null":
                self._init_grad()
            return
        if tuple(data.shape) != tuple(self._data.shape):
            raise MXNetError("Parameter %r: shape %s != %s"
                             % (self.name, tuple(data.shape),
                                tuple(self._data.shape)))
        self._data[:] = data

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def reset_ctx(self, ctx):
        """One device per parameter in this port: a no-op, as in the JAX
        package."""

    def cast(self, dtype):
        """Cast the value (and gradient buffer) to ``dtype``."""
        self.dtype = dtype
        if self._data is not None:
            self._data = self._data.astype(dtype)
            if self._grad_req != "null":
                self._init_grad()

    def var(self):
        """This parameter as a symbol Variable."""
        from ..symbol import Variable
        return Variable(self.name, shape=self.shape, lr_mult=self.lr_mult,
                        wd_mult=self.wd_mult, dtype=self.dtype)


def _default_init():
    return init.Uniform(0.07)


class ParameterDict:
    """(parity: gluon.ParameterDict)"""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        s = "\n".join("  " + repr(p) for p in self._params.values())
        return "ParameterDict %s(\n%s\n)" % (self._prefix, s)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def get(self, name, **kwargs):
        """(parity: ParameterDict.get) create-or-retrieve; attributes
        given for an existing parameter are set on it (its shape and
        dtype kept)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None:
            param = self._shared._params.get(name)
            if param is not None:
                self._params[name] = param
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k in ("shape", "dtype") and getattr(param, k) is not None:
                    continue
                if v is not None:
                    setattr(param, k, v)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("duplicate parameter %r" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or _default_init(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set one attribute (``grad_req``, ``lr_mult``...) on every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write the values to ``filename`` (``nd.save``'s NPZ, the JAX
        package's format), names stripped of ``strip_prefix``."""
        from ..ndarray import save as nd_save
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError("prefix %r not in param name %r"
                                 % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load values written by ``save`` of either package."""
        from ..ndarray import load as nd_load
        loaded = nd_load(filename, ctx=ctx or _first_ctx(self))
        arg_dict = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter %r missing in file %r"
                                     % (name, filename))
        for name, arr in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError("Parameter %r in file is not in this "
                                     "ParameterDict" % name)
                continue
            self._params[name].set_data(arr)


def _first_ctx(params):
    for p in params.values():
        if p._data is not None:
            return p._data.context
        if p._deferred_init is not None:
            return p._deferred_init[1]
    return None
