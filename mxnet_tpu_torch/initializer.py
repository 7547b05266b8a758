"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (Uniform, Normal, Zero, One,
Constant, Orthogonal, Xavier, MSRAPrelu, Bilinear, LSTMBias, Load, Mixed,
FusedRNN and the name-based default rules for bias/gamma/beta/moving
stats). Uniform, Normal and Xavier (so MSRAPrelu) draw from an explicit
``torch.Generator`` on the CPU and then copy to the parameter's device,
so one seed gives the same weights on every device; the JAX package
draws them from numpy, and tests carry such weights across instead
(``weights.py``). Orthogonal draws from numpy's global state as the JAX
package does, so one ``np.random.seed`` gives both packages the same
array; Constant and Bilinear are deterministic and bit-equal.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError, registry_create, _KIND_REGISTRIES

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Zero", "One",
           "Constant", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Load", "Mixed", "FusedRNN", "create", "register"]


class InitDesc(str):
    """A parameter's name with its attributes (parity:
    initializer.InitDesc); an ``__init__`` attribute names the
    initializer of that one parameter."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer; callable on (name, NDArray).

    generator : torch.Generator for the random draws (default: one
        seeded with 0, made per initializer).
    """

    def __init__(self, generator=None):
        self._generator = generator

    @property
    def generator(self):
        if self._generator is None:
            self._generator = torch.Generator().manual_seed(0)
        return self._generator

    def dumps(self):
        """``'["name", {kwargs}]'``, the form an ``__init__`` attribute
        holds (parity: Initializer.dumps)."""
        kwargs = {k: v for k, v in vars(self).items()
                  if not k.startswith("_")}
        return json.dumps([self.__class__.__name__.lower(), kwargs])

    def __call__(self, desc, arr):
        """Initialise ``arr``: by the ``__init__`` attribute of an
        ``InitDesc`` where it has one, else by the suffix of the parameter
        name (parity with the reference's rules)."""
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            spec = desc.attrs["__init__"]
            try:
                name, kwargs = json.loads(spec)
            except (ValueError, TypeError):
                name, kwargs = spec, {}     # a plain registry name
            create(name, **kwargs)._init_weight(desc, arr)
            return
        if desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr)
        elif desc.endswith("gamma"):
            self._init_one(desc, arr)
        elif desc.endswith("beta"):
            self._init_zero(desc, arr)
        elif desc.endswith(("moving_mean", "running_mean")):
            self._init_zero(desc, arr)
        elif desc.endswith(("moving_var", "running_var")):
            self._init_one(desc, arr)
        else:
            raise MXNetError(
                "Unknown initialization pattern for %s; name a parameter "
                "*_weight/*_bias/..." % desc)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _draw(self, shape):
        return torch.empty(tuple(shape), dtype=torch.float32)


class Uniform(Initializer):
    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = self._draw(arr.shape).uniform_(-self.scale, self.scale,
                                                generator=self.generator)


class Normal(Initializer):
    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = self._draw(arr.shape).normal_(0.0, self.sigma,
                                               generator=self.generator)


class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


class Xavier(Initializer):
    """(parity: initializer.Xavier) fan computed from dims 1.. as in the
    reference (for an OHWI conv weight that is the JAX package's rule
    applied to the same logical shape)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) >= 2 else shape[0]
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("invalid factor_type %r" % self.factor_type)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = self._draw(shape).uniform_(-scale, scale,
                                                generator=self.generator)
        elif self.rnd_type == "gaussian":
            arr[:] = self._draw(shape).normal_(0.0, scale,
                                               generator=self.generator)
        else:
            raise MXNetError("invalid rnd_type %r" % self.rnd_type)


class Constant(Initializer):
    """Every element ``value`` (parity: mxnet_tpu/initializer.py:151)."""

    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = torch.full(tuple(arr.shape), float(self.value),
                            dtype=torch.float32)


class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis from the SVD of a numpy draw
    (parity: mxnet_tpu/initializer.py:161-179; ``np.random`` as there)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__()
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        arr[:] = torch.from_numpy(
            (self.scale * q).reshape(arr.shape).astype(np.float32))


class MSRAPrelu(Xavier):
    """Xavier, gaussian, magnitude ``2 / (1 + slope^2)`` (parity:
    mxnet_tpu/initializer.py:214)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator=generator)
        self.slope = slope


class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, k, k) deconvolution
    weight (parity: mxnet_tpu/initializer.py:222-236, vectorised: the
    same float64 arithmetic per element, then float32)."""

    def _init_weight(self, _, arr):
        shape = tuple(arr.shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        arr[:] = torch.from_numpy(weight.astype(np.float32).reshape(shape))


class LSTMBias(Initializer):
    """The forget gate's bias ``forget_bias``, the other gates' 0, for the
    i,f,c,o gate order (parity: initializer.LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__()
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(tuple(arr.shape), dtype=torch.float32)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        arr[:] = b

    _init_bias = _init_weight


class FusedRNN(Initializer):
    """A fused RNN's packed parameter vector, initialised array by array:
    unpacked into its per-layer, per-gate arrays
    (``rnn.FusedRNNCell.unpack_weights``), each given to ``init``, the
    LSTM forget gates' biases set to ``forget_bias``, and packed back
    (parity: initializer.FusedRNN). ``init`` is an Initializer or its
    ``dumps()``."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        super().__init__()
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        self._init = init
        self.init = init.dumps() if init is not None else None
        self.num_hidden = num_hidden
        self.num_layers = num_layers
        self.mode = mode
        self.bidirectional = bidirectional
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(
            self.num_hidden, self.num_layers, self.mode, self.bidirectional,
            forget_bias=self.forget_bias, prefix="")
        args = cell.unpack_weights({"parameters": arr})
        for name in args:
            if self.mode == "lstm" and name.endswith("_f_bias"):
                args[name][:] = self.forget_bias
            elif self._init is not None:
                self._init(InitDesc(name), args[name])
        arr[:] = cell.pack_weights(args)["parameters"]


class Load(Initializer):
    """Values from a ``.params`` file or a dict of arrays (``arg:``/
    ``aux:`` prefixes dropped), ``default_init`` for the rest (parity:
    mxnet_tpu/initializer.py:255-280)."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .context import cpu
            from .ndarray import load as _nd_load
            param = _nd_load(param, ctx=cpu())
        self.param = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            value = self.param[name]
            if tuple(value.shape) != tuple(arr.shape):
                raise MXNetError("Load: shape mismatch for %s: %s against "
                                 "%s" % (name, tuple(value.shape),
                                         tuple(arr.shape)))
            arr[:] = value
        elif self.default_init is None:
            raise MXNetError("Load: no init for %s" % name)
        else:
            self.default_init(name, arr)


class Mixed(Initializer):
    """The first initializer whose pattern matches the name (parity:
    mxnet_tpu/initializer.py:283-301)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: patterns/initializers length mismatch")
        self.map = [(re.compile(p), init) for p, init in
                    zip(patterns, initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError("Mixed: no pattern matches %r; add a '.*' "
                         "catch-all" % name)


register = registry_create("initializer")[0]
_REGISTRY = _KIND_REGISTRIES["initializer"]
_REGISTRY.update({"uniform": Uniform, "normal": Normal, "zero": Zero,
                  "zeros": Zero, "one": One, "ones": One,
                  "constant": Constant, "orthogonal": Orthogonal,
                  "xavier": Xavier, "msraprelu": MSRAPrelu,
                  "bilinear": Bilinear, "lstmbias": LSTMBias, "load": Load,
                  "mixed": Mixed, "fusedrnn": FusedRNN})


def create(name, **kwargs):
    """Initializer by registry name (``"zeros"``, ``"xavier"``, ...)."""
    if isinstance(name, Initializer):
        return name
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise MXNetError("initializer %r is not registered (known: %s)"
                         % (name, sorted(_REGISTRY)))
    return cls(**kwargs)


# (parity: mx.init_registry) this kind's register and create
init_registry = {"register": register, "create": create}
