"""Basic gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: Sequential,
HybridSequential, Dense, Dropout, BatchNorm, FusedBNAddReLU,
InstanceNorm, LayerNorm, Embedding, Flatten, Activation, LeakyReLU,
Lambda, HybridLambda.
"""
from __future__ import annotations

import warnings

import numpy as np

from ...base import MXNetError
from ... import initializer as _init
from ... import layout as _layout
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "FusedBNAddReLU", "InstanceNorm", "LayerNorm", "Embedding",
           "Flatten", "Activation", "LeakyReLU", "Lambda", "HybridLambda"]


class Sequential(Block):
    """(parity: nn.Sequential) children called in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            warnings.warn("All children are HybridBlocks; consider "
                          "HybridSequential for one fused program.")
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """(parity: nn.HybridSequential)"""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def _forward_eager(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """(parity: nn.Dense) y = act(x W^T + b)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._units = units
            self._flatten = flatten
            self._act_type = activation
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=_init.create(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_hook(self, x, *args):
        in_units = 1
        for d in x.shape[1:]:
            in_units *= d
        self.weight._update_shape(
            (self._units, in_units if self._flatten else x.shape[-1]))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type is not None:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Dropout(HybridBlock):
    """(parity: nn.Dropout) the ``Dropout`` op: identity outside
    ``autograd.record(train_mode=True)``."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """(parity: nn.BatchNorm) the running stats are parameters without
    gradients (``grad_req='null'``), as gamma is without ``scale`` and
    beta without ``center``; the default axis follows the default layout
    (-1 when channels-last)."""

    def __init__(self, axis=None, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            if axis is None:
                axis = -1 if _layout.default_is_channels_last() else 1
            self._axis = axis
            self._momentum = momentum
            self._epsilon = epsilon
            self._scale = scale
            self._use_global_stats = use_global_stats
            for name, init, req in (
                    ("gamma", gamma_initializer,
                     "write" if scale else "null"),
                    ("beta", beta_initializer, "write" if center else "null"),
                    ("running_mean", running_mean_initializer, "null"),
                    ("running_var", running_variance_initializer, "null")):
                setattr(self, name, self.params.get(
                    name, grad_req=req, shape=(in_channels,),
                    init=_init.create(init), allow_deferred_init=True,
                    differentiable=name not in ("running_mean",
                                                "running_var")))

    def _shape_hook(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._update_shape((c,))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis)


class FusedBNAddReLU(BatchNorm):
    """ResNet block tail — BN-apply + residual-add + ReLU — as ONE op
    (``_contrib_BatchNormAddReLU``; the hand-written Hopper kernel when
    the channel axis is last). Takes (x, residual)."""

    def hybrid_forward(self, F, x, addend, gamma, beta, running_mean,
                       running_var):
        return F._contrib_BatchNormAddReLU(
            x, addend, gamma, beta, running_mean, running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)


class Embedding(HybridBlock):
    """(parity: nn.Embedding) rows of a (input_dim, output_dim) weight;
    its gradient is dense (``sparse_grad`` is not ported)."""

    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._input_dim = input_dim
            self._output_dim = output_dim
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    """(parity: nn.Flatten)"""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Activation(HybridBlock):
    """(parity: nn.Activation)"""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class InstanceNorm(HybridBlock):
    """(parity: mxnet_tpu/gluon/nn/basic_layers.py:220-245) gamma learns
    only with ``scale``, beta only with ``center``; ``axis`` is accepted
    and the channel axis is 1, as in the JAX package."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._epsilon = epsilon
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init.create(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init.create(beta_initializer),
                allow_deferred_init=True)

    def _shape_hook(self, x, *args):
        c = x.shape[1]
        self.gamma._update_shape((c,))
        self.beta._update_shape((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Normalisation over ``axis`` (parity:
    mxnet_tpu/gluon/nn/basic_layers.py:248-270)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._axis = axis
            self._epsilon = epsilon
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         allow_deferred_init=True,
                                         differentiable=scale)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        allow_deferred_init=True,
                                        differentiable=center)

    def _shape_hook(self, x, *args):
        c = x.shape[self._axis]
        self.gamma._update_shape((c,))
        self.beta._update_shape((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class LeakyReLU(HybridBlock):
    """(parity: nn.LeakyReLU) slope ``alpha`` below zero."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class Lambda(Block):
    """A function as a Block: a callable, or the name of an ``mx.nd``
    function (parity: nn.Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F
            if not hasattr(F, function):
                raise MXNetError("function %r not found in mx.nd" % function)
            self._func_impl = getattr(F, function)
        else:
            self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda(%s)" % getattr(self._func_impl, "__name__",
                                      self._func_impl)


class HybridLambda(HybridBlock):
    """A function ``f(F, x, *args)`` (or the name of an ``F`` function)
    as a HybridBlock (parity: nn.HybridLambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function
            self._func_impl = None
        else:
            self._func_impl = function
            self._func_name = getattr(function, "__name__", "lambda")

    def hybrid_forward(self, F, x, *args):
        if self._func_impl is not None:
            return self._func_impl(F, x, *args)
        return getattr(F, self._func_name)(x, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name
