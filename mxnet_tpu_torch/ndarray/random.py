"""``mx.nd.random`` (parity: python/mxnet/ndarray/random.py).

Counterpart of ``mxnet_tpu/ndarray/random.py``: the samplers by their
short names. ``ctx`` places the draw (default: the current context,
``gpu(0)``); every draw comes from that device's generator
(``mxnet_tpu_torch.random``).
"""
from __future__ import annotations

from .. import imperative as _imp
from ..ops import registry as _registry

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]


def _call(name, kwargs):
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    out = kwargs.pop("out", None)
    return _imp.invoke(_registry.get_op(name), [], kwargs, out=out)


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None,
            **kw):
    return _call("_random_uniform", dict(low=low, high=high, shape=shape,
                                         dtype=dtype, ctx=ctx, out=out))


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None,
           **kw):
    return _call("_random_normal", dict(loc=loc, scale=scale, shape=shape,
                                        dtype=dtype, ctx=ctx, out=out))


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, out=None,
          **kw):
    return _call("_random_gamma", dict(alpha=alpha, beta=beta, shape=shape,
                                       dtype=dtype, ctx=ctx, out=out))


def exponential(lam=1, shape=(), dtype="float32", ctx=None, out=None, **kw):
    return _call("_random_exponential", dict(lam=lam, shape=shape,
                                             dtype=dtype, ctx=ctx, out=out))


def poisson(lam=1, shape=(), dtype="float32", ctx=None, out=None, **kw):
    return _call("_random_poisson", dict(lam=lam, shape=shape, dtype=dtype,
                                         ctx=ctx, out=out))


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                      out=None, **kw):
    return _call("_random_negative_binomial",
                 dict(k=k, p=p, shape=shape, dtype=dtype, ctx=ctx, out=out))


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, out=None, **kw):
    return _call("_random_generalized_negative_binomial",
                 dict(mu=mu, alpha=alpha, shape=shape, dtype=dtype, ctx=ctx,
                      out=out))


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32",
                **kw):
    return _imp.invoke(_registry.get_op("_sample_multinomial"), [data],
                       dict(shape=shape, get_prob=get_prob, dtype=dtype),
                       out=out)


def shuffle(data, out=None, **kw):
    return _imp.invoke(_registry.get_op("_shuffle"), [data], {}, out=out)
