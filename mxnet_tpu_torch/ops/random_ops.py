"""Random sampling operators.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (parity: reference
``src/operator/random/sample_op.cc``, the ``_random_*`` ops drawing one
tensor from one distribution, and ``multisample_op.cc``, the
``sample_*`` ops drawing per element from tensor-valued parameters).
Each op draws from the ``torch.Generator`` it is handed (``_rng``, the
device's generator, see ``ops/common.take_rng``), so the same seed gives
the same draws eagerly and inside a graph. PyTorch's samplers are not
``jax.random``'s: the distributions match, the values do not.
"""
from __future__ import annotations

import torch

from .common import as_tuple, torch_dtype
from .registry import register
from .tensor import _creation


def _empty(shape, dtype, ctx):
    shape, dtype, dev = _creation(shape, dtype, ctx)
    return torch.empty(shape, dtype=dtype, device=dev)


def _gamma(alpha, shape, gen, like):
    """Standard gamma draws of ``shape`` (alpha broadcast), float32."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=like.device)
    return torch._standard_gamma(a.expand(shape).contiguous(), generator=gen)


@register("_random_uniform", nin=0,
          defaults={"low": 0.0, "high": 1.0, "shape": (), "dtype": "float32"},
          no_grad=True, aliases=("uniform", "random_uniform"))
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
                   _rng=None):
    return _empty(shape, dtype, ctx).uniform_(low, high, generator=_rng)


@register("_random_normal", nin=0,
          defaults={"loc": 0.0, "scale": 1.0, "shape": (), "dtype": "float32"},
          no_grad=True, aliases=("normal", "random_normal"))
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
                  _rng=None):
    return _empty(shape, dtype, ctx).normal_(loc, scale, generator=_rng)


@register("_random_gamma", nin=0,
          defaults={"alpha": 1.0, "beta": 1.0, "shape": (),
                    "dtype": "float32"},
          no_grad=True, aliases=("random_gamma",))
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
                 _rng=None):
    out = _empty(shape, dtype, ctx)
    return (_gamma(alpha, out.shape, _rng, out) * beta).to(out.dtype)


@register("_random_exponential", nin=0,
          defaults={"lam": 1.0, "shape": (), "dtype": "float32"},
          no_grad=True, aliases=("random_exponential",))
def random_exponential(lam=1.0, shape=(), dtype="float32", ctx=None,
                       _rng=None):
    return _empty(shape, dtype, ctx).exponential_(lam, generator=_rng)


@register("_random_poisson", nin=0,
          defaults={"lam": 1.0, "shape": (), "dtype": "float32"},
          no_grad=True, aliases=("random_poisson",))
def random_poisson(lam=1.0, shape=(), dtype="float32", ctx=None, _rng=None):
    out = _empty(shape, dtype, ctx)
    rate = torch.full(out.shape, float(lam), device=out.device)
    return torch.poisson(rate, generator=_rng).to(out.dtype)


@register("_random_negative_binomial", nin=0,
          defaults={"k": 1, "p": 1.0, "shape": (), "dtype": "float32"},
          no_grad=True, aliases=("random_negative_binomial",))
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                             _rng=None):
    """Failures before the k-th success: Poisson of a Gamma(k, (1-p)/p)
    rate, as the JAX op draws it."""
    out = _empty(shape, dtype, ctx)
    lam = _gamma(float(k), out.shape, _rng, out) * (1 - p) / p
    return torch.poisson(lam, generator=_rng).to(out.dtype)


@register("_random_generalized_negative_binomial", nin=0,
          defaults={"mu": 1.0, "alpha": 1.0, "shape": (), "dtype": "float32"},
          no_grad=True, aliases=("random_generalized_negative_binomial",))
def random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32",
                            ctx=None, _rng=None):
    out = _empty(shape, dtype, ctx)
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = _gamma(r, out.shape, _rng, out) * (1 - p) / p
    return torch.poisson(lam, generator=_rng).to(out.dtype)


# -- sample_* family: tensor-parameterised, one draw per parameter element --

def _multisample(draw):
    def op(*params, shape=(), dtype=None, _rng=None):
        shape = as_tuple(shape) or ()
        p0 = params[0]
        out_shape = tuple(p0.shape) + shape
        expanded = [p.reshape(tuple(p.shape) + (1,) * len(shape))
                    .expand(out_shape) for p in params]
        dt = torch_dtype(dtype) or p0.dtype
        return draw(_rng, expanded, out_shape, p0).to(dt)
    return op


def _like(shape, ref):
    return torch.empty(shape, dtype=torch.float32, device=ref.device)


register("_sample_uniform", nin=2, arg_names=["low", "high"],
         defaults={"shape": (), "dtype": None}, no_grad=True,
         aliases=("sample_uniform",))(_multisample(
             lambda g, p, s, r: p[0] + (p[1] - p[0])
             * _like(s, r).uniform_(generator=g)))
register("_sample_normal", nin=2, arg_names=["mu", "sigma"],
         defaults={"shape": (), "dtype": None}, no_grad=True,
         aliases=("sample_normal",))(_multisample(
             lambda g, p, s, r: p[0]
             + p[1] * _like(s, r).normal_(generator=g)))
register("_sample_gamma", nin=2, arg_names=["alpha", "beta"],
         defaults={"shape": (), "dtype": None}, no_grad=True,
         aliases=("sample_gamma",))(_multisample(
             lambda g, p, s, r: torch._standard_gamma(
                 p[0].float().contiguous(), generator=g) * p[1]))
register("_sample_exponential", nin=1, arg_names=["lam"],
         defaults={"shape": (), "dtype": None}, no_grad=True,
         aliases=("sample_exponential",))(_multisample(
             lambda g, p, s, r: _like(s, r).exponential_(generator=g)
             / p[0]))
register("_sample_poisson", nin=1, arg_names=["lam"],
         defaults={"shape": (), "dtype": None}, no_grad=True,
         aliases=("sample_poisson",))(_multisample(
             lambda g, p, s, r: torch.poisson(p[0].float().contiguous(),
                                              generator=g)))


@register("_sample_multinomial", nin=1, arg_names=["data"],
          defaults={"shape": (), "get_prob": False, "dtype": "int32"},
          no_grad=True, aliases=("sample_multinomial",))
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                       _rng=None):
    """Categorical draws from the rows of ``data`` (probabilities on the
    last axis; parity: multisample_op.cc multinomial): ``data.shape[:-1] +
    shape`` indices, and with ``get_prob`` their log-probabilities."""
    shape = as_tuple(shape) or ()
    n = 1
    for s in shape:
        n *= s
    batch = tuple(data.shape[:-1])
    probs = torch.clamp(data.reshape(-1, data.shape[-1]).float(), min=1e-30)
    idx = torch.multinomial(probs, n, replacement=True, generator=_rng)
    out = idx.reshape(batch + shape)
    if get_prob:
        logp = torch.log(probs).gather(1, idx).reshape(batch + shape)
        return out.to(torch_dtype(dtype)), logp.to(data.dtype)
    return out.to(torch_dtype(dtype))


@register("_shuffle", no_grad=True, aliases=("shuffle",))
def shuffle(data, _rng=None):
    """``data`` with its first axis permuted."""
    perm = torch.randperm(data.shape[0], generator=_rng, device=data.device)
    return data[perm]
