"""Elementwise operators: binary broadcast, scalar, unary, comparisons.

Counterpart of ``mxnet_tpu/ops/elemwise.py``, with the JAX package's
dtype rules: a scalar takes the tensor's dtype (an integer tensor gets
an integer scalar), comparisons return 0/1 in the left operand's dtype,
and ``maximum``/``minimum``/``relu`` split the gradient at a tie as
``jnp.maximum`` does (``torch.maximum`` shares that rule).
"""
from __future__ import annotations

import torch

from .common import torch_dtype
from .registry import register, alias


def _like(data, scalar):
    """``scalar`` as the Python number ``jnp.asarray(scalar, data.dtype)``
    would hold."""
    if data.dtype == torch.bool:
        return bool(scalar)
    if data.is_floating_point():
        return float(scalar)
    return int(scalar)


def _full(data, scalar):
    return data.new_full((), _like(data, scalar))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# Binary broadcast ops
# ---------------------------------------------------------------------------

_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
}
_BINARY_ALIASES = {
    "broadcast_add": ("broadcast_plus",),
    "broadcast_sub": ("broadcast_minus",),
}

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
}


def _make_binary(fn, cast_bool):
    def op(lhs, rhs):
        out = fn(lhs, rhs)
        if cast_bool:
            out = out.to(lhs.dtype)
        return out
    return op


for _name, _fn in _BINARY.items():
    register(_name, nin=2, aliases=_BINARY_ALIASES.get(_name, ()))(
        _make_binary(_fn, False))
for _name, _fn in _CMP.items():
    register(_name, nin=2, no_grad=True)(_make_binary(_fn, True))

# elemwise_* are the no-broadcast variants
for _ew, _fn in [("elemwise_add", torch.add), ("elemwise_sub", torch.sub),
                 ("elemwise_mul", torch.mul), ("elemwise_div", torch.div)]:
    register(_ew, nin=2)(_make_binary(_fn, False))
alias("elemwise_add", "_add", "_plus", "_Plus")
alias("elemwise_sub", "_sub", "_minus", "_Minus")
alias("elemwise_mul", "_mul", "_Mul")
alias("elemwise_div", "_div", "_Div")


@register("add_n", nin=-1, arg_names=["args"],
          aliases=("ElementWiseSum", "_sum"))
def add_n(*args, num_args=None):
    """Sum of N tensors (parity: elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# ---------------------------------------------------------------------------
# Scalar ops (the ``_plus_scalar`` family behind NDArray's operators)
# ---------------------------------------------------------------------------

def _scalar_op(name, fn, reverse=False, cast=False, aliases=()):
    def op(data, scalar=1.0):
        s = _like(data, scalar)
        out = fn(s, data) if reverse else fn(data, s)
        if cast:
            out = out.to(data.dtype)
        return out
    register(name, nin=1, defaults={"scalar": 1.0}, no_grad=cast,
             aliases=aliases)(op)


def _tensor_scalar(fn):
    """``fn`` for a Python scalar operand on either side."""
    def op(a, b):
        ref = b if isinstance(a, (int, float, bool)) else a
        a = _full(ref, a) if isinstance(a, (int, float, bool)) else a
        b = _full(ref, b) if isinstance(b, (int, float, bool)) else b
        return fn(a, b)
    return op


_scalar_op("_plus_scalar", torch.add, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", torch.sub, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda s, d: s - d, reverse=True,
           aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", torch.mul, aliases=("_MulScalar",))
_scalar_op("_div_scalar", torch.div, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda s, d: s / d, reverse=True,
           aliases=("_RDivScalar",))
_scalar_op("_mod_scalar", torch.remainder)
_scalar_op("_rmod_scalar", torch.remainder, reverse=True)
_scalar_op("_power_scalar", torch.pow, aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", torch.pow, reverse=True,
           aliases=("_RPowerScalar",))
_scalar_op("_maximum_scalar", _tensor_scalar(torch.maximum),
           aliases=("_MaximumScalar",))
_scalar_op("_minimum_scalar", _tensor_scalar(torch.minimum),
           aliases=("_MinimumScalar",))
_scalar_op("_hypot_scalar", _tensor_scalar(torch.hypot))
_scalar_op("_equal_scalar", torch.eq, cast=True)
_scalar_op("_not_equal_scalar", torch.ne, cast=True)
_scalar_op("_greater_scalar", torch.gt, cast=True)
_scalar_op("_greater_equal_scalar", torch.ge, cast=True)
_scalar_op("_lesser_scalar", torch.lt, cast=True)
_scalar_op("_lesser_equal_scalar", torch.le, cast=True)


# ---------------------------------------------------------------------------
# Unary math ops (parity: elemwise_unary_op.cc)
# ---------------------------------------------------------------------------

_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "round": torch.round,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc, "square": torch.square,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}
_UNARY_NO_GRAD = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix",
                  "logical_not"}
_UNARY_ALIASES = {"abs": ("_abs",), "negative": ("_negative",)}


def _unary(fn):
    def op(data):
        return fn(data)
    return op


for _name, _fn in _UNARY.items():
    register(_name, nin=1, no_grad=_name in _UNARY_NO_GRAD,
             aliases=_UNARY_ALIASES.get(_name, ()))(_unary(_fn))


@register("relu")
def relu(data):
    """max(x, 0) with ``jnp.maximum``'s gradient of 1/2 at exactly 0."""
    return torch.maximum(data, data.new_zeros(()))


@register("sigmoid")
def sigmoid(data):
    return torch.sigmoid(data)


@register("softsign")
def softsign(data):
    return data / (1 + torch.abs(data))


@register("clip", defaults={"a_min": 0.0, "a_max": 1.0})
def clip(data, a_min=0.0, a_max=1.0):
    return torch.clamp(data, _like(data, a_min), _like(data, a_max))


@register("_copy", aliases=("identity",))
def _copy(data):
    return data.clone()


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    """Stop gradient flow (parity: elemwise_unary_op.cc BlockGrad)."""
    return data.detach()


@register("make_loss")
def make_loss_op(data):
    return data


@register("_identity_with_attr_like_rhs", nin=2)
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("Cast", defaults={"dtype": "float32"}, aliases=("cast",))
def cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("smooth_l1", defaults={"scalar": 1.0})
def smooth_l1(data, scalar=1.0):
    """Smooth L1: 0.5 (sigma x)^2 where |x| < 1/sigma^2, else
    |x| - 0.5/sigma^2."""
    sigma2 = float(scalar) * float(scalar)
    absx = torch.abs(data)
    return torch.where(absx < 1.0 / sigma2, 0.5 * sigma2 * data * data,
                       absx - 0.5 / sigma2)

