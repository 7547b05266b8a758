"""Fused optimizer update rules as tensor functions.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (``sgd_update``,
``sgd_mom_update``, their multi-precision forms ``mp_sgd_update`` and
``mp_sgd_mom_update``, ``adam_update``, ``rmsprop_update``,
``rmspropalex_update`` and ``ftrl_update``; parity: reference
``optimizer_op.cc``). Each function is pure: it returns the new weight
(and new state) and leaves its inputs as they are, like the JAX ops.
Each is also the registered op of its name (``mx.nd.sgd_update``...),
whose imperative call writes the new weight and states back into its
inputs. PyTorch runs each line as its own elementwise kernel on the
card; one fused update kernel per parameter is later work.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update"]


def _apply_wd_clip(weight, grad, wd, rescale_grad, clip_gradient):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        grad = torch.clamp(grad, -clip_gradient, clip_gradient)
    return grad + wd * weight


@register("sgd_update", nin=2, arg_names=["weight", "grad"],
          defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                    "clip_gradient": -1.0},
          no_grad=True, mutate=(0,))
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _apply_wd_clip(weight, grad, wd, rescale_grad, clip_gradient)
    return weight - lr * g


@register("sgd_mom_update", nin=3, nout=2,
          arg_names=["weight", "grad", "mom"],
          defaults={"lr": 0.01, "momentum": 0.0, "wd": 0.0,
                    "rescale_grad": 1.0, "clip_gradient": -1.0},
          no_grad=True, mutate=(0, 2))
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(new_weight, new_mom)``."""
    g = _apply_wd_clip(weight, grad, wd, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register("mp_sgd_update", nin=3, nout=2,
          arg_names=["weight", "grad", "weight32"],
          defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                    "clip_gradient": -1.0},
          no_grad=True, mutate=(0, 2))
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """Multi-precision SGD: a bf16/fp16 weight with its fp32 master copy.
    Returns ``(new_weight, new_weight32)``; the low-precision weight is
    the master rounded to nearest even."""
    g = _apply_wd_clip(weight32, grad.float(), wd, rescale_grad,
                       clip_gradient)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", nin=4, nout=3,
          arg_names=["weight", "grad", "mom", "weight32"],
          defaults={"lr": 0.01, "momentum": 0.0, "wd": 0.0,
                    "rescale_grad": 1.0, "clip_gradient": -1.0},
          no_grad=True, mutate=(0, 2, 3))
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(new_weight, new_mom, new_weight32)``."""
    g = _apply_wd_clip(weight32, grad.float(), wd, rescale_grad,
                       clip_gradient)
    mom = momentum * mom - lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register("adam_update", nin=4, nout=3,
          arg_names=["weight", "grad", "mean", "var"],
          defaults={"lr": 0.001, "beta1": 0.9, "beta2": 0.999,
                    "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                    "clip_gradient": -1.0},
          no_grad=True, mutate=(0, 2, 3))
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(new_weight, new_mean, new_var)``; ``lr`` is already
    bias-corrected (``optimizer.Adam`` folds the correction in)."""
    g = _apply_wd_clip(weight, grad, wd, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", nin=3, nout=2, arg_names=["weight", "grad", "n"],
          defaults={"lr": 0.001, "gamma1": 0.95, "epsilon": 1e-8, "wd": 0.0,
                    "rescale_grad": 1.0, "clip_gradient": -1.0,
                    "clip_weights": -1.0},
          no_grad=True, mutate=(0, 2))
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """(parity: mxnet_tpu/ops/optimizer_ops.py:88-103) Returns
    ``(new_weight, new_n)``."""
    g = _apply_wd_clip(weight, grad, wd, rescale_grad, clip_gradient)
    n = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(n + epsilon)
    return _clip_weights(w, clip_weights), n


@register("rmspropalex_update", nin=5, nout=4,
          arg_names=["weight", "grad", "n", "g", "delta"],
          defaults={"lr": 0.001, "gamma1": 0.95, "gamma2": 0.9,
                    "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                    "clip_gradient": -1.0, "clip_weights": -1.0},
          no_grad=True, mutate=(0, 2, 3, 4))
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp, Graves 2013 (parity:
    mxnet_tpu/ops/optimizer_ops.py:106-123). Returns ``(new_weight,
    new_n, new_g, new_delta)``."""
    gr = _apply_wd_clip(weight, grad, wd, rescale_grad, clip_gradient)
    n = gamma1 * n + (1 - gamma1) * torch.square(gr)
    g = gamma1 * g + (1 - gamma1) * gr
    delta = gamma2 * delta - lr * gr / torch.sqrt(n - torch.square(g)
                                                  + epsilon)
    return _clip_weights(weight + delta, clip_weights), n, g, delta


@register("ftrl_update", nin=4, nout=3, arg_names=["weight", "grad", "z", "n"],
          defaults={"lr": 0.1, "lamda1": 0.01, "beta": 1.0, "wd": 0.0,
                    "rescale_grad": 1.0, "clip_gradient": -1.0},
          no_grad=True, mutate=(0, 2, 3))
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal (parity: mxnet_tpu/ops/optimizer_ops.py:126-140); wd
    enters the denominator, not the gradient. Returns ``(new_weight,
    new_z, new_n)``."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z = z + g - sigma * weight
    w = torch.where(
        torch.abs(z) <= lamda1, torch.zeros_like(weight),
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(new_n)) / lr
                                         + wd))
    return w, z, new_n
