"""Pure optimizer kernels for the SPMD train step.

Counterpart of ``mxnet_tpu/parallel/opt_kernels.py`` (``sgd``, ``nag``,
``adam``, ``rmsprop``, ``adagrad``, ``adadelta`` and ``ftrl``, the
JAX package's whole set; ``mxnet_tpu/parallel/opt_kernels.py:69-115``). Each kernel is ``(init_fn, update_fn)``:

  init_fn(param) -> tuple of state tensors (possibly empty)
  update_fn(param, grad, state, t, hyper) -> (new_param, new_state)

with ``t`` the 1-based update count and ``hyper`` a dict of scalars. The
SGD, Adam, RMSProp and Ftrl rules are the fused updates of
``ops/optimizer_ops.py``, shared with the optimizer classes; the
AdaGrad and AdaDelta rules are written out here as in the JAX package.
An optimizer without a kernel (SGLD, DCASGD, Adamax, Nadam, Test,
centered RMSProp) takes the per-parameter path of ``FusedUpdater``.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer_ops as _O

__all__ = ["get_kernel", "hyper_from_optimizer"]


def _clip(g, c):
    return torch.clamp(g, -c, c) if (c is not None and c > 0) else g


def _sgd_init(p):
    return (torch.zeros_like(p),)


def _sgd_update(p, g, s, t, h):
    if h.get("momentum_static", 0.0):
        w, m = _O.sgd_mom_update(p, g, s[0], lr=h["lr"],
                                 momentum=h["momentum"], wd=h["wd"],
                                 rescale_grad=h["rescale_grad"],
                                 clip_gradient=h["clip_gradient"])
        return w, (m,)
    w = _O.sgd_update(p, g, lr=h["lr"], wd=h["wd"],
                      rescale_grad=h["rescale_grad"],
                      clip_gradient=h["clip_gradient"])
    return w, s


def _nag_update(p, g, s, t, h):
    # Nesterov momentum (reference optimizer.py NAG.update_impl)
    grad = _clip(g * h["rescale_grad"], h["clip_gradient"]) + h["wd"] * p
    m = h["momentum"] * s[0] + grad
    w = p - h["lr"] * (grad + h["momentum"] * m)
    return w, (m,)


def _adam_init(p):
    return (torch.zeros_like(p), torch.zeros_like(p))


def _adam_update(p, g, s, t, h):
    # bias-corrected lr, as mx.optimizer.Adam folds it in before the op
    lr_t = h["lr"] * math.sqrt(1.0 - h["beta2"] ** t) \
        / (1.0 - h["beta1"] ** t)
    w, mean, var = _O.adam_update(
        p, g, s[0], s[1], lr=lr_t, beta1=h["beta1"], beta2=h["beta2"],
        epsilon=h["epsilon"], wd=h["wd"], rescale_grad=h["rescale_grad"],
        clip_gradient=h["clip_gradient"])
    return w, (mean, var)


def _rmsprop_update(p, g, s, t, h):
    w, n = _O.rmsprop_update(p, g, s[0], lr=h["lr"], gamma1=h["gamma1"],
                             epsilon=h["epsilon"], wd=h["wd"],
                             rescale_grad=h["rescale_grad"],
                             clip_gradient=h["clip_gradient"])
    return w, (n,)


def _adagrad_update(p, g, s, t, h):
    # AdaGrad's dense rule: wd stays out of the history, eps inside sqrt
    grad = _clip(g * h["rescale_grad"], h["clip_gradient"])
    hist = s[0] + torch.square(grad)
    w = p - h["lr"] * (grad / torch.sqrt(hist + h["epsilon"]) + h["wd"] * p)
    return w, (hist,)


def _adadelta_update(p, g, s, t, h):
    # wd applies to the weight directly, not through the accumulators
    grad = _clip(g * h["rescale_grad"], h["clip_gradient"])
    acc_g = h["rho"] * s[0] + (1.0 - h["rho"]) * torch.square(grad)
    delta = torch.sqrt((s[1] + h["epsilon"]) / (acc_g + h["epsilon"])) * grad
    acc_d = h["rho"] * s[1] + (1.0 - h["rho"]) * torch.square(delta)
    return p - delta - h["wd"] * p, (acc_g, acc_d)


def _ftrl_update(p, g, s, t, h):
    w, z, n = _O.ftrl_update(p, g, s[0], s[1], lr=h["lr"],
                             lamda1=h["lamda1"], beta=h["beta"], wd=h["wd"],
                             rescale_grad=h["rescale_grad"],
                             clip_gradient=h["clip_gradient"])
    return w, (z, n)


_KERNELS = {
    "sgd": (_sgd_init, _sgd_update),
    "nag": (_sgd_init, _nag_update),
    "adam": (_adam_init, _adam_update),
    "rmsprop": (_sgd_init, _rmsprop_update),
    "adagrad": (_sgd_init, _adagrad_update),
    "adadelta": (_adam_init, _adadelta_update),
    "ftrl": (_adam_init, _ftrl_update),
}


def get_kernel(name):
    name = name.lower()
    if name not in _KERNELS:
        raise MXNetError(
            "no SPMD kernel for optimizer %r (have: %s)"
            % (name, ", ".join(sorted(_KERNELS))))
    return _KERNELS[name]


def hyper_from_optimizer(optimizer):
    """(kernel_name, hyper dict) from an ``mx.optimizer.Optimizer``."""
    from .. import optimizer as opt
    h = {
        "lr": float(optimizer._get_lr(0)),
        "wd": float(optimizer._get_wd(0)),
        "rescale_grad": float(optimizer.rescale_grad),
        "clip_gradient": float(optimizer.clip_gradient
                               if optimizer.clip_gradient is not None
                               else -1.0),
    }
    if isinstance(optimizer, opt.NAG):
        h["momentum"] = float(optimizer.momentum)
        return "nag", h
    if isinstance(optimizer, opt.SGD):
        h["momentum"] = float(optimizer.momentum)
        h["momentum_static"] = float(optimizer.momentum)
        return "sgd", h
    if isinstance(optimizer, opt.Adam):
        h.update(beta1=float(optimizer.beta1), beta2=float(optimizer.beta2),
                 epsilon=float(optimizer.epsilon))
        return "adam", h
    if isinstance(optimizer, opt.RMSProp) and not optimizer.centered \
            and not optimizer.clip_weights:
        # (the JAX package's kernel drops clip_weights; the port keeps
        # such an optimizer on the per-parameter path, which clips)
        h.update(gamma1=float(optimizer.gamma1),
                 epsilon=float(optimizer.epsilon))
        return "rmsprop", h
    if isinstance(optimizer, opt.AdaGrad):
        h.update(epsilon=float(optimizer.float_stable_eps))
        return "adagrad", h
    if isinstance(optimizer, opt.AdaDelta):
        h.update(rho=float(optimizer.rho), epsilon=float(optimizer.epsilon))
        return "adadelta", h
    if isinstance(optimizer, opt.Ftrl):
        h.update(lamda1=float(optimizer.lamda1), beta=float(optimizer.beta))
        return "ftrl", h
    raise MXNetError("no kernel for optimizer %s (kernels: %s); it takes "
                     "the per-parameter path"
                     % (type(optimizer).__name__,
                        ", ".join(sorted(_KERNELS))))
