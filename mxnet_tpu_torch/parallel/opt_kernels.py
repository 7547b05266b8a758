"""Pure optimizer kernels for the SPMD train step.

Counterpart of ``mxnet_tpu/parallel/opt_kernels.py`` (so far ``sgd``,
``nag`` and ``adam``). Each kernel is ``(init_fn, update_fn)``:

  init_fn(param) -> tuple of state tensors (possibly empty)
  update_fn(param, grad, state, t, hyper) -> (new_param, new_state)

with ``t`` the 1-based update count and ``hyper`` a dict of scalars. The
SGD and Adam rules are the fused updates of ``ops/optimizer_ops.py``,
shared with ``mx.optimizer.SGD`` and ``mx.optimizer.Adam``.
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


_KERNELS = {
    "sgd": (_sgd_init, _sgd_update),
    "nag": (_sgd_init, _nag_update),
    "adam": (_adam_init, _adam_update),
}


def get_kernel(name):
    name = name.lower()
    if name not in _KERNELS:
        raise MXNetError(
            "no SPMD kernel for optimizer %r in the port (ported: %s; the "
            "others are not ported yet)" % (name, ", ".join(sorted(_KERNELS))))
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
    raise MXNetError("no SPMD kernel mapping for optimizer %s in the port "
                     "(ported: SGD, NAG, Adam; the others are not ported "
                     "yet)"
                     % type(optimizer).__name__)
