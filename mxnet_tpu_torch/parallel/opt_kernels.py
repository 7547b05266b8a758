"""Pure optimizer kernels for the SPMD train step.

Counterpart of ``mxnet_tpu/parallel/opt_kernels.py`` (so far ``sgd`` and
``nag``). Each kernel is ``(init_fn, update_fn)``:

  init_fn(param) -> tuple of state tensors (possibly empty)
  update_fn(param, grad, state, t, hyper) -> (new_param, new_state)

with ``t`` the 1-based update count and ``hyper`` a dict of scalars. The
SGD rule is the fused update of ``ops/optimizer_ops.py``, shared with
``mx.optimizer.SGD``.
"""
from __future__ import annotations

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


_KERNELS = {
    "sgd": (_sgd_init, _sgd_update),
    "nag": (_sgd_init, _nag_update),
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
    raise MXNetError("no SPMD kernel mapping for optimizer %s in the port "
                     "(ported: SGD, NAG; the others are not ported yet)"
                     % type(optimizer).__name__)
