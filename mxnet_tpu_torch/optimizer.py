"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (parity: reference
``python/mxnet/optimizer.py``): the ``Optimizer`` base with its
learning-rate / weight-decay bookkeeping (``lr_mult``/``wd_mult``,
``rescale_grad``, ``clip_gradient``, ``num_update``), the registry and
``create``, and so far ``SGD`` and ``NAG``. ``update`` writes the new
weight and state into the given NDArrays in place, as the reference's
fused ops do; the math is ``ops/optimizer_ops.py``.

Not ported yet (ROADMAP): the other optimizers, multi-precision master
weights, row-sparse (lazy) updates, multipliers read from a Symbol's
attributes, ``Updater``.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ops import optimizer_ops as _O

__all__ = ["Optimizer", "SGD", "NAG", "create", "register"]

_REGISTRY = {}


def register(cls):
    """Register an optimizer class under its lower-cased name."""
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An optimizer instance by registered name (case-insensitive)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise MXNetError("optimizer %r is not registered (known: %s)"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer (parity: optimizer.Optimizer)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        if sym is not None:
            raise MXNetError("Optimizer(sym=...): multipliers from symbol "
                             "attributes are not ported yet")
        if multi_precision:
            raise MXNetError("Optimizer(multi_precision=True) is not ported "
                             "yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined.")
        self.lr = lr

    create_optimizer = staticmethod(create)
    register = staticmethod(register)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # reference rule: no weight decay on 1-D params
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_kwargs(self):
        kw = {"rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


def _raw(x):
    return x if isinstance(x, torch.Tensor) else x._data


@register
class SGD(Optimizer):
    """SGD with momentum (parity: optimizer.SGD backed by the fused sgd
    ops)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        from .ndarray.ndarray import NDArray
        return NDArray(torch.zeros_like(_raw(weight)))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w, g = _raw(weight), _raw(grad)
        kw = self._common_kwargs()
        with torch.no_grad():
            if state is not None:
                new_w, new_m = _O.sgd_mom_update(
                    w, g, _raw(state), lr=lr, wd=wd,
                    momentum=self.momentum, **kw)
                _raw(state).copy_(new_m)
            else:
                new_w = _O.sgd_update(w, g, lr=lr, wd=wd, **kw)
            w.copy_(new_w)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (parity: optimizer.NAG — wd folds into
    the applied gradient before the momentum update)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _raw(weight)
        with torch.no_grad():
            g = _raw(grad) * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            if state is not None:
                mom = _raw(state)
                mom.mul_(self.momentum)
                g = g + wd * w
                mom.add_(g)
                g = g + self.momentum * mom
                w.sub_(lr * g)
            else:
                w.sub_(lr * (g + wd * w))
