"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (parity: reference
``python/mxnet/optimizer.py``): the ``Optimizer`` base with its
learning-rate / weight-decay bookkeeping (``lr_mult``/``wd_mult``,
``rescale_grad``, ``clip_gradient``, ``num_update``, multipliers from a
Symbol's ``__lr_mult__``/``__wd_mult__`` attributes), multi-precision
master weights (``multi_precision=True``: a bf16/fp16 weight keeps an
fp32 master in its state), the registry and ``create``, ``SGD``,
``NAG``, ``Adam``, ``SGLD``, ``DCASGD``, ``AdaGrad``, ``RMSProp`` (plain
and centered), ``AdaDelta``, ``Ftrl``, ``Test``, ``ccSGD``, ``Adamax``
and ``Nadam``, and the updaters: ``Updater`` (per parameter, with
``get_states``/``set_states`` in the JAX package's pickled format) and
``FusedUpdater`` (``update_batch`` over a whole parameter set through the
pure kernels of ``parallel/opt_kernels.py``, the loop Module's fused step
runs). ``update`` writes the new weight and state into the given NDArrays
in place, as the reference's fused ops do; the math is
``ops/optimizer_ops.py``. A row_sparse gradient takes the lazy update of
``SGD`` (with momentum, and the fp32 master under multi-precision),
``Adam`` and ``AdaGrad``: only the rows it holds change, in the weight
and in the state; the updaters then go parameter by parameter.
"""
from __future__ import annotations

import copyreg
import io
import math
import pickle

import numpy as np
import torch

from .base import MXNetError, registry_create, _KIND_REGISTRIES
from .ops import optimizer_ops as _O
from .ndarray import (sgd_update, sgd_mom_update, mp_sgd_update,  # noqa: F401
                      mp_sgd_mom_update, adam_update, rmsprop_update,
                      rmspropalex_update, ftrl_update, zeros)

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Test", "ccSGD", "Adamax", "Nadam",
           "Updater", "FusedUpdater", "get_updater", "create", "register"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)

register = registry_create("optimizer")[0]
_REGISTRY = _KIND_REGISTRIES["optimizer"]


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
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ({}, [])
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

    def __getstate__(self):
        """Pickled without ``param_dict`` (live Parameters and their
        tensors); the hyperparameters, update counts and scheduler go
        along, as in the JAX package's dump."""
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    def _adopt_counts(self, dumped):
        """Take a dumped optimizer's ``num_update``, per-index update
        counts and scheduler position (``dumped`` is this package's
        optimizer or the JAX package's, unpickled as a stub)."""
        d = getattr(dumped, "__dict__", {})
        if "num_update" in d:
            self.num_update = int(d["num_update"])
        if "_index_update_count" in d:
            self._index_update_count = {
                k: int(v) for k, v in d["_index_update_count"].items()}
        sched = d.get("lr_scheduler")
        if self.lr_scheduler is not None and sched is not None:
            self.lr_scheduler.__dict__.update(
                {k: v for k, v in getattr(sched, "__dict__", {}).items()
                 if k in self.lr_scheduler.__dict__})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` a half-precision weight's state is
        ``(state of its fp32 copy, fp32 master)``."""
        if self.multi_precision and _raw(weight).dtype in _LOW_PRECISION:
            w32 = _wrap_like(weight, _raw(weight).float())
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        attr, arg_names = self.sym_info
        for name in arg_names:
            if name in attr and "__lr_mult__" in attr[name]:
                self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # reference rule: no weight decay on 1-D params
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        attr, arg_names = self.sym_info
        for name in arg_names:
            if name in attr and "__wd_mult__" in attr[name]:
                self.wd_mult[name] = float(attr[name]["__wd_mult__"])
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

    # -- row-sparse (lazy) updates -----------------------------------------
    def _sparse_rows(self, grad):
        """``(row ids, rows)`` of a row_sparse gradient, rescaled and
        clipped (reference optimizer_op.cc row_sparse kernels)."""
        g = grad._rsp_data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return grad._rsp_indices.long(), g

    @staticmethod
    def _is_row_sparse(grad):
        from .ndarray.sparse import RowSparseNDArray
        return isinstance(grad, RowSparseNDArray)


def _raw(x):
    return x if isinstance(x, torch.Tensor) else x._data


def _wrap_like(weight, tensor):
    """``tensor`` as an NDArray on ``weight``'s context (a raw tensor
    stays raw)."""
    if isinstance(weight, torch.Tensor):
        return tensor
    from .ndarray.ndarray import NDArray
    return NDArray(tensor, weight.context)


def _grad32(grad):
    """The gradient in fp32 for an fp32 master, a row_sparse one kept
    row_sparse."""
    from .ndarray.sparse import RowSparseNDArray
    if isinstance(grad, RowSparseNDArray):
        return RowSparseNDArray(grad._rsp_data.float(), grad._rsp_indices,
                                grad.shape, grad.context)
    return _wrap_like(grad, _raw(grad).float())


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
        return _wrap_like(weight, torch.zeros_like(_raw(weight)))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self._is_row_sparse(grad):
            self._update_sparse(weight, grad, state, lr, wd)
            return
        w, g = _raw(weight), _raw(grad)
        kw = self._common_kwargs()
        with torch.no_grad():
            if isinstance(state, tuple):        # multi-precision
                mom, w32 = state
                if mom is not None:
                    new_w, new_m, new_w32 = _O.mp_sgd_mom_update(
                        w, g, _raw(mom), _raw(w32), lr=lr, wd=wd,
                        momentum=self.momentum, **kw)
                    _raw(mom).copy_(new_m)
                else:
                    new_w, new_w32 = _O.mp_sgd_update(w, g, _raw(w32), lr=lr,
                                                      wd=wd, **kw)
                _raw(w32).copy_(new_w32)
                w.copy_(new_w)
                return
            if state is not None:
                new_w, new_m = _O.sgd_mom_update(
                    w, g, _raw(state), lr=lr, wd=wd,
                    momentum=self.momentum, **kw)
                _raw(state).copy_(new_m)
            else:
                new_w = _O.sgd_update(w, g, lr=lr, wd=wd, **kw)
            w.copy_(new_w)

    update_multi_precision = update

    def _update_sparse(self, weight, grad, state, lr, wd):
        """Lazy SGD (reference SGDUpdateRspRspImpl): only the gradient's
        rows move, their momentum decays only then; a multi-precision
        state ``(mom, w32)`` updates the fp32 master's rows and casts the
        weight back."""
        rows, g = self._sparse_rows(grad)
        master = weight
        if isinstance(state, tuple):            # multi-precision
            state, master = state
        w = _raw(master)
        with torch.no_grad():
            g = g.to(w.dtype) + wd * w.index_select(0, rows)
            if state is not None:
                mom = _raw(state)
                m_new = self.momentum * mom.index_select(0, rows) - lr * g
                mom.index_copy_(0, rows, m_new)
                w.index_add_(0, rows, m_new)
            else:
                w.index_add_(0, rows, -lr * g)
            if master is not weight:
                _raw(weight).copy_(w)


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

    def update_multi_precision(self, index, weight, grad, state):
        """NAG's own rule (SGD's alias would bind ``SGD.update``): on the
        fp32 master for a multi-precision state, then cast back."""
        if not isinstance(state, tuple):
            return self.update(index, weight, grad, state)
        mom, w32 = state
        self.update(index, w32, _grad32(grad), mom)
        with torch.no_grad():
            _raw(weight).copy_(_raw(w32))


@register
class Adam(Optimizer):
    """(parity: optimizer.Adam backed by the fused ``adam_update`` op): the
    bias correction ``sqrt(1 - beta2^t) / (1 - beta1^t)`` folds into the
    learning rate, ``t`` the parameter's update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_wrap_like(weight, torch.zeros_like(_raw(weight))),
                _wrap_like(weight, torch.zeros_like(_raw(weight))))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr = lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        if self._is_row_sparse(grad):
            self._update_sparse(weight, grad, mean, var, lr, wd)
            return
        with torch.no_grad():
            new_w, new_m, new_v = _O.adam_update(
                _raw(weight), _raw(grad), _raw(mean), _raw(var), lr=lr,
                wd=wd, beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, **self._common_kwargs())
            _raw(mean).copy_(new_m)
            _raw(var).copy_(new_v)
            _raw(weight).copy_(new_w)

    def update_multi_precision(self, index, weight, grad, state):
        """On the fp32 master for a multi-precision state, then cast back
        (the JAX package's Adam has no multi-precision path)."""
        if not isinstance(state[0], tuple):     # (mean, var)
            return self.update(index, weight, grad, state)
        moments, w32 = state
        self.update(index, w32, _grad32(grad), moments)
        with torch.no_grad():
            _raw(weight).copy_(_raw(w32))

    def _update_sparse(self, weight, grad, mean, var, lr, wd):
        """Lazy Adam (reference AdamUpdateRspRspImpl): only the
        gradient's rows advance their moments and move."""
        rows, g = self._sparse_rows(grad)
        w, m, v = _raw(weight), _raw(mean), _raw(var)
        with torch.no_grad():
            g = g + wd * w.index_select(0, rows)
            m_new = self.beta1 * m.index_select(0, rows) + (1 - self.beta1) * g
            v_new = self.beta2 * v.index_select(0, rows) \
                + (1 - self.beta2) * g * g
            step = lr * m_new / (torch.sqrt(v_new) + self.epsilon)
            m.index_copy_(0, rows, m_new)
            v.index_copy_(0, rows, v_new)
            w.index_add_(0, rows, -step)


def _zeros32(weight):
    """An fp32 state of the weight's shape on its device (the JAX
    package's ``_state_zeros(weight, dtype=np.float32)``)."""
    return _wrap_like(weight, torch.zeros(_raw(weight).shape,
                                          dtype=torch.float32,
                                          device=_raw(weight).device))


def _rescaled(opt, grad):
    """``grad * rescale_grad``, clipped to ``clip_gradient``."""
    g = _raw(grad) * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


class _MasterWeight:
    """``update_multi_precision`` on the fp32 master for a state
    ``(inner, w32)`` that ``create_state_multi_precision`` made, then the
    weight cast back (SGD's scheme, for the optimizers whose JAX class
    takes the base ``update_multi_precision``: there a half weight
    updates in its own dtype)."""

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision
                and _raw(weight).dtype in _LOW_PRECISION):
            return self.update(index, weight, grad, state)
        inner, w32 = state
        self.update(index, w32, _grad32(grad), inner)
        with torch.no_grad():
            _raw(weight).copy_(_raw(w32))


@register
class SGLD(_MasterWeight, Optimizer):
    """Stochastic Gradient Langevin Dynamics (parity:
    mxnet_tpu/optimizer.py:291-305): half a gradient step plus
    N(0, lr) noise, drawn from the weight device's generator."""

    def update(self, index, weight, grad, state):
        from .ops.common import take_rng
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _raw(weight)
        with torch.no_grad():
            g = _rescaled(self, grad)
            noise = torch.empty(w.shape, dtype=w.dtype, device=w.device) \
                .normal_(0.0, math.sqrt(lr), generator=take_rng(w.device))
            w.sub_(lr / 2 * (g + wd * w))
            w.add_(noise)


@register
class DCASGD(_MasterWeight, Optimizer):
    """Delay-compensated asynchronous SGD (parity:
    mxnet_tpu/optimizer.py:308-341): state ``(momentum or None, previous
    weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = _wrap_like(weight, _raw(weight).detach().clone())
        if self.momentum == 0.0:
            return (None, prev)
        return (_wrap_like(weight, torch.zeros_like(_raw(weight))), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _raw(weight)
        mom, previous = state
        with torch.no_grad():
            g = _rescaled(self, grad)
            prev = _raw(previous)
            step = -lr * (g + wd * w + self.lamda * g * g * (w - prev))
            if mom is not None:
                m = _raw(mom)
                m.mul_(self.momentum)
                m.add_(step)
                step = m
            prev.copy_(w)
            w.add_(step)


@register
class AdaGrad(_MasterWeight, Optimizer):
    """(parity: mxnet_tpu/optimizer.py:381-413, dense branch) the history
    accumulates the squared rescaled gradient; wd stays out of it."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w, h = _raw(weight), _raw(state)
        if self._is_row_sparse(grad):
            # lazy AdaGrad (reference AdagradUpdateRspRspImpl)
            rows, g = self._sparse_rows(grad)
            with torch.no_grad():
                wr = w.index_select(0, rows)
                h_new = h.index_select(0, rows) + g * g
                h.index_copy_(0, rows, h_new)
                w.index_add_(0, rows, -(lr * (
                    g / torch.sqrt(h_new + self.float_stable_eps) + wd * wr)))
            return
        with torch.no_grad():
            g = _rescaled(self, grad)
            h.add_(g * g)
            w.sub_(lr * (g / torch.sqrt(h + self.float_stable_eps)
                         + wd * w))


@register
class RMSProp(_MasterWeight, Optimizer):
    """(parity: mxnet_tpu/optimizer.py:416-451) the fused
    ``rmsprop_update``; ``centered=True`` is Graves' variant
    (``rmspropalex_update``, three states)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros32(weight), _zeros32(weight), _zeros32(weight))
        return (_zeros32(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = self._common_kwargs()
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        w, g = _raw(weight), _raw(grad)
        with torch.no_grad():
            if not self.centered:
                (n,) = state
                new_w, new_n = _O.rmsprop_update(
                    w, g, _raw(n), lr=lr, wd=wd, gamma1=self.gamma1,
                    epsilon=self.epsilon, **kw)
                _raw(n).copy_(new_n)
            else:
                n, gm, delta = state
                new_w, new_n, new_g, new_d = _O.rmspropalex_update(
                    w, g, _raw(n), _raw(gm), _raw(delta), lr=lr, wd=wd,
                    gamma1=self.gamma1, gamma2=self.gamma2,
                    epsilon=self.epsilon, **kw)
                _raw(n).copy_(new_n)
                _raw(gm).copy_(new_g)
                _raw(delta).copy_(new_d)
            w.copy_(new_w)


@register
class AdaDelta(_MasterWeight, Optimizer):
    """(parity: mxnet_tpu/optimizer.py:454-479) wd applies to the weight
    directly, not through the accumulators."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        w = _raw(weight)
        acc_g, acc_delta = _raw(state[0]), _raw(state[1])
        with torch.no_grad():
            g = _rescaled(self, grad)
            acc_g.mul_(self.rho)
            acc_g.add_((1.0 - self.rho) * g * g)
            delta = (torch.sqrt(acc_delta + self.epsilon)
                     / torch.sqrt(acc_g + self.epsilon)) * g
            acc_delta.mul_(self.rho)
            acc_delta.add_((1.0 - self.rho) * delta * delta)
            w.sub_(delta + wd * w)


@register
class Ftrl(_MasterWeight, Optimizer):
    """(parity: mxnet_tpu/optimizer.py:482-498) the fused
    ``ftrl_update``; states ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        with torch.no_grad():
            new_w, new_z, new_n = _O.ftrl_update(
                _raw(weight), _raw(grad), _raw(z), _raw(n), lr=lr, wd=wd,
                lamda1=self.lamda1, beta=self.beta, **self._common_kwargs())
            _raw(z).copy_(new_z)
            _raw(n).copy_(new_n)
            _raw(weight).copy_(new_w)


@register
class Test(Optimizer):
    """(parity: mxnet_tpu/optimizer.py:501-510) ``weight += grad *
    rescale_grad``; the state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            _raw(weight).add_(_raw(grad) * self.rescale_grad)
            _raw(state).copy_(_raw(weight))


@register
class ccSGD(SGD):
    """The deprecated alias of SGD (parity: optimizer.ccSGD)."""


@register
class Adamax(_MasterWeight, Optimizer):
    """AdaMax, Adam under the infinity norm (parity:
    mxnet_tpu/optimizer.py:518-545): wd folds into the gradient before
    the clip."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        w = _raw(weight)
        m, u = _raw(state[0]), _raw(state[1])
        with torch.no_grad():
            g = _raw(grad) * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            m.mul_(self.beta1)
            m.add_((1.0 - self.beta1) * g)
            u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
            w.sub_(lr * m / u)


@register
class Nadam(_MasterWeight, Optimizer):
    """Nesterov-accelerated Adam with Dozat's momentum schedule (parity:
    mxnet_tpu/optimizer.py:548-589). ``m_schedule`` is one product over
    every parameter's updates, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = _raw(weight)
        m, v = _raw(state[0]), _raw(state[1])
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        with torch.no_grad():
            g = _raw(grad) * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            m.mul_(self.beta1)
            m.add_((1.0 - self.beta1) * g)
            v.mul_(self.beta2)
            v.add_((1.0 - self.beta2) * g * g)
            grad_prime = g / (1.0 - self.m_schedule)
            m_prime = m / (1.0 - m_schedule_next)
            v_prime = v / (1.0 - self.beta2 ** t)
            m_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_prime
            w.sub_(lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))


# ---------------------------------------------------------------------------
# Updaters
# ---------------------------------------------------------------------------

def _state_to_numpy(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_to_numpy(x) for x in s)
    if isinstance(s, np.ndarray):        # loaded, not yet on a device
        return s
    t = _raw(s).detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class _ForeignStub:
    """Stands in for an object of another package in pickled states."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        """Keep the pickled attributes: a dumped optimizer's update
        counts and its scheduler's position are read from them."""
        if isinstance(state, tuple) and len(state) == 2:   # (dict, slots)
            state = {**(state[0] or {}), **(state[1] or {})}
        if isinstance(state, dict):
            self.__dict__.update(state)


class _StatesUnpickler(pickle.Unpickler):
    """Unpickles optimizer states (numpy arrays in dicts and tuples);
    any other class loads as a stub, so a pickled foreign optimizer needs
    no import of its package."""

    _KEEP = ("numpy", "builtins", "copyreg", "collections", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._KEEP:
            return super().find_class(module, name)
        return _ForeignStub


class _Counterpart:
    """A class of the JAX package, named and never imported."""

    def __init__(self, module, name):
        self.ref = ("%s\n%s\n" % (module, name)).encode()


class _CounterpartPickler(pickle._Pickler):
    """Pickles an optimizer or scheduler of this package as an instance
    of the JAX package's class of the same name, with its attributes
    (the attribute sets are the same): the JAX package loads a dumped
    optimizer from this package as its own, and this package reads it
    back through ``_StatesUnpickler``'s stubs. The class is written as a
    ``GLOBAL`` reference by name; nothing of the JAX package is
    imported."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_counterpart(self, obj):
        self.write(pickle.GLOBAL + obj.ref)
        self.memoize(obj)

    dispatch[_Counterpart] = _save_counterpart

    def reducer_override(self, obj):
        from . import lr_scheduler
        for base, module in ((Optimizer, "mxnet_tpu.optimizer"),
                             (lr_scheduler.LRScheduler,
                              "mxnet_tpu.lr_scheduler")):
            if isinstance(obj, base):
                cls = _Counterpart(module, type(obj).__name__)
                return (copyreg._reconstructor, (cls, object, None),
                        obj.__getstate__() if base is Optimizer
                        else dict(obj.__dict__))
        return NotImplemented


class Updater:
    """Applies an optimizer to ``(index, grad, weight)`` calls (parity:
    ``optimizer.Updater``). States are created at a parameter's first
    update (``create_state_multi_precision``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        self._ensure_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def _ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self._sync_state(index, weight)
        return self.states[index]

    def _sync_state(self, index, weight):
        """Host states from ``set_states`` -> NDArrays on the weight's
        context (fp32 states stay fp32)."""
        from .ndarray.ndarray import NDArray
        dev = _raw(weight).device

        def conv(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(conv(x) for x in s)
            t = _raw(s) if isinstance(s, (NDArray, torch.Tensor)) \
                else torch.from_numpy(np.array(s))
            return _wrap_like(weight, t.to(dev, copy=True))
        self.states[index] = conv(self.states[index])
        self.states_synced[index] = True

    def update_batch(self, indices, grads, weights):
        """Per-index loop; ``FusedUpdater`` runs the kernel path."""
        for i, g, w in zip(indices, grads, weights):
            self(i, g, w)

    def get_states(self, dump_optimizer=False):
        """The states pickled as ``{index: numpy array, tuple of them or
        None}``, the JAX package's format (a multi-precision entry is
        ``(momentum, fp32 master)``); with ``dump_optimizer`` the pair
        ``(states, optimizer)``, as the JAX package writes it, so a
        reload resumes the update counts and the scheduler."""
        states = {k: _state_to_numpy(v) for k, v in self.states.items()}
        if not dump_optimizer:
            return pickle.dumps(states)
        buf = io.BytesIO()
        _CounterpartPickler(buf, protocol=2).dump((states, self.optimizer))
        return buf.getvalue()

    def set_states(self, states):
        """Load states written by ``get_states`` of either package. A
        dumped optimizer (``dump_optimizer=True``: the JAX package's
        ``gluon.Trainer.save_states`` writes one) is read through stubs,
        never imported: this updater keeps its own optimizer and adopts
        the dumped one's ``num_update``, per-index update counts and
        learning-rate scheduler position. Unpickles: pass only bytes one
        of the two packages wrote."""
        states = _StatesUnpickler(io.BytesIO(states)).load()
        if isinstance(states, tuple) and len(states) == 2:
            states, dumped = states
            self.optimizer._adopt_counts(dumped)
        self.states = states
        self.states_synced = {k: False for k in self.states}


def _make_batch_update(kname, statics, mp, inner_n):
    """The whole-parameter-set update ``(ws, states, gs, lrs, wds, ts) ->
    (new_ws, new_states)`` applying one pure kernel per parameter (parity:
    ``optimizer._make_batch_update``). ``mp[i]`` marks multi-precision
    entries whose state tuple ends with the fp32 master; ``inner_n[i]`` is
    the kernel-owned state count."""
    from .parallel.opt_kernels import get_kernel
    _, update_fn = get_kernel(kname)

    def step(ws, states, gs, lrs, wds, ts):
        new_ws, new_states = [], []
        for i in range(len(mp)):
            w, s, g = ws[i], states[i], gs[i]
            h = dict(statics)
            h["lr"], h["wd"] = lrs[i], wds[i]
            if mp[i]:
                p = s[-1]                       # fp32 master
                inner = s[:-1]
                p_new, inner_new = update_fn(p, g.to(p.dtype), inner, ts[i],
                                             h)
                new_ws.append(p_new.to(w.dtype))
                new_states.append(tuple(
                    x.to(o.dtype) for x, o in zip(inner_new[:inner_n[i]],
                                                  inner)) + (p_new,))
            else:
                w_new, s_new = update_fn(w, g, s, ts[i], h)
                new_ws.append(w_new.to(w.dtype))
                new_states.append(tuple(
                    x.to(o.dtype) for x, o in zip(s_new[:inner_n[i]], s)))
        return new_ws, new_states

    return step


class FusedUpdater(Updater):
    """Updater whose ``update_batch`` applies the optimizer's pure kernel
    (``parallel/opt_kernels.py``) to a whole parameter set, the same
    arithmetic for the phase-split ``Module.update`` and the fused batch
    step (parity: ``optimizer.FusedUpdater``). Here it is an eager loop
    over the parameters, writing in place; one captured CUDA graph for
    it is later work. Falls back to the per-index ``Updater`` path when
    the optimizer has no kernel or a state layout does not fit one."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self._mp_flags = {}

    def set_states(self, states):
        super().set_states(states)
        self._mp_flags.clear()

    def _is_mp(self, index, weight):
        if index not in self._mp_flags:
            self._mp_flags[index] = bool(
                self.optimizer.multi_precision
                and _raw(weight).dtype in _LOW_PRECISION)
        return self._mp_flags[index]

    @staticmethod
    def _pack_state(state):
        """A state as a flat tuple of NDArrays, or None when the layout
        does not fit a kernel."""
        from .ndarray.ndarray import NDArray
        if state is None:
            return ()
        if isinstance(state, NDArray):
            return (state,)
        if isinstance(state, tuple) and all(isinstance(x, NDArray)
                                            for x in state):
            return tuple(state)
        return None

    def _gather_batch(self, kname, indices, weights):
        """``(packed, mp, inner_n)`` for a kernel step, creating or syncing
        states as needed, or ``(None, None, None)`` when an entry's layout
        cannot ride the kernel."""
        packed, mp, inner_n = [], [], []
        for i, w in zip(indices, weights):
            st = self._ensure_state(i, w)
            is_mp = self._is_mp(i, w)
            if is_mp:
                inner, w32 = st
                tup = self._pack_state(inner)
                tup = tup + (w32,) if tup is not None else None
            else:
                tup = self._pack_state(st)
            if tup is None or (kname == "nag"
                               and len(tup) == (1 if is_mp else 0)):
                return None, None, None
            packed.append(tup)
            mp.append(is_mp)
            inner_n.append(len(tup) - (1 if is_mp else 0))
        return packed, mp, inner_n

    def update_batch(self, indices, grads, weights):
        """One optimizer step over parallel lists of (index, grad, weight)
        NDArrays (or raw gradient tensors)."""
        from .parallel import opt_kernels as _ok
        from .ndarray.sparse import BaseSparseNDArray
        opt = self.optimizer
        if any(isinstance(g, BaseSparseNDArray) for g in grads):
            # a sparse gradient takes its optimizer's lazy update
            return Updater.update_batch(self, indices, grads, weights)
        try:
            kname, hyper = _ok.hyper_from_optimizer(opt)
        except MXNetError:
            return Updater.update_batch(self, indices, grads, weights)
        packed, mp, inner_n = self._gather_batch(kname, indices, weights)
        if packed is None:
            return Updater.update_batch(self, indices, grads, weights)
        # host bookkeeping as the per-index path does it: update counts
        # first, then the scheduler-aware lr/wd of each index
        for i in indices:
            opt._update_count(i)
        ts = [opt._index_update_count[i] for i in indices]
        lrs = [opt._get_lr(i) for i in indices]
        wds = [opt._get_wd(i) for i in indices]
        statics = {k: v for k, v in hyper.items() if k not in ("lr", "wd")}
        step = _make_batch_update(kname, statics, mp, inner_n)
        with torch.no_grad():
            new_ws, new_states = step(
                [_raw(w) for w in weights],
                [tuple(_raw(x) for x in tup) for tup in packed],
                [_raw(g) for g in grads], lrs, wds, ts)
            for w, tup, nw, ntup in zip(weights, packed, new_ws, new_states):
                _raw(w).copy_(nw)
                for x, nx in zip(tup, ntup):
                    _raw(x).copy_(nx)


def get_updater(optimizer):
    return FusedUpdater(optimizer)
