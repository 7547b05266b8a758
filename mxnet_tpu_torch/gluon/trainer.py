"""Gluon Trainer on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py``: ``step`` rescales the
gradients by ``1/batch_size`` and applies the optimizer to every
parameter whose ``grad_req`` is not ``'null'`` in one
``FusedUpdater.update_batch`` (the loop ``Module``'s fused step runs),
writing the weights and states in place. With one device the kvstore
types ``None``, ``'local'`` and ``'device'`` mean no store, as in the
JAX package (``model._create_kvstore``); a ``dist*`` store waits for the
distributed slice (ROADMAP Queue 1 item 4) and raises.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


class Trainer:
    """(parity: gluon.Trainer)"""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/list of "
                             "Parameters")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise MXNetError("invalid parameter %r" % (param,))
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_type = kvstore
        self._init_kvstore()        # a dist* store raises here

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params and set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = opt.get_updater(self._optimizer)

    def _init_kvstore(self):
        """(parity: trainer._init_kvstore) one device: no store."""
        self._kvstore, self._update_on_kvstore = _create_kvstore(
            self._kvstore_type, 1)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step, the gradients normalised by
        ``batch_size`` (parity: trainer.step)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients across devices: with one device, nothing."""
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One device and no store: the gradients are already whole."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step of ``step`` without the all-reduce."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        self._updaters.update_batch([i for i, _ in live],
                                    [p.grad() for _, p in live],
                                    [p.data() for _, p in live])

    def save_states(self, fname):
        """The optimizer states, pickled in the JAX package's format."""
        with open(fname, "wb") as f:
            f.write(self._updaters.get_states())

    def load_states(self, fname):
        """States written by ``save_states`` of either package."""
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
