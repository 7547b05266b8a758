"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py``: ``step`` rescales the
gradients by ``1/batch_size`` (the JAX package's ``rescale_grad``) and
applies the optimizer to every parameter whose ``grad_req`` is not
``'null'`` in one ``FusedUpdater.update_batch`` (the loop ``Module``'s
fused step runs), writing the weights and states in place. The kvstore
follows ``model._create_kvstore``: ``None`` and the in-process type
names mean no store on one device; a store object or a ``dist*`` name
gets every parameter and, under ``update_on_kvstore``, the optimizer.
The live parameters then go through the store as one key list (the JAX
Trainer pushes key by key), so the store's updater runs ``update_batch``
as ``Module.update`` does: push the gradients and pull the weights. A
``dist*`` store sums the pushed gradients over the worker processes in
one collective per step; it takes the parameters at construction when
they have their shapes (at the first step otherwise) and every worker
starts from rank 0's values. ``batch_size`` is the batch whose gradient
the workers' summed push holds: the global batch, for the result of one
process at that batch. ``compression_params`` goes to the store.
``save_states`` writes the optimizer beside its states
(``dump_optimizer=True``), and ``load_states`` resumes its update counts
and scheduler.
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
        self._kvstore, self._update_on_kvstore = _create_kvstore(
            kvstore, 1, {p.name: p for p in self._params})
        if self._kvstore is not None and compression_params:
            self._kvstore.set_gradient_compression(compression_params)
        self._kv_initialized = False
        if self._kvstore is not None and self._kvstore.type.startswith(
                "dist") and all(p._data is not None for p in self._params):
            # seed every worker from rank 0 before the first forward; a
            # deferred parameter waits for the first step
            self._init_kvstore()

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
        """(parity: trainer._init_kvstore) every parameter into the store
        by index, and the optimizer under ``update_on_kvstore``."""
        kv = self._kvstore
        if kv is not None:
            for i, param in enumerate(self._params):
                kv.init(i, param.data())
            if kv.type.startswith("dist"):
                # rank 0's values seeded the store: every worker trains
                # from them (a BatchNorm's running stats, never pushed,
                # stay each worker's own, as in the JAX package)
                keys, _, weights = self._live()
                if keys:
                    kv.pull(keys, out=weights)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step, the gradients normalised by
        ``batch_size`` (parity: trainer.step)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients through the store (when it does not update
        the weights itself)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _live(self):
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        return ([i for i, _ in live], [p.grad() for _, p in live],
                [p.data() for _, p in live])

    def _allreduce_grads(self):
        if self._kvstore is None or self._update_on_kvstore:
            return
        keys, grads, _ = self._live()
        if keys:
            self._kvstore.push(keys, grads)
            self._kvstore.pull(keys, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step of ``step`` without the all-reduce."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        keys, grads, weights = self._live()
        if not keys:
            return
        if self._update_on_kvstore:
            self._kvstore.push(keys, grads)
            self._kvstore.pull(keys, out=weights)
        else:
            self._updaters.update_batch(keys, grads, weights)

    def save_states(self, fname):
        """The optimizer states with the optimizer beside them (the
        store's under ``update_on_kvstore``), pickled as the JAX package
        writes them (``dump_optimizer=True``), so a reload resumes the
        update counts and the scheduler."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        from ..checkpoint import atomic_write
        atomic_write(fname, self._updaters.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """States written by ``save_states`` of either package; the
        dumped optimizer's update counts and scheduler position are
        adopted by this Trainer's optimizer."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updaters.set_states(f.read())
