"""Model helpers: checkpoints and the batch-end callback record.

Counterpart of ``mxnet_tpu/model.py`` (``save_checkpoint``,
``load_checkpoint``, ``BatchEndParam``, ``_create_kvstore``) with the same
file formats: ``prefix-symbol.json`` (the reference's node-list JSON) and
``prefix-NNNN.params`` (``arg:``/``aux:``-prefixed arrays in the NPZ
container of ``nd.save``), so either package loads the other's
checkpoints. Each file is written to a temporary name and renamed into
place. ``FeedForward``, the legacy training API, is a wrapper over
``Module``, as in the JAX package.
"""
from __future__ import annotations

import os
from collections import namedtuple

import numpy as np

from .base import MXNetError
from . import symbol as sym
from .ndarray import save as _nd_save, load as _nd_load

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(parity: model._create_kvstore) -> (kvstore, update_on_kvstore):
    a store object is used as given; a type name on one device without
    ``dist`` means no store; a created ``local`` store leaves the update
    to the caller when a parameter has more than 16M elements."""
    from . import kvstore as kvs
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max((int(np.prod(p.shape or ()))
                                for p in arg_params.values()), default=0)
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str, or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _replace_into(path, write):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """(parity: model.save_checkpoint) ``prefix-symbol.json`` (when
    ``symbol`` is given) and ``prefix-%04d.params``."""
    if symbol is not None:
        _replace_into("%s-symbol.json" % prefix, symbol.save)
    blob = {("arg:%s" % k): v for k, v in arg_params.items()}
    blob.update({("aux:%s" % k): v for k, v in aux_params.items()})
    _replace_into("%s-%04d.params" % (prefix, epoch),
                  lambda f: _nd_save(f, blob))


def load_checkpoint(prefix, epoch, ctx=None):
    """(parity: model.load_checkpoint) -> (symbol, arg_params,
    aux_params), the arrays on ``ctx`` (default: the current context)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    blob = _nd_load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in blob.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError("invalid parameter key %r in %s-%04d.params"
                             % (k, prefix, epoch))
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API (parity: model.FeedForward), a wrapper over
    ``mx.mod.Module`` as in the JAX package: ``fit``, ``predict``,
    ``score``, ``save``, ``load`` and ``create``. Numpy inputs become an
    ``NDArrayIter`` of ``numpy_batch_size`` (shuffled for ``fit``)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=shuffle)

    def _ensure_module(self, data_iter):
        from .module import Module
        if self._module is None:
            label_names = [d.name for d in (data_iter.provide_label or [])] \
                or None
            self._module = Module(
                self.symbol, data_names=[d.name for d in
                                         data_iter.provide_data],
                label_names=label_names, context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs from ``begin_epoch``; a partial
        ``arg_params`` is completed by the initializer, and with
        ``allow_extra_params`` names the symbol lacks are dropped."""
        train = self._as_iter(X, y, shuffle=True)
        mod = self._ensure_module(train)
        arg_params = self.arg_params
        if arg_params and self.allow_extra_params:
            valid = set(self.symbol.list_arguments())
            arg_params = {k: v for k, v in arg_params.items() if k in valid}
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=dict(self.kwargs),
                initializer=self.initializer,
                arg_params=arg_params, aux_params=self.aux_params,
                allow_missing=arg_params is not None,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1, monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _bound_module(self, data):
        mod = self._ensure_module(data)
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {})
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy (padding rows trimmed)."""
        data = self._as_iter(X)
        mod = self._bound_module(data)
        if reset:
            data.reset()
        outs = mod.predict(data, num_batch=num_batch,
                           always_output_list=True)
        res = [o.asnumpy() for o in outs]
        return res[0] if len(res) == 1 else res

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = self._as_iter(X)
        mod = self._bound_module(data)
        if reset:
            data.reset()
        res = mod.score(data, eval_metric, num_batch=num_batch,
                        batch_end_callback=batch_end_callback)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(
            prefix, epoch, ctx=ctx[0] if isinstance(ctx, (list, tuple))
            else ctx)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
