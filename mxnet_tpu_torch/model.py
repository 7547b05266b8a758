"""Model helpers: checkpoints and the batch-end callback record.

Counterpart of ``mxnet_tpu/model.py`` (``save_checkpoint``,
``load_checkpoint``, ``BatchEndParam``, ``_create_kvstore``) with the same
file formats: ``prefix-symbol.json`` (the reference's node-list JSON) and
``prefix-NNNN.params`` (``arg:``/``aux:``-prefixed arrays in the NPZ
container of ``nd.save``), so either package loads the other's
checkpoints. Each file is written to a temporary name and renamed into
place. The legacy ``FeedForward`` API is not ported.
"""
from __future__ import annotations

import os
from collections import namedtuple

from .base import MXNetError
from . import symbol as sym
from .ndarray import save as _nd_save, load as _nd_load

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device):
    """(kvstore, update_on_kvstore) for one device: ``None`` and a
    non-``dist`` type name mean no store (the reference's single-device
    rule); a store object or a ``dist*`` type waits for the distributed
    slice."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return None, False
    raise MXNetError("kvstore %r: kvstores and multi-device training are "
                     "not ported yet (ROADMAP Queue 1 item 4)" % (kvstore,))


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
