"""``mx.sym.sparse`` — the symbolic sparse-op namespace.

Counterpart of ``mxnet_tpu/symbol/sparse.py`` (parity: reference
``python/mxnet/symbol/sparse.py``). Symbolic graphs run on dense
tensors, so these are the ops of ``mx.sym`` under their sparse names,
with dense storage: the reference executor's storage fallback for an op
without a sparse kernel, logged once. The sparse execution paths
(row_sparse gradients, lazy optimizer updates, ``row_sparse_pull``) are
imperative, in ``mx.nd.sparse`` and the stores.
"""
import sys as _sys

from .. import log as _log

_PARENT = _sys.modules[__package__]

_logged = False


def _fallback(name):
    fn = getattr(_PARENT, name)

    def wrapped(*args, **kwargs):
        global _logged
        if not _logged:
            _log.get_logger("sparse").debug(
                "sym.sparse.%s: executing with dense storage (fallback)",
                name)
            _logged = True
        return fn(*args, **kwargs)
    wrapped.__name__ = name
    wrapped.__doc__ = ("Dense-fallback symbolic version of ``%s`` "
                       "(see module docstring)." % name)
    return wrapped


for _name in ["dot", "elemwise_add", "elemwise_sub", "elemwise_mul",
              "add_n", "zeros_like", "square", "sqrt", "abs", "sign",
              "negative", "broadcast_add", "broadcast_mul", "broadcast_div",
              "broadcast_sub", "sum", "mean", "norm", "cast_storage",
              "where", "retain", "Embedding", "LinearRegressionOutput",
              "FullyConnected", "sgd_update", "sgd_mom_update",
              "adam_update"]:
    if hasattr(_PARENT, _name):
        globals()[_name] = _fallback(_name)
