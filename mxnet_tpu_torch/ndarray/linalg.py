"""``mx.nd.linalg`` (counterpart of ``mxnet_tpu/ndarray/linalg.py``;
parity: python/mxnet/ndarray/linalg.py): the ``_linalg_*`` ops under
their short names."""
from __future__ import annotations

from .. import imperative as _imp
from ..ops import registry as _registry


def _make(name):
    op = _registry.get_op("_linalg_" + name)

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        return _imp.invoke(op, list(args), kwargs, out=out)
    fn.__name__ = name
    fn.__doc__ = op.doc
    return fn


gemm = _make("gemm")
gemm2 = _make("gemm2")
potrf = _make("potrf")
potri = _make("potri")
trmm = _make("trmm")
trsm = _make("trsm")
sumlogdiag = _make("sumlogdiag")
syrk = _make("syrk")
