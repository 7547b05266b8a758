"""``mx.sym.contrib`` (counterpart of ``mxnet_tpu/symbol/contrib.py``;
parity: python/mxnet/symbol/contrib.py): every ``_contrib_*`` op under
its short name and its full name."""
from __future__ import annotations

from ..ops import registry as _registry
from . import register as _register

for _name in _registry.list_ops():
    if _name.startswith("_contrib_"):
        _op = _registry.get_op(_name)
        globals()[_name[len("_contrib_"):]] = _register.make_sym_func(_op)
        globals()[_name] = _register.make_sym_func(_op)
