"""Gluon contrib namespace (counterpart of ``mxnet_tpu/gluon/contrib``;
parity: python/mxnet/gluon/contrib/)."""
from . import rnn  # noqa: F401
