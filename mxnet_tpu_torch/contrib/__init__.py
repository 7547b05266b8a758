"""The experimental contrib namespace (counterpart of
``mxnet_tpu/contrib``; parity: python/mxnet/contrib/): the older autograd
spelling, the TensorBoard metric callback, and ``ndarray``/``symbol`` as
``mx.nd.contrib``/``mx.sym.contrib``."""
from . import autograd  # noqa: F401
from . import tensorboard  # noqa: F401
from ..ndarray import contrib as ndarray  # noqa: F401
from ..symbol import contrib as symbol  # noqa: F401
