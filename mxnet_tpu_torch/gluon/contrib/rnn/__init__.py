"""Contrib recurrent building blocks (counterpart of
``mxnet_tpu/gluon/contrib/rnn``; parity: gluon/contrib/rnn/)."""
from .conv_rnn_cell import *   # noqa: F401,F403
from .rnn_cell import *        # noqa: F401,F403
from .conv_rnn_cell import __all__ as _conv_all
from .rnn_cell import __all__ as _cell_all

__all__ = list(_conv_all) + list(_cell_all)
