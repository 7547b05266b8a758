"""RNN checkpoint helpers (parity: python/mxnet/rnn/rnn.py).

Counterpart of ``mxnet_tpu/rnn/rnn.py``: a fused cell's packed vector
and its unfused arrays are saved as they are (no repacking), as in the
JAX package.
"""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """(parity: rnn.save_rnn_checkpoint)"""
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch, ctx=None):
    """(parity: rnn.load_rnn_checkpoint) ``(symbol, arg_params,
    aux_params)``, the arrays on ``ctx`` (default: the current
    context)."""
    return load_checkpoint(prefix, epoch, ctx=ctx)


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback saving every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
