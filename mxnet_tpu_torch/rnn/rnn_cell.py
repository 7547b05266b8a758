"""RNN cells: the decode path's single LSTM step.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py:lstm_decode_step``.
"""
from __future__ import annotations

import torch

__all__ = ["lstm_decode_step"]


def lstm_decode_step(x, h, c, wx, wh, b):
    """One LSTM step, batched over any leading dims. Same gate packing as
    the symbolic ``LSTMCell``: the fused (..., 4H) projection splits into
    the in, forget, transform and out gates.

    ``x`` (..., E) input, ``h``/``c`` (..., H) carried state,
    ``wx`` (E, 4H), ``wh`` (H, 4H), ``b`` (4H,).
    Returns ``(next_h, next_c)``.
    """
    gates = x @ wx + h @ wh + b
    in_g, forget_g, transform, out_g = torch.chunk(gates, 4, dim=-1)
    in_g = torch.sigmoid(in_g)
    forget_g = torch.sigmoid(forget_g)
    out_g = torch.sigmoid(out_g)
    next_c = forget_g * c + in_g * torch.tanh(transform)
    next_h = out_g * torch.tanh(next_c)
    return next_h, next_c
