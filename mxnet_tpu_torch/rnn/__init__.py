"""Recurrent cells.

Counterpart of ``mxnet_tpu/rnn``. So far only ``rnn_cell.lstm_decode_step``,
the single LSTM step of the decode engine's ``LSTMDecodeCell``; the
symbolic cells (``RNNCell`` ... ``ConvGRUCell``) are still to be ported
(ROADMAP queue 1, item 7).
"""
from .rnn_cell import lstm_decode_step  # noqa: F401
