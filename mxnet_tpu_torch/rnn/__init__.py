"""Symbolic recurrent cells, bucketed sequence IO and RNN checkpoints.

Counterpart of ``mxnet_tpu/rnn`` (parity: python/mxnet/rnn/): the
symbolic cells, ``BucketSentenceIter``/``encode_sentences``, the
checkpoint helpers, and ``rnn_cell.lstm_decode_step`` for the decode
engine, and the convolutional cells (``ConvRNNCell``, ``ConvLSTMCell``,
``ConvGRUCell``, ``BaseConvRNNCell``).
"""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,  # noqa: F401
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell, RNNParams,
                       ModifierCell, BaseConvRNNCell, ConvRNNCell,
                       ConvLSTMCell, ConvGRUCell, lstm_decode_step)
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,  # noqa: F401
                  do_rnn_checkpoint)
