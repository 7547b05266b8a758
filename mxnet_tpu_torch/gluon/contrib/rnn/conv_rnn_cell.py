"""Convolutional recurrent cells for Gluon.

Counterpart of ``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py`` (parity:
reference ``python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py``): the
1/2/3-D Conv{RNN,LSTM,GRU}Cell families. The recurrence replaces the
dense i2h/h2h projections with convolutions over the spatial dims, so
states are feature maps ``(batch, channels, *spatial)`` (channels last
under an ``N...C`` ``conv_layout``). The h2h padding is derived from its
kernel and dilation so that the state's spatial shape is kept from step
to step, which is why ``h2h_kernel`` must be odd. Each convolution is
PyTorch's own (cuDNN on the card); a channels-last layout keeps its
tensors NHWC and hands cuDNN ``channels_last`` views
(``ops/nn.py``'s ``Convolution``).
"""
from ...rnn import HybridRecurrentCell
from ...rnn.rnn_cell import _maybe_init

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuple(v, ndim, what):
    if isinstance(v, int):
        return (v,) * ndim
    v = tuple(v)
    if len(v) != ndim:
        raise ValueError("%s must have %d elements, got %r"
                         % (what, ndim, v))
    return v


def _conv_out(size, kernel, pad, dilate):
    return tuple(s + 2 * p - d * (k - 1)
                 for s, k, p, d in zip(size, kernel, pad, dilate))


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared machinery: gate convs over input and state."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        if len(self._input_shape) != dims + 1:
            raise ValueError(
                "input_shape must have %d elements (channels + %d spatial"
                " dims), got %r" % (dims + 1, dims, self._input_shape))
        self._conv_layout = conv_layout
        self._channel_axis = conv_layout.find("C")
        self._activation = activation
        self._dims = dims
        self._i2h_kernel = _tuple(i2h_kernel, dims, "i2h_kernel")
        self._h2h_kernel = _tuple(h2h_kernel, dims, "h2h_kernel")
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    "h2h_kernel must be odd so the state's spatial shape "
                    "is preserved; got %r" % (self._h2h_kernel,))
        self._i2h_pad = _tuple(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tuple(i2h_dilate, dims, "i2h_dilate")
        self._h2h_dilate = _tuple(h2h_dilate, dims, "h2h_dilate")
        # SAME padding for the recurrent conv
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        if self._channel_axis == 1:          # NC[spatial]
            in_ch = self._input_shape[0]
            spatial = self._input_shape[1:]
        else:                                # N[spatial]C (channels-last)
            in_ch = self._input_shape[-1]
            spatial = self._input_shape[:-1]
        out_spatial = _conv_out(spatial, self._i2h_kernel, self._i2h_pad,
                                self._i2h_dilate)
        if self._channel_axis == 1:
            self._state_shape = (hidden_channels,) + out_spatial
        else:
            self._state_shape = out_spatial + (hidden_channels,)
        ng = self._num_gates
        if self._channel_axis == 1:
            i2h_wshape = (ng * hidden_channels, in_ch) + self._i2h_kernel
            h2h_wshape = (ng * hidden_channels,
                          hidden_channels) + self._h2h_kernel
        else:   # channels-last weights are O+spatial+I (ops/nn.py)
            i2h_wshape = (ng * hidden_channels,) + self._i2h_kernel \
                + (in_ch,)
            h2h_wshape = (ng * hidden_channels,) + self._h2h_kernel \
                + (hidden_channels,)
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=i2h_wshape,
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=h2h_wshape,
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_channels,),
                init=_maybe_init(i2h_bias_initializer))
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_channels,),
                init=_maybe_init(h2h_bias_initializer))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._conv_layout}]

    def _conv_gates(self, F, inputs, state, i2h_weight, h2h_weight,
                    i2h_bias, h2h_bias):
        ng = self._num_gates
        layout = self._conv_layout if self._channel_axis != 1 else None
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate, layout=layout,
                            num_filter=ng * self._hidden_channels)
        h2h = F.Convolution(state, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate, layout=layout,
                            num_filter=ng * self._hidden_channels)
        return i2h, h2h

    def _split_gates(self, F, gates, num):
        return F.SliceChannel(gates, num_outputs=num,
                              axis=self._channel_axis)

    def _act(self, F, x):
        if self._activation in ("tanh", "relu", "sigmoid", "softsign"):
            return F.Activation(x, act_type=self._activation)
        return getattr(F, self._activation)(x)


class _ConvRNNCell(_BaseConvRNNCell):
    _num_gates = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        out = self._act(F, i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _num_gates = 4    # i, f, c, o — the reference/cudnn gate order

    def _alias(self):
        return "conv_lstm"

    def state_info(self, batch_size=0):
        info = super().state_info(batch_size)
        return info + [dict(info[0])]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_gates(F, inputs, states[0], i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        sl = self._split_gates(F, gates, 4)
        in_gate = F.sigmoid(sl[0])
        forget_gate = F.sigmoid(sl[1])
        in_transform = self._act(F, sl[2])
        out_gate = F.sigmoid(sl[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._act(F, next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    _num_gates = 3    # r, z, n

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev = states[0]
        i2h, h2h = self._conv_gates(F, inputs, prev, i2h_weight,
                                    h2h_weight, i2h_bias, h2h_bias)
        i2h_s = self._split_gates(F, i2h, 3)
        h2h_s = self._split_gates(F, h2h, 3)
        reset = F.sigmoid(i2h_s[0] + h2h_s[0])
        update = F.sigmoid(i2h_s[1] + h2h_s[1])
        cand = self._act(F, i2h_s[2] + reset * h2h_s[2])
        next_h = (1 - update) * cand + update * prev
        return next_h, [next_h]


def _make(cell_base, dims, alias_doc):
    """Build the public N-D class over a gate family base."""

    class Cell(cell_base):
        __doc__ = alias_doc

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros",
                     conv_layout=None, activation="tanh",
                     prefix=None, params=None):
            layouts = {1: "NCW", 2: "NCHW", 3: "NCDHW"}
            super().__init__(
                input_shape=input_shape,
                hidden_channels=hidden_channels,
                i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                i2h_pad=i2h_pad, i2h_dilate=i2h_dilate,
                h2h_dilate=h2h_dilate,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer,
                dims=dims, conv_layout=conv_layout or layouts[dims],
                activation=activation, prefix=prefix, params=params)

    return Cell


_DOC = ("(parity: gluon.contrib.rnn.%s — convolutional %s recurrence "
        "over %d spatial dim%s)")

Conv1DRNNCell = _make(_ConvRNNCell, 1,
                      _DOC % ("Conv1DRNNCell", "RNN", 1, ""))
Conv2DRNNCell = _make(_ConvRNNCell, 2,
                      _DOC % ("Conv2DRNNCell", "RNN", 2, "s"))
Conv3DRNNCell = _make(_ConvRNNCell, 3,
                      _DOC % ("Conv3DRNNCell", "RNN", 3, "s"))
Conv1DLSTMCell = _make(_ConvLSTMCell, 1,
                       _DOC % ("Conv1DLSTMCell", "LSTM", 1, ""))
Conv2DLSTMCell = _make(_ConvLSTMCell, 2,
                       _DOC % ("Conv2DLSTMCell", "LSTM", 2, "s"))
Conv3DLSTMCell = _make(_ConvLSTMCell, 3,
                       _DOC % ("Conv3DLSTMCell", "LSTM", 3, "s"))
Conv1DGRUCell = _make(_ConvGRUCell, 1,
                      _DOC % ("Conv1DGRUCell", "GRU", 1, ""))
Conv2DGRUCell = _make(_ConvGRUCell, 2,
                      _DOC % ("Conv2DGRUCell", "GRU", 2, "s"))
Conv3DGRUCell = _make(_ConvGRUCell, 3,
                      _DOC % ("Conv3DGRUCell", "GRU", 3, "s"))

for _name in __all__:
    globals()[_name].__name__ = _name
    globals()[_name].__qualname__ = _name
