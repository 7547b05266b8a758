"""Fused gluon RNN layers (RNN / LSTM / GRU).

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (parity: reference
``gluon/rnn/rnn_layer.py``): per-layer parameters with the reference's
names (``l0_i2h_weight``, ``l0_r_h2h_bias``, ...), packed in
``hybrid_forward`` by ``Reshape`` + ``Concat`` into the fused ``RNN``
op's flat vector (layout in ``ops/rnn.py``), which runs ATen's fused RNN
(cuDNN on the card). Eager or hybridized, with or without states; TNC
or NTC.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops.rnn import _GATES
from ..block import HybridBlock
from ..parameter import _first_ctx

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, prefix=None, params=None,
                 **kwargs):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("layout must be TNC or NTC")
        with self.name_scope():
            self._hidden_size = hidden_size
            self._num_layers = num_layers
            self._layout = layout
            self._dropout = dropout
            self._dir = 2 if bidirectional else 1
            self._input_size = input_size
            self._mode = mode
            ng = _GATES[mode]
            self._param_names = []
            for layer in range(num_layers):
                in_sz = input_size if layer == 0 else \
                    hidden_size * self._dir
                for d in range(self._dir):
                    suffix = "" if d == 0 else "_r"
                    for kind, shape in [
                            ("i2h_weight", (ng * hidden_size, in_sz)),
                            ("h2h_weight", (ng * hidden_size, hidden_size)),
                            ("i2h_bias", (ng * hidden_size,)),
                            ("h2h_bias", (ng * hidden_size,))]:
                        name = "l%d%s_%s" % (layer, suffix, kind)
                        p = self.params.get(name, shape=shape,
                                            allow_deferred_init=True)
                        setattr(self, name, p)
                        self._param_names.append(name)

    def _shape_hook(self, x, *args):
        in_sz = x.shape[-1]
        self._input_size = in_sz
        ng = _GATES[self._mode]
        H = self._hidden_size
        for d in range(self._dir):
            suffix = "" if d == 0 else "_r"
            getattr(self, "l0%s_i2h_weight" % suffix)._update_shape(
                (ng * H, in_sz))

    def state_info(self, batch_size=0):
        num = self._num_layers * self._dir
        info = [{"shape": (num, batch_size, self._hidden_size),
                 "__layout__": "LNC"}]
        if self._mode == "lstm":
            info.append({"shape": (num, batch_size, self._hidden_size),
                         "__layout__": "LNC"})
        return info

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (parity: rnn_layer.begin_state), on the context of
        the layer's parameters unless ``ctx`` is given."""
        from ... import ndarray as F
        func = func or F.zeros
        if "ctx" not in kwargs:
            ctx = _first_ctx(self.collect_params())
            if ctx is not None:
                kwargs["ctx"] = ctx
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def __call__(self, inputs, states=None):
        if states is None:
            batch = inputs.shape[self._layout.find("N")]
            states = self.begin_state(batch, ctx=inputs.context)
            skip_states = True
        else:
            skip_states = False
            if not isinstance(states, (list, tuple)):
                states = [states]
        out = super().__call__(inputs, *states)
        if skip_states:
            return out[0] if isinstance(out, (list, tuple)) else out
        if not isinstance(out, (list, tuple)):
            return out, []
        return out[0], list(out[1:])

    def hybrid_forward(self, F, inputs, *states, **params):
        flat = [F.Reshape(params[name], shape=(-1,))
                for name in self._param_names]
        parameters = F.Concat(*flat, dim=0) if len(flat) > 1 else flat[0]
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        outs = F.RNN(inputs, parameters, *states,
                     state_size=self._hidden_size,
                     num_layers=self._num_layers, mode=self._mode,
                     bidirectional=self._dir == 2, p=self._dropout,
                     state_outputs=True)
        if not isinstance(outs, (list, tuple)):     # a grouped Symbol
            outs = list(outs)
        output = outs[0]
        if self._layout == "NTC":
            output = F.swapaxes(output, dim1=0, dim2=1)
        return [output] + list(outs[1:])

    def __repr__(self):
        return "%s(%s, %d, layers=%d)" % (type(self).__name__, self._mode,
                                          self._hidden_size, self._num_layers)


class RNN(_RNNLayer):
    """(parity: gluon.rnn.RNN)"""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """(parity: gluon.rnn.LSTM)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """(parity: gluon.rnn.GRU)"""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
