"""Symbolic RNN cells, and the decode path's single LSTM step.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (parity: reference
``python/mxnet/rnn/rnn_cell.py``): Symbol-graph cells (``RNNParams``,
``BaseRNNCell.unroll``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``FusedRNNCell`` over the fused ``RNN`` op with ``unfuse`` and
``pack_weights``/``unpack_weights``, ``SequentialRNNCell``,
``DropoutCell``, ``ZoneoutCell``, ``ResidualCell``,
``BidirectionalCell``), as the bucketing LSTM example builds them, the
convolutional cells (``BaseConvRNNCell``, ``ConvRNNCell``,
``ConvLSTMCell``, ``ConvGRUCell``: ``Convolution`` gates, the state's
shape probed with a ``Convolution``'s shape inference), and
``lstm_decode_step`` for ``decode.LSTMDecodeCell``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .. import symbol as sym_mod
from ..ops.rnn import _GATES, rnn_param_size
from ..symbol import Symbol, Variable

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "RNNParams", "ModifierCell",
           "BaseConvRNNCell", "ConvRNNCell", "ConvLSTMCell", "ConvGRUCell",
           "lstm_decode_step"]


class RNNParams:
    """(parity: rnn_cell.RNNParams) — shared weight container."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """(parity: rnn_cell.BaseRNNCell)"""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, **kwargs):
        if func is None:
            func = sym_mod.zeros
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                info = dict(info)
                shape = info.pop("shape", None)
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             shape=shape, **kwargs)
            else:
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                        self._init_counter),
                             **kwargs)
            states.append(state)
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError

    def _symbolic_begin_state(self, ref, reduce_axes):
        """Default zero states whose batch dim comes from ``ref``.

        The reference writes ``sym.zeros(shape=(0, H))`` and relies on
        MXNet's 0=unknown bidirectional shape inference; forward-only
        inference (``meta`` tensors) cannot see through that, so, as in
        the JAX package, the unknown dim is taken from the input symbol: a
        zeroed batch vector (ref summed over ``reduce_axes``) broadcast
        against a zeros literal."""
        zero_vec = sym_mod.sum(ref * 0, axis=reduce_axes)  # shape (N,)

        def _zeros_from_ref(name=None, shape=None, **kwargs):
            if not shape or 0 not in shape:
                return sym_mod.zeros(name=name, shape=shape, **kwargs)
            shape = tuple(shape)
            i = shape.index(0)
            col = sym_mod.reshape(
                zero_vec, shape=(1,) * i + (-1,) + (1,) * (len(shape) - i - 1))
            base = sym_mod.zeros(shape=tuple(1 if d == 0 else d
                                             for d in shape))
            return sym_mod.broadcast_add(base, col)

        return self.begin_state(func=_zeros_from_ref)

    def _default_begin_state(self, inputs, layout):
        """begin_state for unroll when the caller gave none: symbolic
        inputs get batch-inferred zeros, arrays get plain zeros."""
        if isinstance(inputs, Symbol):
            n_axis = layout.find("N")
            return self._symbolic_begin_state(
                inputs, tuple(i for i in range(3) if i != n_axis))
        if isinstance(inputs, (list, tuple)) and inputs \
                and isinstance(inputs[0], Symbol):
            return self._symbolic_begin_state(inputs[0], (1,))
        return self.begin_state()

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """(parity: BaseRNNCell.unroll)"""
        self.reset()
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self._default_begin_state(inputs, layout)
        if isinstance(inputs, Symbol):
            steps = sym_mod.SliceChannel(inputs, num_outputs=length,
                                         axis=axis, squeeze_axis=True)
            inputs = [steps[i] for i in range(length)]
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs is None or merge_outputs:
            outputs = [sym_mod.expand_dims(o, axis=axis) for o in outputs]
            outputs = sym_mod.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return sym_mod.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """(parity: rnn_cell.RNNCell)"""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym_mod.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                     num_hidden=self._num_hidden,
                                     name="%si2h" % name)
        h2h = sym_mod.FullyConnected(states[0], weight=self._hW,
                                     bias=self._hB,
                                     num_hidden=self._num_hidden,
                                     name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """(parity: rnn_cell.LSTMCell; gates i,f,c,o)"""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym_mod.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                     num_hidden=self._num_hidden * 4,
                                     name="%si2h" % name)
        h2h = sym_mod.FullyConnected(states[0], weight=self._hW,
                                     bias=self._hB,
                                     num_hidden=self._num_hidden * 4,
                                     name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = sym_mod.SliceChannel(gates, num_outputs=4, axis=1,
                                           name="%sslice" % name)
        in_gate = sym_mod.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = sym_mod.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = sym_mod.Activation(slice_gates[2], act_type="tanh")
        out_gate = sym_mod.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym_mod.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """(parity: rnn_cell.GRUCell)"""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = sym_mod.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                     num_hidden=self._num_hidden * 3,
                                     name="%si2h" % name)
        h2h = sym_mod.FullyConnected(prev_h, weight=self._hW, bias=self._hB,
                                     num_hidden=self._num_hidden * 3,
                                     name="%sh2h" % name)
        i2h_s = sym_mod.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = sym_mod.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = sym_mod.Activation(i2h_s[0] + h2h_s[0],
                                        act_type="sigmoid")
        update_gate = sym_mod.Activation(i2h_s[1] + h2h_s[1],
                                         act_type="sigmoid")
        next_h_tmp = sym_mod.Activation(i2h_s[2] + reset_gate * h2h_s[2],
                                        act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer cell over the RNN op (parity:
    rnn_cell.FusedRNNCell, the cuDNN path; layout in ``ops/rnn.py``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._parameter = self.params.get("parameters")
        self._directions = 2 if bidirectional else 1

    @property
    def state_info(self):
        b = self._directions * self._num_layers
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self._default_begin_state(inputs, layout)
        if layout == "NTC":
            inputs = sym_mod.swapaxes(inputs, dim1=0, dim2=1)
        states = begin_state
        rnn_args = dict(state_size=self._num_hidden,
                        num_layers=self._num_layers, mode=self._mode,
                        bidirectional=self._bidirectional, p=self._dropout,
                        state_outputs=self._get_next_state)
        if self._mode == "lstm":
            rnn = sym_mod.RNN(inputs, self._parameter, states[0], states[1],
                              name=self._prefix + "rnn", **rnn_args)
        else:
            rnn = sym_mod.RNN(inputs, self._parameter, states[0],
                              name=self._prefix + "rnn", **rnn_args)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if layout == "NTC":
            outputs = sym_mod.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states

    # -- packed-blob <-> named-parameter views ------------------------------
    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    def _blob_layout(self, input_size):
        """[(name, shape, offset)] of the packed blob (ops/rnn.py layout:
        per layer, per direction: W_ih, W_hh, b_ih, b_hh; per-gate rows)."""
        g = _GATES[self._mode]
        H = self._num_hidden
        gates = self._gate_names
        out = []
        off = 0
        for layer in range(self._num_layers):
            in_sz = input_size if layer == 0 else H * self._directions
            for d in range(self._directions):
                pre = "%s%s%d_" % (self._prefix, "lr"[d], layer)
                for gi in range(g):
                    out.append(("%si2h%s_weight" % (pre, gates[gi]),
                                (H, in_sz), off + gi * H * in_sz))
                off += g * H * in_sz
                for gi in range(g):
                    out.append(("%sh2h%s_weight" % (pre, gates[gi]),
                                (H, H), off + gi * H * H))
                off += g * H * H
                for gi in range(g):
                    out.append(("%si2h%s_bias" % (pre, gates[gi]),
                                (H,), off + gi * H))
                off += g * H
                for gi in range(g):
                    out.append(("%sh2h%s_bias" % (pre, gates[gi]),
                                (H,), off + gi * H))
                off += g * H
        return out, off

    def _infer_input_size(self, blob_size):
        """Solve the packed size equation for input_size (rnn_param_size
        is linear in it)."""
        base = rnn_param_size(0, self._num_hidden, self._num_layers,
                              self._mode, self._bidirectional)
        per_in = _GATES[self._mode] * self._num_hidden * self._directions
        in_sz, rem = divmod(blob_size - base, per_in)
        if rem or in_sz <= 0:
            raise MXNetError("parameter blob size %d does not match this "
                             "cell's configuration" % blob_size)
        return in_sz

    def unpack_weights(self, args):
        """Packed ``parameters`` blob -> per-layer/gate named arrays
        (parity: rnn_cell.FusedRNNCell.unpack_weights); the arrays are
        made on the blob's context."""
        from ..ndarray import array as nd_array
        args = args.copy()
        blob = args.pop("%sparameters" % self._prefix)
        ctx = blob.context
        flat = blob.asnumpy().ravel()
        layout, total = self._blob_layout(self._infer_input_size(flat.size))
        if total != flat.size:
            raise MXNetError("blob size mismatch")
        for name, shape, off in layout:
            n = int(np.prod(shape))
            args[name] = nd_array(flat[off:off + n].reshape(shape), ctx=ctx)
        return args

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        from ..ndarray import array as nd_array
        args = args.copy()
        g = self._gate_names
        probe = "%s%s0_i2h%s_weight" % (self._prefix, "l", g[0])
        in_sz = args[probe].shape[1]
        ctx = args[probe].context
        layout, total = self._blob_layout(in_sz)
        flat = np.zeros(total, np.float32)
        for name, shape, off in layout:
            n = int(np.prod(shape))
            flat[off:off + n] = args.pop(name).asnumpy().ravel()
        args["%sparameters" % self._prefix] = nd_array(flat, ctx=ctx)
        return args

    def unfuse(self):
        """The same network as a ``SequentialRNNCell`` of unfused cells
        (``BidirectionalCell`` pairs when bidirectional, ``DropoutCell``
        between layers), named ``<prefix>l<n>_``/``<prefix>r<n>_``
        (parity: rnn_cell.FusedRNNCell.unfuse)."""
        make = {"rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
                "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
                "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
                "gru": lambda p: GRUCell(self._num_hidden, prefix=p)}[
                    self._mode]
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make("%sl%d_" % (self._prefix, i)),
                    make("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(make("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """(parity: rnn_cell.SequentialRNNCell)"""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        info = []
        for cell in self._cells:
            info.extend(cell.state_info)
        return info

    def begin_state(self, **kwargs):
        states = []
        for cell in self._cells:
            states.extend(cell.begin_state(**kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Step by step, as the JAX package unrolls (its graph and
        argument order); cell by cell, as upstream MXNet does, when a
        ``BidirectionalCell`` (which only unrolls) is in the stack."""
        if not any(isinstance(c, BidirectionalCell) for c in self._cells):
            return super().unroll(length, inputs, begin_state, layout,
                                  merge_outputs)
        self.reset()
        if begin_state is None:
            begin_state = self._default_begin_state(inputs, layout)
        p, next_states = 0, []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            inputs, states = cell.unroll(
                length, inputs, begin_state[p:p + n], layout,
                merge_outputs=None if i < len(self._cells) - 1
                else merge_outputs)
            p += n
            next_states.extend(states)
        return inputs, next_states

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """(parity: rnn_cell.DropoutCell)"""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym_mod.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    def __init__(self, base_cell):
        super().__init__(prefix="", params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def __call__(self, inputs, states):
        output, new_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0:
            mask = sym_mod.Dropout(sym_mod.ones_like(output),
                                   p=self.zoneout_outputs)
            prev = self.prev_output if self.prev_output is not None \
                else sym_mod.zeros_like(output)
            output = sym_mod.where(mask, output, prev)
        if self.zoneout_states > 0:
            new_states = [sym_mod.where(
                sym_mod.Dropout(sym_mod.ones_like(ns), p=self.zoneout_states),
                ns, s) for ns, s in zip(new_states, states)]
        self.prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(BaseRNNCell):
    """(parity: rnn_cell.BidirectionalCell)"""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    @property
    def state_info(self):
        return self._cells[0].state_info + self._cells[1].state_info

    def begin_state(self, **kwargs):
        return (self._cells[0].begin_state(**kwargs)
                + self._cells[1].begin_state(**kwargs))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports only unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self._default_begin_state(inputs, layout)
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_out, l_states = l_cell.unroll(length, inputs, begin_state[:n_l],
                                        layout, merge_outputs=True)
        rev = sym_mod.reverse(inputs, axis=axis)
        r_out, r_states = r_cell.unroll(length, rev, begin_state[n_l:],
                                        layout, merge_outputs=True)
        r_out = sym_mod.reverse(r_out, axis=axis)
        outputs = sym_mod.Concat(l_out, r_out, dim=2,
                                 name="%sout" % self._output_prefix)
        return outputs, l_states + r_states


# ---------------------------------------------------------------------------
# Convolutional RNN cells (counterpart of mxnet_tpu/rnn/rnn_cell.py:548-685;
# parity: the reference's rnn_cell.py:1094-1455)
# ---------------------------------------------------------------------------

class BaseConvRNNCell(BaseRNNCell):
    """Abstract convolutional RNN cell (parity: rnn_cell.BaseConvRNNCell):
    gate pre-activations are convolutions over the input and the spatial
    hidden state instead of dense projections."""

    def __init__(self, input_shape, num_hidden, h2h_kernel=(3, 3),
                 h2h_dilate=(1, 1), i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 activation="tanh", prefix="", params=None,
                 conv_layout="NCHW"):
        super().__init__(prefix=prefix, params=params)
        if h2h_kernel[0] % 2 == 0 or h2h_kernel[1] % 2 == 0:
            raise MXNetError("h2h_kernel must be odd (got %s)"
                             % (h2h_kernel,))
        self._h2h_kernel = tuple(h2h_kernel)
        self._h2h_dilate = tuple(h2h_dilate)
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._i2h_kernel = tuple(i2h_kernel)
        self._i2h_stride = tuple(i2h_stride)
        self._i2h_pad = tuple(i2h_pad)
        self._i2h_dilate = tuple(i2h_dilate)
        self._num_hidden = num_hidden
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        # state spatial shape falls out of the i2h convolution
        probe = sym_mod.Convolution(
            Variable("data"), num_filter=num_hidden,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate)
        shape = probe.infer_shape(data=self._input_shape)[1][0]
        self._state_shape = (0,) + tuple(shape[1:])
        self._iW = self.params.get("i2h_weight",
                                   init=i2h_weight_initializer)
        self._hW = self.params.get("h2h_weight",
                                   init=h2h_weight_initializer)
        self._iB = self.params.get("i2h_bias", init=i2h_bias_initializer)
        self._hB = self.params.get("h2h_bias", init=h2h_bias_initializer)

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _default_begin_state(self, inputs, layout):
        """The batch vector of the default begin state sums the input over
        every axis but N: ``(N, T) + input_shape[1:]`` unrolled, ``input_shape``
        a step. The JAX package's base rule sums axes 0-2 but N, which
        leaves the spatial axes in and fails for these 5-D inputs
        (ROADMAP, faults of the reference)."""
        ndim = len(self._input_shape)
        if isinstance(inputs, Symbol):
            n_axis = layout.find("N")
            return self._symbolic_begin_state(
                inputs, tuple(i for i in range(ndim + 1) if i != n_axis))
        if isinstance(inputs, (list, tuple)) and inputs \
                and isinstance(inputs[0], Symbol):
            return self._symbolic_begin_state(inputs[0],
                                              tuple(range(1, ndim)))
        return self.begin_state()

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout},
                {"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def _conv_forward(self, inputs, states, name):
        i2h = sym_mod.Convolution(
            inputs, weight=self._iW, bias=self._iB,
            num_filter=self._num_hidden * self._num_gates,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate,
            name="%si2h" % name)
        h2h = sym_mod.Convolution(
            states[0], weight=self._hW, bias=self._hB,
            num_filter=self._num_hidden * self._num_gates,
            kernel=self._h2h_kernel, pad=self._h2h_pad,
            dilate=self._h2h_dilate, name="%sh2h" % name)
        return i2h, h2h


class ConvRNNCell(BaseConvRNNCell):
    """(parity: rnn_cell.ConvRNNCell)"""

    @property
    def _gate_names(self):
        return ("",)

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """(parity: rnn_cell.ConvLSTMCell — Shi et al. convolutional LSTM)"""

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        gates = i2h + h2h
        sliced = sym_mod.SliceChannel(gates, num_outputs=4, axis=1,
                                      name="%sslice" % name)
        in_gate = sym_mod.Activation(sliced[0], act_type="sigmoid")
        forget_gate = sym_mod.Activation(sliced[1], act_type="sigmoid")
        in_transform = self._get_activation(sliced[2], self._activation)
        out_gate = sym_mod.Activation(sliced[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(next_c, self._activation)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """(parity: rnn_cell.ConvGRUCell)"""

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    @property
    def state_info(self):
        return [{"shape": self._state_shape,
                 "__layout__": self._conv_layout}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h, h2h = self._conv_forward(inputs, states, name)
        i2h_s = sym_mod.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = sym_mod.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = sym_mod.Activation(i2h_s[0] + h2h_s[0],
                                        act_type="sigmoid")
        update_gate = sym_mod.Activation(i2h_s[1] + h2h_s[1],
                                         act_type="sigmoid")
        next_h_tmp = self._get_activation(i2h_s[2] + reset_gate * h2h_s[2],
                                          self._activation)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]


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
