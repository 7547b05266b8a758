"""Gluon RNN cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (parity: reference
``gluon/rnn/rnn_cell.py``: RecurrentCell, RNNCell, LSTMCell, GRUCell,
SequentialRNNCell, BidirectionalCell, DropoutCell, ZoneoutCell,
ResidualCell): the step-at-a-time API, one op per step and gate. The
fused layers (``rnn_layer.py``) are the fast path. States begin on the
context of the cell's parameters (``unroll``: of its inputs).
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock
from ..parameter import DeferredInitializationError, _first_ctx

__all__ = ["RecurrentCell", "HybridRecurrentCell", "ModifierCell",
           "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell"]


class RecurrentCell(HybridBlock):
    """(parity: rnn_cell.RecurrentCell)"""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as F
        func = func or F.zeros
        if "ctx" not in kwargs:
            ctx = _first_ctx(self.collect_params())
            if ctx is not None:
                kwargs["ctx"] = ctx
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            state = func(shape=info["shape"], **kwargs)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """(parity: RecurrentCell.unroll)"""
        from ... import ndarray as F
        self.reset()
        axis = layout.find("T")
        batch_axis = layout.find("N")
        batch_size = inputs.shape[batch_axis]
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs.context)
        states = begin_state
        outputs = []
        steps = F.SliceChannel(inputs, num_outputs=length, axis=axis,
                               squeeze_axis=True)
        if not isinstance(steps, (list, tuple)):
            steps = [steps]
        for i in range(length):
            output, states = self(steps[i], states)
            outputs.append(output)
        if merge_outputs is None or merge_outputs:
            outputs = [o.expand_dims(axis) for o in outputs]
            outputs = F.Concat(*outputs, dim=axis)
        return outputs, states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, *states)

    def _forward_symbol(self, x, *states):
        from ... import symbol as F
        params = {name: F.Variable(p.name)
                  for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, list(states), **params)

    def _forward_eager(self, x, *states):
        params = {}
        try:
            for name, p in self._reg_params.items():
                params[name] = p.data()
        except DeferredInitializationError:
            self._infer_param_shapes(x, *states)
            for name, p in self._reg_params.items():
                params[name] = p.data()
        from ... import ndarray as F
        return self.hybrid_forward(F, x, list(states), **params)


# the reference's cells hybridize; RecurrentCell here is hybrid-capable
HybridRecurrentCell = RecurrentCell


class _BaseRNNCell(RecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, num_gates, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._hidden_size = hidden_size
            self._input_size = input_size
            ng = num_gates
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng * hidden_size, hidden_size),
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_size,),
                init=_maybe_init(i2h_bias_initializer))
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_size,),
                init=_maybe_init(h2h_bias_initializer))

    def _shape_hook(self, x, *args):
        self.i2h_weight._update_shape(
            (self.i2h_weight.shape[0], x.shape[-1]))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]


def _maybe_init(v):
    from ... import initializer as _init
    if isinstance(v, str):
        return _init.create(v)
    return v


class RNNCell(_BaseRNNCell):
    """(parity: rnn_cell.RNNCell)"""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, 1, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_BaseRNNCell):
    """(parity: rnn_cell.LSTMCell; gate order i,f,c,o)"""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, 4, prefix, params)

    def _alias(self):
        return "lstm"

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        H = self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=4 * H)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * H)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseRNNCell):
    """(parity: rnn_cell.GRUCell; gate order r,z,n)"""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, 3, prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        H = self._hidden_size
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=3 * H)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias, num_hidden=3 * H)
        i2h_s = F.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_s = F.SliceChannel(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_s[0] + h2h_s[0])
        update_gate = F.sigmoid(i2h_s[1] + h2h_s[1])
        next_h_tmp = F.tanh(i2h_s[2] + reset_gate * h2h_s[2])
        next_h = (1 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """(parity: rnn_cell.SequentialRNNCell)"""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        info = []
        for cell in self._children.values():
            info.extend(cell.state_info(batch_size))
        return info

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)


class DropoutCell(RecurrentCell):
    """(parity: rnn_cell.DropoutCell)"""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def __call__(self, inputs, states):
        from ... import ndarray as F
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate)
        return inputs, states


class ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)


class ZoneoutCell(ModifierCell):
    """(parity: rnn_cell.ZoneoutCell)"""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        """Also forget the last output (upstream's rule; the JAX cell
        carries it from one unroll into the next)."""
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        from ... import ndarray as F
        from ... import autograd
        output, new_states = self.base_cell(inputs, states)
        if autograd.is_training():
            if self.zoneout_outputs > 0:
                mask = F.Dropout(F.ones_like(output), p=self.zoneout_outputs)
                prev = self._prev_output if self._prev_output is not None \
                    else F.zeros_like(output)
                output = F.where(mask, output, prev)
            if self.zoneout_states > 0:
                new_states = [
                    F.where(F.Dropout(F.ones_like(ns), p=self.zoneout_states),
                            ns, s)
                    for ns, s in zip(new_states, states)]
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """(parity: rnn_cell.ResidualCell)"""

    def _alias(self):
        return "residual"

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """(parity: rnn_cell.BidirectionalCell)"""

    def __init__(self, l_cell, r_cell, prefix="bi_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self._children["l_cell"].state_info(batch_size)
                + self._children["r_cell"].state_info(batch_size))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell supports only unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        self.reset()
        axis = layout.find("T")
        batch_size = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch_size, ctx=inputs.context)
        l_cell = self._children["l_cell"]
        r_cell = self._children["r_cell"]
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(length, inputs, begin_state[:n_l],
                                        layout, merge_outputs=True)
        rev = F.reverse(inputs, axis=axis)
        r_out, r_states = r_cell.unroll(length, rev, begin_state[n_l:],
                                        layout, merge_outputs=True)
        r_out = F.reverse(r_out, axis=axis)
        outputs = F.Concat(l_out, r_out, dim=2)
        return outputs, l_states + r_states
