"""Contrib recurrent cells.

Counterpart of ``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py`` (parity:
reference ``gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell``
(Gal & Ghahramani's variational dropout: ONE mask per sequence for the
inputs, the states and the outputs, redrawn only on ``reset()``). The
masks are ``Dropout`` of ones, drawn from the port's ``torch.Generator``
of the input's device (``random.generator``, seeded by
``mx.random.seed``).
"""
from ...rnn import ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """The same dropout mask at every time step (``DropoutCell`` draws a
    fresh one per step); the masks of inputs, states and outputs are
    independent. A mask lives until ``reset()``: stepping by hand must
    reset between sequences, as the reference documents (``unroll``
    resets)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def __call__(self, inputs, states):
        from .... import ndarray as F
        from .... import autograd
        if autograd.is_training():
            if self.drop_inputs:
                if self.drop_inputs_mask is None:
                    self.drop_inputs_mask = F.Dropout(
                        F.ones_like(inputs), p=self.drop_inputs)
                inputs = inputs * self.drop_inputs_mask
            if self.drop_states:
                if self.drop_states_mask is None:
                    self.drop_states_mask = F.Dropout(
                        F.ones_like(states[0]), p=self.drop_states)
                states = [states[0] * self.drop_states_mask] \
                    + list(states[1:])
        output, new_states = self.base_cell(inputs, states)
        if autograd.is_training() and self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = F.Dropout(
                    F.ones_like(output), p=self.drop_outputs)
            output = output * self.drop_outputs_mask
        return output, new_states
