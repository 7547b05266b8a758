"""Fused multi-layer RNN operator (RNN/LSTM/GRU).

Counterpart of ``mxnet_tpu/ops/rnn.py`` (parity: reference
``src/operator/rnn-inl.h`` / ``cudnn_rnn-inl.h`` behind the one ``RNN``
op). The JAX package runs one ``lax.scan`` over time per layer and
direction; here each layer is one call of ATen's fused RNN op
(``torch._VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``), which is cuDNN's
fused RNN on the card and ATen's own loop on the CPU, so no Python loop
runs per time step.

Packed parameter layout (the JAX package's, produced by
``gluon/rnn/rnn_layer.py`` and ``rnn.FusedRNNCell``): for each layer,
for each direction: W_ih (G*H, in), W_hh (G*H, H), b_ih (G*H,), b_hh
(G*H,), flattened and concatenated in order. Gate order: LSTM i,f,c,o,
which is ATen's i,f,g,o; GRU r,z,n with ``n = tanh(W_in x + b_in + r *
(W_hn h + b_hn))``, which is ATen's rule. The per-layer views into the
flat vector are not cuDNN's one contiguous weight buffer, so on the card
ATen copies them into one at every call (and warns once).

Data layout TNC (seq, batch, feature), states (layers*dirs, batch, H).

Dropout between layers (``p``, training only, none after the last
layer) uses the port's own generator (``_rng``), one mask per layer, as
the JAX op does with one ``fold_in`` per layer; cuDNN's own dropout,
which keeps its own state, is never asked for.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .nn import drop_out
from .registry import register, get_op

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(input_size, state_size, num_layers, mode,
                   bidirectional=False):
    """Total packed parameter count (gluon layers, shape inference)."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (in_sz + state_size + 2)
    return size


def _unpack(parameters, input_size, H, num_layers, mode, dirs):
    """Per layer, the flat list ``[W_ih, W_hh, b_ih, b_hh] * dirs`` of
    views into the packed vector (ATen's weight list for one layer)."""
    g = _GATES[mode]
    out, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * dirs
        ws = []
        for _ in range(dirs):
            for shape in ((g * H, in_sz), (g * H, H), (g * H,), (g * H,)):
                n = 1
                for s in shape:
                    n *= s
                ws.append(parameters[off:off + n].view(shape))
                off += n
        out.append(ws)
    if off != parameters.shape[0]:
        raise MXNetError("RNN: parameters hold %d values, the layout needs %d"
                         % (parameters.shape[0], off))
    return out


@register("RNN", nin=4, nout=3,
          arg_names=["data", "parameters", "state", "state_cell"],
          defaults={"state_size": 0, "num_layers": 1, "mode": "lstm",
                    "bidirectional": False, "p": 0.0, "state_outputs": False,
                    "lstm_state_clip_min": None, "lstm_state_clip_max": None})
def rnn(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None, _train=False,
        _rng=None):
    """Fused RNN (layouts in the module docstring). Returns (output,
    final h, final c); final c is zeros outside LSTM. The LSTM state
    clips are accepted and ignored, as in the JAX op (upstream MXNet
    clips the cell state)."""
    if mode not in _GATES:
        raise MXNetError("unknown RNN mode %r" % mode)
    _, _, input_size = data.shape
    H = int(state_size)
    L = int(num_layers)
    dirs = 2 if bidirectional else 1
    layers = _unpack(parameters, input_size, H, L, mode, dirs)
    inputs = [t for t in (data, parameters, state, state_cell)
              if t is not None]
    # cuDNN keeps what its backward needs only in training mode
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    x, hs, cs = data, [], []
    for li, weights in enumerate(layers):
        h0 = state[li * dirs:(li + 1) * dirs]
        if mode == "lstm":
            c0 = state_cell[li * dirs:(li + 1) * dirs] \
                if state_cell is not None else torch.zeros_like(h0)
            x, h, c = torch._VF.lstm(x, (h0, c0), weights, True, 1, 0.0,
                                     keep, dirs == 2, False)
            cs.append(c)
        else:
            x, h = getattr(torch._VF, mode)(x, h0, weights, True, 1, 0.0,
                                            keep, dirs == 2, False)
        hs.append(h)
        if _train and p > 0 and li < L - 1 and _rng is not None:
            x = drop_out(x, p, _rng)
    h_out = torch.cat(hs, 0)
    c_out = torch.cat(cs, 0) if cs else torch.zeros_like(h_out)
    return x, h_out, c_out


def _rnn_visible(params):
    if not params.get("state_outputs", False):
        return 1
    return 3 if params.get("mode", "lstm") == "lstm" else 2


def _rnn_shape_infer(shapes, params):
    _, N, input_size = shapes[0]
    H = int(params.get("state_size", 0))
    L = int(params.get("num_layers", 1))
    mode = params.get("mode", "lstm")
    dirs = 2 if params.get("bidirectional", False) else 1
    out = {1: (rnn_param_size(input_size, H, L, mode, dirs == 2),),
           2: (L * dirs, N, H)}
    if mode == "lstm":
        out[3] = (L * dirs, N, H)
    return out


_rnn_op = get_op("RNN")
_rnn_op.visible_outputs = _rnn_visible
_rnn_op.param_shape_infer = _rnn_shape_infer
