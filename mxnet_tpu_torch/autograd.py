"""Autograd: recording scopes, backward, grad and custom Functions.

Counterpart of ``mxnet_tpu/autograd.py``: ``record``, ``pause``,
``train_mode``/``predict_mode`` and the state accessors set the
thread-local state that train-mode ops read and the tape records under;
``mark_variables``, ``backward`` and ``grad`` (with ``create_graph`` for
higher orders) work on the NDArray tape of ``imperative.py``, which is
``torch.autograd``'s graph; ``get_symbol`` rebuilds a Symbol from the
ops the tape recorded. ``Function`` is a user-defined op whose
backward runs the user's NDArray ``backward`` under ``pause()``.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from . import imperative as _imp

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]

is_recording = _imp.is_recording
is_training = _imp.is_training
set_recording = _imp.set_recording
set_training = _imp.set_training
mark_variables = _imp.mark_variables
get_symbol = _imp.get_symbol


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_record = is_record
        self._enter_train = train_mode
        self._prev_record = None
        self._prev_train = None

    def __enter__(self):
        if self._enter_record is not None:
            self._prev_record = set_recording(self._enter_record)
        if self._enter_train is not None:
            self._prev_train = set_training(self._enter_train)
        return self

    def __exit__(self, *exc):
        if self._enter_record is not None:
            set_recording(self._prev_record)
        if self._enter_train is not None:
            set_training(self._prev_train)


def record(train_mode=True):
    """Scope that records and (by default) trains (parity: autograd.record)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """(parity: autograd.backward)"""
    heads = _as_list(heads)
    if head_grads is not None:
        head_grads = _as_list(head_grads)
    _imp.backward(heads, head_grads, retain_graph=retain_graph,
                  train_mode=train_mode)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (leaves),
    returned rather than written into ``.grad`` (parity: autograd.grad).
    With ``create_graph`` the gradients carry the tape themselves, so a
    gradient of them composes to any order. A variable the heads do not
    reach gets zeros."""
    from .ndarray.ndarray import NDArray
    heads = _as_list(heads)
    single = not isinstance(variables, (list, tuple))
    varlist = _as_list(variables)
    for v in varlist:
        if v._grad_req is None or v._tape:
            raise MXNetError("autograd.grad: variables must have attached "
                             "grad (call attach_grad before record)")
    pairs = _imp.head_pairs(
        heads, None if head_grads is None else _as_list(head_grads))
    if retain_graph is None:
        retain_graph = create_graph
    grads = _imp.autograd_grad([y._data for y, _ in pairs],
                               [g for _, g in pairs],
                               [_imp.tape_tensor(v) for v in varlist],
                               retain_graph=bool(retain_graph),
                               create_graph=create_graph)
    if not retain_graph:
        _imp.free_heads(y for y, _ in pairs)
    out = []
    for v, g in zip(varlist, grads):
        if g is None:
            g = torch.zeros_like(v._data)
        nd = NDArray(g if create_graph else g.detach(), v.context)
        nd._tape = bool(create_graph and g.requires_grad)
        out.append(nd)
    return out[0] if single else out


class _FunctionNode(torch.autograd.Function):
    """One user ``Function`` call as a node of torch's graph: forward
    hands back the outputs the user's forward computed, backward runs the
    user's ``backward`` on NDArrays under ``pause()``."""

    @staticmethod
    def forward(ctx, func, outs, *inputs):
        ctx.func = func
        ctx.n_in = len(inputs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        func = ctx.func
        cts = [NDArray(g.detach()) for g in out_grads]
        with pause():
            in_grads = func.backward(*cts)
        in_grads = _as_list(in_grads)
        if len(in_grads) != ctx.n_in:
            raise MXNetError("Function.backward returned %d gradients for %d "
                             "inputs" % (len(in_grads), ctx.n_in))
        return (None, None) + tuple(
            g._data if isinstance(g, NDArray) else g for g in in_grads)


class Function:
    """User-defined differentiable function (parity: autograd.Function).

    Subclass and implement ``forward`` / ``backward`` over NDArrays."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        nds = [x for x in inputs if isinstance(x, NDArray)]
        record = _imp.should_record(nds)
        with pause():
            outputs = self.forward(*inputs)
        if not record:
            return outputs
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        with torch.enable_grad():
            raws = _FunctionNode.apply(self, [o._data for o in outs],
                                       *_imp.read_inputs(nds, True))
        for o, r in zip(outs, raws):
            o._data = r
            o._tape = True
        return outputs
