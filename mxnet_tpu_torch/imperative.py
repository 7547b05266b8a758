"""Imperative runtime: eager op invocation and the recording state.

Counterpart of ``mxnet_tpu/imperative.py`` (``invoke``,
``is_recording``/``is_training``/``set_recording``/``set_training``).
PyTorch's CUDA ops are already asynchronous and stream-ordered, so
"invoke" is a function call on the registered op. Gradients are
PyTorch's own: an op runs under whatever ``torch`` grad mode the caller
set, so a caller that differentiates a pure function of its parameters
(``gluon.block.make_pure_fn``, the executor's training entry points)
gets ``torch.autograd`` through every op. The JAX package's per-NDArray
tape (``attach_grad``/``backward`` under ``autograd.record``) is not
ported yet (ROADMAP); the recording flag is kept as state.
"""
from __future__ import annotations

from .ops import common as _common

__all__ = ["invoke", "is_recording", "is_training", "set_recording",
           "set_training"]


def is_recording():
    return _common.state().recording


def is_training():
    return _common.state().train_mode


def set_recording(flag):
    prev = _common.state().recording
    _common.state().recording = bool(flag)
    return prev


def set_training(flag):
    prev = _common.state().train_mode
    _common.state().train_mode = bool(flag)
    return prev


def invoke(op, inputs, kwargs):
    """Run one op eagerly on NDArrays (parity: ``imperative.invoke``);
    returns a single NDArray or a list of its visible outputs.

    Train-mode ops get ``_train=is_training()``. A training-mode call of
    a stateful op (BatchNorm) updates its aux inputs: the new values are
    written in place, detached, or appended to the active aux collector
    (``make_pure_fn``) instead."""
    import torch
    from .ndarray.ndarray import NDArray
    params = dict(op.defaults)
    params.update(kwargs)
    params.pop("name", None)
    if op.takes_train:
        params["_train"] = is_training()
    nds = [x if isinstance(x, NDArray) else None for x in inputs]
    ctx = next((x.context for x in nds if x is not None), None)
    raw = [x._data if isinstance(x, NDArray) else x for x in inputs]
    outs = op.apply(raw, params)
    if op.stateful_update is not None:
        collector = _common.state().aux_collector
        for idx, val in op.stateful_update(raw, outs, params).items():
            if nds[idx] is None:
                continue
            val = val.detach()
            if collector is not None:
                collector.append((nds[idx], val))
            else:
                with torch.no_grad():
                    nds[idx]._data.copy_(val)
    outs = [NDArray(o, ctx) for o in outs[:op.visible_outputs or op.nout]]
    return outs[0] if len(outs) == 1 else outs
