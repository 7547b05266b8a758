"""Contrib (preview) autograd API.

Counterpart of ``mxnet_tpu/contrib/autograd.py`` (parity: reference
``python/mxnet/contrib/autograd.py``): the older spelling of the autograd
surface (train_section/test_section, compute_gradient), kept for code
written against it; it delegates to the port's ``autograd`` tape.
"""
from __future__ import annotations

import functools

from .. import autograd as _ag
from ..imperative import set_training

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient", "grad_and_loss",
           "grad", "TrainingStateScope"]


def set_is_training(is_train):
    """Set status to training/not training and recording accordingly.

    Returns the previous training status.
    """
    prev = _ag.set_recording(is_train)
    set_training(is_train)
    return prev


class TrainingStateScope:
    """Scope for managing training state (``with train_section(): ...``)."""

    def __init__(self, enter_state):
        self._enter_state = enter_state
        self._prev = None

    def __enter__(self):
        self._prev = set_is_training(self._enter_state)
        return self

    def __exit__(self, ptype, value, trace):
        if self._prev != self._enter_state:
            set_is_training(self._prev)


def train_section():
    """Scope with gradients recorded (reference contrib.autograd)."""
    return TrainingStateScope(True)


def test_section():
    """Scope with training disabled inside a train_section."""
    return TrainingStateScope(False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as variables for gradient computation."""
    return _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    """Compute gradients of outputs w.r.t. marked variables."""
    return _ag.backward(outputs, out_grads, retain_graph)


def compute_gradient(outputs):
    """Deprecated alias of :func:`backward`."""
    return backward(outputs)


def grad_and_loss(func, argnum=None):
    """Return a function that computes both gradient of arguments and loss."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else argnum
            variables = [args[i] for i in argnums]
        from ..ndarray import zeros_like
        grads = [zeros_like(x) for x in variables]
        mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        backward(list(outputs) if isinstance(outputs, (list, tuple))
                 else [outputs])
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Gradient-only version of :func:`grad_and_loss`."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
