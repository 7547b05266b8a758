"""Autograd scopes: recording and training state.

Counterpart of ``mxnet_tpu/autograd.py`` (``record``, ``pause``,
``train_mode``, ``predict_mode`` and the state accessors). The scopes
set the thread-local state that train-mode ops read (BatchNorm takes
batch statistics and updates its moving stats under ``train_mode`` or
``record``). Differentiation itself is ``torch.autograd``: the port's
training entry points (``gluon.block.make_pure_fn``, the executor,
``mx.mod.Module``) differentiate through it directly. The NDArray tape
(``mark_variables``, ``backward``, ``grad``) and ``autograd.Function``
wait for the ``gluon.Trainer`` slice (ROADMAP).
"""
from __future__ import annotations

from . import imperative as _imp

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training"]

is_recording = _imp.is_recording
is_training = _imp.is_training
set_recording = _imp.set_recording
set_training = _imp.set_training


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
