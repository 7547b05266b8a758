"""PythonModule: modules written in Python over NDArrays.

A copy of ``mxnet_tpu/module/python_module.py`` (parity: reference
``python/mxnet/module/python_module.py``): ``PythonModule`` (no
parameters; a subclass computes its forward and backward) and
``PythonLossModule`` (forward passes its scores through, backward is
``grad_func(scores, labels)``), for host-side stages of a
``SequentialModule``.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .base_module import BaseModule
from ..initializer import Uniform
from .. import ndarray as nd

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and override forward/backward to compute in Python."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) \
            if label_names is not None else None
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        """A stage bound with labels feeds its outputs to the metric."""
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        if [x[0] for x in data_shapes] != self._data_names:
            raise MXNetError("bind: data %s, the module takes %s"
                             % ([x[0] for x in data_shapes],
                                self._data_names))
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        if label_shapes is not None and (
                self._label_names is None
                or [x[0] for x in label_shapes] != self._label_names):
            raise MXNetError("bind: labels %s, the module takes %s"
                             % ([x[0] for x in label_shapes],
                                self._label_names))
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """The output shapes from the bound data and label shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss stage in Python: ``forward`` keeps the scores (its output)
    and, in training, the labels; ``backward`` gives the input gradient
    ``grad_func(scores, labels)`` (or a subclass's ``_backward_impl``)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        if len(data_names) != 1 or len(label_names) != 1:
            raise MXNetError("PythonLossModule takes one data and one label")
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("a loss module takes no out_grads")
        if not self.for_training:
            raise MXNetError("backward: bind for training")
        self._backward_impl()

    def _backward_impl(self):
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
