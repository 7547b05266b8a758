"""SequentialModule: modules chained, each one's outputs the next one's
data.

A copy of ``mxnet_tpu/module/sequential_module.py`` (parity: reference
``python/mxnet/module/sequential_module.py``): each stage binds with the
previous stage's output shapes as its data shapes (and, after the
first, with ``inputs_need_grad``); ``take_labels`` routes the batch
labels to a stage, ``auto_wiring`` renames the previous outputs to the
stage's data names; backward runs the chain in reverse, each stage's
input gradients the previous stage's head gradients.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from ..initializer import Uniform
from ..io import DataBatch

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A container module chaining several modules together."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append ``module`` (options ``take_labels=True``,
        ``auto_wiring=True``); returns self. The chain is unbound
        again."""
        for key in kwargs:
            if key not in self._meta_keys:
                raise MXNetError("Unknown meta %s" % key)
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _check(self, params=False, optimizer=False):
        if not self.binded or (params and not self.params_initialized) or \
                (optimizer and not self.optimizer_initialized):
            raise MXNetError("SequentialModule: bind, init_params and "
                             "init_optimizer first")

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._check()
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._check()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._check()
        return self._modules[-1].output_shapes

    def get_params(self):
        """Every stage's parameters in one pair of dicts."""
        self._check(params=True)
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Each stage takes what it names from ``arg_params``/
        ``aux_params`` and initialises the rest; a name in two stages
        raises."""
        if self.params_initialized and not force_init:
            return
        self._check()
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, force_init=force_init)
        for which in (0, 1):
            seen = {}
            for i, module in enumerate(self._modules):
                names = list(module.get_params()[which])
                for name in names:
                    if name in seen:
                        raise MXNetError("Duplicated parameter name %s in "
                                         "%s" % (name, module))
                    seen[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each stage to the previous stage's output shapes."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training")
        if shared_module is not None:
            raise MXNetError("Shared module is not supported by "
                             "SequentialModule")
        if not self._modules:
            raise MXNetError("Attempting to bind an empty chain")
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, module in enumerate(self._modules):
            meta = self._metas[i_layer]
            if meta.get(self.META_TAKE_LABELS, False):
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = for_training and (
                inputs_need_grad or i_layer > 0)
            if meta.get(self.META_AUTO_WIRING, False):
                data_names = module.data_names
                if len(data_names) != len(my_data_shapes):
                    raise MXNetError("auto_wiring: %d data names for %d "
                                     "outputs" % (len(data_names),
                                                  len(my_data_shapes)))
                my_data_shapes = [(new_name, shape) for new_name, (_, shape)
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_ever_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """One optimizer per stage, from the same arguments."""
        self._check(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._check(params=True)
        batch = data_batch
        for i_layer, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i_layer + 1 == len(self._modules):
                break
            batch = DataBatch(data=module.get_outputs(),
                              label=getattr(data_batch, "label", None))

    def backward(self, out_grads=None):
        self._check(params=True)
        for i_layer, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i_layer == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        self._check(params=True, optimizer=True)
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        self._check(params=True)
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check(params=True)
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads: bind with "
                             "inputs_need_grad=True")
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        """Each stage that takes the labels updates the metric."""
        self._check(params=True)
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._check()
        for module in self._modules:
            module.install_monitor(mon)
