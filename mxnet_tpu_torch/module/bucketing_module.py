"""BucketingModule — variable-length sequence training.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (parity: reference
``module/bucketing_module.py``): one ``Module`` bound per bucket key, all
on one device. A switch to another bucket carries the parameters across
on the device (``get_params`` copies, ``init_params(force_init=True)``
copies them in: ``param_copies`` counts the tensors copied,
``bucket_switches`` the switches that copied) and shares the optimizer,
the updater and its states, which are keyed by parameter index: every
bucket's symbol must list its parameters in the same order, which one
``sym_gen`` gives. Each bucket module runs the fused batch step of its
own graph. A module switched away from drops its outputs (only the
current module's are reachable through ``get_outputs``), so the device
holds one bucket's outputs at a time.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule, FusedFallback
from .module import Module


class BucketingModule(BaseModule):
    """(parity: bucketing_module.BucketingModule)"""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self.param_copies = 0
        self.bucket_switches = 0

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        self._check_bound()
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._check_bound()
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._check_bound()
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._check_bound()
        return self._curr_module.symbol

    def _check_bound(self, params=False):
        if not self.binded or (params and not self.params_initialized):
            raise MXNetError("BucketingModule: bind%s first"
                             % (" and init_params" if params else ""))

    def _get_module(self, bucket_key):
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._sym_gen(bucket_key)
            self._buckets[bucket_key] = Module(
                symbol, data_names, label_names, logger=self.logger,
                context=self._context,
                fixed_param_names=self._fixed_param_names,
                state_names=self._state_names, group2ctxs=self._group2ctxs,
                compression_params=self._compression_params)
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module (parity: bucketing_module.bind)."""
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        module = self._get_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=force_rebind, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def _carry_params(self, module, allow_missing=None):
        """The current module's parameters into ``module``, on the device."""
        arg_p, aux_p = self._curr_module.get_params()
        kw = {} if allow_missing is None else {"allow_missing": allow_missing}
        module.init_params(arg_params=arg_p, aux_params=aux_p,
                           force_init=True, **kw)
        self.param_copies += 2 * (len(arg_p) + len(aux_p))
        self.bucket_switches += 1

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it at its first
        use (parity: bucketing_module.switch_bucket)."""
        self._check_bound()
        module = self._get_module(bucket_key)
        if not module.binded:
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            if self._curr_module.params_initialized:
                self._carry_params(module, allow_missing=False)
            if self._curr_module.optimizer_initialized:
                module.borrow_optimizer(self._curr_module)
        elif self._curr_module is not module and \
                self._curr_module.params_initialized:
            self._carry_params(module)
        if self._curr_module is not module:
            self._curr_module._exec.outputs = []
        self._curr_module = module
        self._curr_bucket_key = bucket_key

    def install_monitor(self, mon):
        """Tap every bound bucket's executor into ``mon``, and each bucket
        bound later (parity: reference bucketing_module.install_monitor;
        the JAX package taps only the buckets already bound)."""
        self._check_bound()
        self._monitor = mon
        for module in self._buckets.values():
            if module.binded:
                module.install_monitor(mon)

    def get_states(self, merge_multi_context=True):
        """The current bucket's states (parity:
        bucketing_module.get_states)."""
        self._check_bound(params=True)
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        """(parity: bucketing_module.set_states)"""
        self._check_bound(params=True)
        self._curr_module.set_states(states, value)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self._check_bound()
        self._curr_module.init_params(
            initializer=initializer if initializer is not None
            else Uniform(0.01),
            arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init,
            allow_extra=allow_extra)
        self.params_initialized = True

    def get_params(self):
        self._check_bound(params=True)
        return self._curr_module.get_params()

    def init_optimizer(self, **kwargs):
        self._check_bound(params=True)
        self._curr_module.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._check_bound(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        self._check_bound(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward_backward(data_batch)

    def _fused_batch_step(self, data_batch, eval_metric=None):
        """The fused batch step of the batch's bucket module, after the
        switch (the shared updater's states and counts ride across); a
        bucket that must phase-split does so for its own batches only."""
        self._check_bound(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        fused = self._curr_module._fused_batch_step(data_batch, eval_metric)
        if fused:
            self._params_dirty = True
        return fused

    @property
    def _fused_fallback_reason(self):
        """Why the current bucket's last step phase-split (None: fused)."""
        if self._curr_module is None:
            return FusedFallback("not_initialised",
                                 "module not fully initialised")
        return self._curr_module._fused_fallback_reason

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)
