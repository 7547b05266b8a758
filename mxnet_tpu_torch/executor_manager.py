"""Legacy executor manager: one executor per context.

Counterpart of ``mxnet_tpu/executor_manager.py`` (parity: reference
``python/mxnet/executor_manager.py``): ``FeedForward``'s oldest
data-parallel layer. ``DataParallelExecutorManager`` keeps one executor
per context, each bound at its slice of the batch from
``_split_input_slice`` (the reference's rule: proportional to
``work_load_list``, no empty slice), and the slicing helpers keep the
reference's semantics. The JAX package binds one sharded executor here;
the port binds one per context, as the reference does, so
``param_arrays``/``grad_arrays``/``aux_arrays`` hold one array per
context for each name.
"""
from __future__ import annotations

import logging

from . import ndarray as nd
from .executor import ReplicaSet

__all__ = ["DataParallelExecutorGroup", "DataParallelExecutorManager",
           "_split_input_slice", "_check_arguments", "_load_data",
           "_load_label", "_load_general"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice for each worker, proportional to its work load
    (parity: executor_manager.py:31). Raises ValueError when a slice
    would be empty."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(batch_size * item / total_work_load)
                      for item in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol):
    """Argument names and auxiliary-state names must each be distinct
    (parity: executor_manager.py:68)."""
    for what, names in (("argument name", symbol.list_arguments()),
                        ("auxiliary param name",
                         symbol.list_auxiliary_states())):
        seen = set()
        for name in names:
            if name in seen:
                raise ValueError(
                    "Find duplicated %s \"%s\", please make the weight "
                    "name non-duplicated(using name arguments), %s are %s"
                    % (what, name, "arguments" if what.startswith("arg")
                       else "aux states", str(names)))
            seen.add(name)


def _load_general(data, targets):
    """Copy each source array into its target, or its slices into the
    per-context targets ``[(slice, array), ...]``."""
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, nd.NDArray):
            d_src.copyto(d_targets)
        else:
            for slice_idx, d_dst in d_targets:
                d_src[slice_idx].copyto(d_dst)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorGroup:
    """One executor per context, each at its slice of the batch (parity:
    executor_manager.py:204)."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None):
        _check_arguments(sym)
        self.ctx = list(ctx)
        self.param_names = param_names
        self.arg_names = arg_names
        self.slices = slices
        descs = list(train_data.provide_data) + \
            list(train_data.provide_label or [])
        self.data_names = [d[0] for d in train_data.provide_data]
        self.label_names = [l[0] for l in (train_data.provide_label or [])]
        grad_req = {name: ("write" if name in param_names else "null")
                    for name in arg_names}
        self.train_execs = []
        for c, sl in zip(self.ctx, slices):
            shapes = {name: (sl.stop - sl.start,) + tuple(shape[1:])
                      for name, shape in descs}
            self.train_execs.append(sym.simple_bind(ctx=c, grad_req=grad_req,
                                                    **shapes))
        self.data_arrays = [[(sl, e.arg_dict[n])
                             for sl, e in zip(slices, self.train_execs)]
                            for n in self.data_names]
        self.label_arrays = [[(sl, e.arg_dict[n])
                              for sl, e in zip(slices, self.train_execs)]
                             for n in self.label_names]
        self.param_arrays = [[e.arg_dict[n] for e in self.train_execs]
                             for n in param_names]
        self.grad_arrays = [[e.grad_dict[n] for e in self.train_execs]
                            for n in param_names]
        self.aux_arrays = [[e.aux_arrays[i] for e in self.train_execs]
                           for i in range(len(self.train_execs[0]
                                              .aux_arrays))]
        # one program over the contexts: batch statistics over the whole
        # batch, as the JAX package's one executor computes them
        self._replicas = ReplicaSet(self.train_execs)

    @property
    def train_exec(self):
        """The first context's executor."""
        return self.train_execs[0]

    def load_data_batch(self, data_batch):
        _load_data(data_batch, self.data_arrays)
        if self.label_names:
            _load_label(data_batch, self.label_arrays)

    def forward(self, is_train=False):
        self._replicas.forward(is_train=is_train)

    def backward(self):
        self._replicas.backward()

    def update_metric(self, metric, labels):
        for e, sl in zip(self.train_execs, self.slices):
            metric.update([l[sl] for l in labels], e.outputs)


class DataParallelExecutorManager:
    """Data-parallel training over one executor per context (parity:
    executor_manager.py:295)."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None,
                 sym_gen=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if not (isinstance(work_load_list, list)
                and len(work_load_list) == num_device):
            raise ValueError("Invalid settings for work load.")
        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.arg_names, self.param_names, self.ctx,
            self.slices, train_data)
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.curr_execgrp = self.execgrp
        self.execgrp_bucket = {}

    def install_monitor(self, monitor):
        for e in self.curr_execgrp.train_execs:
            monitor.install(e)

    def set_params(self, arg_params, aux_params):
        """The same parameters into every context's executor."""
        for e in self.curr_execgrp.train_execs:
            for name, arr in arg_params.items():
                if name in e.arg_dict:
                    arr.copyto(e.arg_dict[name])
            for name, arr in aux_params.items():
                if name in e.aux_dict:
                    arr.copyto(e.aux_dict[name])

    def copy_to(self, arg_params, aux_params):
        """Copy the parameters out: the mean over the contexts (parity:
        executor_manager.py:374; equal replicas give their value)."""
        e0 = self.curr_execgrp.train_execs

        def mean(arrs):
            total = arrs[0].copy()
            for a in arrs[1:]:
                total += a.as_in_context(total.context)
            return total / len(arrs)
        for name in self.param_names:
            arg_params[name] = mean([e.arg_dict[name] for e in e0])
        for name in self.aux_names:
            aux_params[name] = mean([e.aux_dict[name] for e in e0])

    @property
    def param_arrays(self):
        return self.curr_execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.curr_execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.curr_execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        if self.sym_gen is not None:
            key = getattr(data_batch, "bucket_key", None)
            if key is not None and key not in self.execgrp_bucket:
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    self.sym_gen(key), self.arg_names, self.param_names,
                    self.ctx, self.slices, data_batch)
            if key is not None:
                self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
