"""DataParallelExecutorGroup: one executor per context.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (parity: reference
``executor_group.py:128``, ``decide_slices:266``). The JAX package
shards one executor's program over a mesh; here, as in the reference,
each Context binds its own executor at the slice shapes and takes its
equal slice of every batch (a batch that does not divide raises, as the
JAX package's ``_init_dp`` does); the executors run as one program
(``executor.ReplicaSet``: batch statistics over the whole batch). ``Module`` binds its executors with
the same helpers (``slice_descs``, ``split_batch``, ``merge_outputs``);
this class is the reference's phase-by-phase surface for code that
builds a group directly: ``set_params``, ``forward``, ``backward``,
``get_outputs`` (merged along the batch) and ``update_metric``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..executor import ReplicaSet


def decide_slices(batch_size, work_load_list):
    """Split a batch between workers proportionally (parity:
    executor_group.decide_slices)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for w in work_load_list:
        n = int(round(batch_size * w / total))
        slices.append(slice(start, start + n))
        start += n
    if start != batch_size and slices:
        last = slices[-1]
        slices[-1] = slice(last.start, batch_size)
    return slices


def _name(d):
    return d[0] if isinstance(d, (list, tuple)) else d.name


def _shape(d):
    return d[1] if isinstance(d, (list, tuple)) else d.shape


def slice_descs(descs, n):
    """Input descriptions at one context's slice of the batch (dim 0
    divided by ``n``); raises when a batch does not divide."""
    from ..io import DataDesc
    from ..parallel.spmd import check_batch_divisible
    if n == 1:
        return list(descs)
    out = []
    for d in descs:
        shape = tuple(_shape(d))
        if shape:
            check_batch_divisible(shape[0], n, "batch size", axis="dp")
            shape = (shape[0] // n,) + shape[1:]
        out.append(DataDesc(_name(d), shape,
                            dtype=getattr(d, "dtype", "float32"),
                            layout=getattr(d, "layout", "NCHW")))
    return out


def split_batch(arrays, n):
    """Per context, its equal slice (along dim 0) of each array."""
    if n == 1:
        return [list(arrays)]
    parts = [[] for _ in range(n)]
    for a in arrays:
        per = a.shape[0] // n
        for i in range(n):
            parts[i].append(a[i * per:(i + 1) * per])
    return parts


def merge_outputs(per_context, merge=True):
    """Each context's outputs: one context's list as is; several
    concatenated along the batch on the first context (``merge``) or,
    without ``merge``, one list of the contexts' parts per output."""
    from ..ndarray.ndarray import NDArray
    if len(per_context) == 1:
        return list(per_context[0])
    if not merge:
        return [list(parts) for parts in zip(*per_context)]
    out = []
    for parts in zip(*per_context):
        first = parts[0]
        out.append(NDArray(torch.cat([p._data.to(first._data.device)
                                      for p in parts]), first.context))
    return out


class DataParallelExecutorGroup:
    """(parity: executor_group.DataParallelExecutorGroup) one executor per
    context, each on its slice of the batch."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if len(set(contexts)) != len(contexts):
            raise MXNetError("duplicate devices in context list %s"
                             % (list(contexts),))
        self.symbol = symbol
        self.contexts = list(contexts)
        self.param_names = param_names
        self.for_training = for_training
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else []
        descs = slice_descs(self.data_shapes + self.label_shapes,
                            len(self.contexts))
        shape_kwargs = {_name(d): _shape(d) for d in descs}
        reqs = {}
        for name in symbol.list_arguments():
            if name in (fixed_param_names or []):
                reqs[name] = "null"
            elif name in param_names:
                reqs[name] = grad_req if for_training else "null"
            else:
                reqs[name] = "write" if inputs_need_grad else "null"
        self.execs = [symbol.simple_bind(ctx=c, grad_req=reqs,
                                         **shape_kwargs)
                      for c in self.contexts]
        self._replicas = ReplicaSet(self.execs)

    def set_params(self, arg_params, aux_params=None):
        """Copy the same parameters into every context's executor."""
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=True)

    def forward(self, data_batch, is_train=None):
        """Install each context's slice of the batch and run forward."""
        data = data_batch.data
        if not isinstance(data, (list, tuple)):
            data = [data]
        names = [_name(d) for d in self.data_shapes]
        arrays = list(data)
        label = getattr(data_batch, "label", None)
        if label is not None and self.label_shapes:
            if not isinstance(label, (list, tuple)):
                label = [label]
            names += [_name(l) for l in self.label_shapes]
            arrays += list(label)
        for ex, part in zip(self.execs, split_batch(arrays,
                                                    len(self.execs))):
            ex._feed(dict(zip(names, part)))
        self._replicas.forward(is_train=bool(is_train))

    def backward(self, out_grads=None):
        if out_grads is None:
            self._replicas.backward()
            return
        og = out_grads if isinstance(out_grads, (list, tuple)) \
            else [out_grads]
        self._replicas.backward(split_batch(og, len(self.execs)))

    def get_outputs(self, merge_multi_context=True):
        return merge_outputs([ex.outputs for ex in self.execs],
                             merge_multi_context)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
