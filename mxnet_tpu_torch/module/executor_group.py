"""DataParallelExecutorGroup — compatibility facade.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (parity: reference
``executor_group.py:128``): the reference's phase-by-phase executor
surface over one bound executor. One context only; splitting a batch
over cards waits for the distributed slice (ROADMAP Queue 1 item 6).
``Module`` does not use this class: it binds its executor directly.
"""
from __future__ import annotations

from ..base import MXNetError


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


class DataParallelExecutorGroup:
    """(parity: executor_group.DataParallelExecutorGroup) on one context."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if len(contexts) != 1:
            raise MXNetError("DataParallelExecutorGroup: %d contexts; more "
                             "than one device is not ported yet (ROADMAP "
                             "Queue 1 item 6)" % len(contexts))
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else []
        shape_kwargs = {_name(d): _shape(d)
                        for d in self.data_shapes + self.label_shapes}
        reqs = {}
        for name in symbol.list_arguments():
            if name in (fixed_param_names or []):
                reqs[name] = "null"
            elif name in param_names:
                reqs[name] = grad_req if for_training else "null"
            else:
                reqs[name] = "write" if inputs_need_grad else "null"
        self.execs = [symbol.simple_bind(ctx=contexts[0], grad_req=reqs,
                                         **shape_kwargs)]

    def forward(self, data_batch, is_train=None):
        """Install the batch into bound storage and run forward."""
        data = data_batch.data
        if not isinstance(data, (list, tuple)):
            data = [data]
        feed = dict(zip([_name(d) for d in self.data_shapes], data))
        label = getattr(data_batch, "label", None)
        if label is not None and self.label_shapes:
            if not isinstance(label, (list, tuple)):
                label = [label]
            feed.update(zip([_name(l) for l in self.label_shapes], label))
        self.execs[0].forward(is_train=bool(is_train), **feed)

    def backward(self, out_grads=None):
        self.execs[0].backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        return self.execs[0].outputs

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
