"""Pipeline parallelism: a GPipe schedule over a mesh axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``: each member of the
``pp`` axis holds one stage's parameters; the microbatch stream flows
through the stages with one ``ppermute`` per tick, ``n_micro + n - 1``
ticks in all (stage 0 injects microbatch ``t``, the last stage records
microbatch ``t - (n - 1)``), and the outputs are summed over ``pp``
(only the last stage's are non-zero) so every member returns them.
Differentiable through the ``ppermute``s (the last tick's send, which no
stage reads, is left out). As with the JAX function's
replicated output, every member of the axis computes the same loss from
it: the backward of the final sum passes each member's gradient through
unchanged.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import collectives as C
from .mesh import PartitionSpec as P

__all__ = ["pipeline_apply", "PARTITION_RULES"]

# The GPipe layout as a partition-rule set (``mxnet_tpu`` ``:33-36``):
# stage-stacked parameters shard their leading stage axis over ``pp``.
PARTITION_RULES = [
    (r"stage", P("pp")),
    (r".*", P("pp")),
]


class _SumToAll(torch.autograd.Function):
    """The outputs summed over the axis (``:88-92``); the members hold the
    same sum and compute the same loss from it, so the gradient of the
    one value passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return C._all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn, stage_params, x, mesh, axis_name="pp",
                   n_micro=None):
    """Apply ``n`` pipeline stages to ``x``.

    stage_fn(params_i, mb) -> mb : one stage's computation; every stage
    maps activations to the same shape (the GPipe layout).
    stage_params: a pytree of the calling member's stage, each leaf with
    a leading stage axis of size 1 (or the whole stack of ``n``, of which
    it takes its own). x: (n_micro, mb...) the whole microbatch stream,
    the same on every member. Returns (n_micro, mb...) outputs of the
    last stage on every member.
    """
    from ..ndarray.ndarray import NDArray
    wrap = isinstance(x, NDArray)
    xr = x._data if isinstance(x, NDArray) else x
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    stage = group.index
    n_micro = n_micro or xr.shape[0]

    def mine(p):
        p = p._data if isinstance(p, NDArray) else p
        if p.shape[0] not in (1, n):
            raise MXNetError("pipeline_apply: a stage parameter of shape %s "
                             "for a %r axis of size %d"
                             % (tuple(p.shape), axis_name, n))
        return p[stage] if p.shape[0] == n and n > 1 else p[0]
    params = _tree_map(mine, stage_params)
    ring = [(i, (i + 1) % n) for i in range(n)]
    # every member builds the same graph (the choices below are selects,
    # not branches), so each ppermute's backward runs on every member
    first = torch.tensor(stage == 0, device=xr.device)
    last = torch.tensor(stage == n - 1, device=xr.device)
    acc = [torch.zeros_like(xr[0]) for _ in range(n_micro)]
    cur = torch.zeros_like(xr[0])
    total = n_micro + n - 1
    for t in range(total):
        x_in = torch.where(first, xr[min(t, n_micro - 1)], cur)
        y = stage_fn(params, x_in)
        if t >= n - 1:
            acc[t - (n - 1)] = torch.where(last, y, acc[t - (n - 1)])
        if n > 1 and t < total - 1:
            cur = C.ppermute(y, group, ring)
    acc = torch.stack(acc)
    out = _SumToAll.apply(acc, group) if n > 1 else acc
    return NDArray(out) if wrap else out
