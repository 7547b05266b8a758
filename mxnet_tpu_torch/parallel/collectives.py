"""Collectives over the data-parallel process group.

Counterpart of ``mxnet_tpu/parallel/collectives.py`` (``all_reduce``,
``all_gather``, ``reduce_scatter``, ``ppermute``, ``all_to_all``). The
JAX functions run inside ``shard_map`` over a named mesh axis; these
run eagerly over a ``torch.distributed`` group (``group=None``: the
default group ``dist.py`` initialised), the processes of a ``dp`` axis.
Outside a multi-process run the group is this process alone and every
function returns its input's value.

Transport. NCCL takes CUDA tensors directly. On ``gloo`` a CUDA tensor
goes through a pinned host buffer: one device-to-host copy, the
collective on the host copy, one copy back (gloo's own CUDA all-reduce
stages the same way, and it has no CUDA all-gather at all). That is the
transport of ranks that share a card, not a fallback: it is the only
path there.

``ppermute`` and ``all_to_all`` cross processes with ring and Ulysses
attention, ROADMAP Queue 1 item 4, second half; they raise until then.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "ppermute", "all_to_all", "world_size", "DifferentiableSum"]

_OPS = ("sum", "mean", "max", "min")


def _dist():
    import torch.distributed as tdist
    return tdist if tdist.is_available() and tdist.is_initialized() \
        else None


def world_size(group=None):
    """Processes in ``group`` (1 outside a multi-process run)."""
    tdist = _dist()
    return tdist.get_world_size(group) if tdist is not None else 1


def _staged(x, group):
    """Whether ``x`` must go through host memory on ``group``'s backend."""
    return x.is_cuda and _dist().get_backend(group) == "gloo"


def _host(x):
    h = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=True)
    h.copy_(x)
    return h


def _reduce_op(op):
    tdist = _dist()
    return {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX,
            "min": tdist.ReduceOp.MIN, "mean": tdist.ReduceOp.SUM}[op]


def all_reduce(x, group=None, op="sum"):
    """A new tensor: ``op`` of ``x`` over the group's processes."""
    if op not in _OPS:
        raise MXNetError("unknown op %r" % (op,))
    n = world_size(group)
    if n == 1:
        return x.clone()
    if _staged(x, group):
        h = _host(x)
        _dist().all_reduce(h, op=_reduce_op(op), group=group)
        out = h.to(x.device)
    else:
        out = x.clone()
        _dist().all_reduce(out, op=_reduce_op(op), group=group)
    return out / n if op == "mean" else out


def broadcast(x, src=0, group=None):
    """A new tensor holding rank ``src``'s ``x`` on every process."""
    if world_size(group) == 1:
        return x.clone()
    if _staged(x, group):
        h = _host(x)
        _dist().broadcast(h, src=src, group=group)
        return h.to(x.device)
    out = x.clone()
    _dist().broadcast(out, src=src, group=group)
    return out


def all_gather(x, group=None, axis=0, tiled=True):
    """Every process's ``x``, concatenated along ``axis`` in rank order
    (``tiled``) or stacked on a new leading axis."""
    n = world_size(group)
    if n == 1:
        return x.clone() if tiled else x[None].clone()
    staged = _staged(x, group)
    src = _host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    _dist().all_gather(parts, src, group=group)
    if staged:
        parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts)


def reduce_scatter(x, group=None, scatter_dimension=0):
    """This process's block of the sum of ``x`` over the group, ``x``
    split evenly along ``scatter_dimension`` in rank order."""
    n = world_size(group)
    if x.shape[scatter_dimension] % n:
        raise MXNetError("reduce_scatter: dim %d of size %d does not split "
                         "over %d processes"
                         % (scatter_dimension, x.shape[scatter_dimension], n))
    total = all_reduce(x, group)
    me = _dist().get_rank(group) if n > 1 else 0
    return total.chunk(n, dim=scatter_dimension)[me].contiguous()


def ppermute(x, group=None, perm=None):
    raise MXNetError("ppermute across processes comes with ring attention "
                     "over processes (ROADMAP Queue 1 item 4, second half)")


def all_to_all(x, group=None, split_axis=0, concat_axis=0, tiled=True):
    raise MXNetError("all_to_all across processes comes with Ulysses "
                     "attention over processes (ROADMAP Queue 1 item 4, "
                     "second half)")


class DifferentiableSum(torch.autograd.Function):
    """``all_reduce`` sum under autograd: the backward of a sum over the
    processes is the sum of every process's incoming gradient (each
    process's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None
