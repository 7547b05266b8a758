"""Collectives over a mesh axis or a process group.

Counterpart of ``mxnet_tpu/parallel/collectives.py`` (``all_reduce``,
``all_gather``, ``reduce_scatter``, ``ppermute``, ``all_to_all``). The
JAX functions run inside ``shard_map`` over a named mesh axis; these run
eagerly in each member of a mesh (``mesh.py``) over ``group``:

- an :class:`~.mesh.AxisGroup` (``mesh.group("sp")``): the line of that
  axis through the calling member, whether its members are threads of
  this process, worker processes, or both;
- a ``torch.distributed`` group, or None for the default group that
  ``dist.py`` initialised (the processes of a launched job). Outside a
  multi-process run that group is this process alone and every function
  returns its input's value. After a member loss None means the
  survivors (``dist.live_group``): member ``i`` is the ``i``-th live
  rank, and the last survivor is a group of one.

Transport. Between processes NCCL takes CUDA tensors directly. On
``gloo`` a CUDA tensor goes through a pinned host buffer: one
device-to-host copy, the collective on the host copy, one copy back
(gloo's own CUDA all-reduce stages the same way, and it has no CUDA
all-gather at all). That is the transport of ranks that share a card,
not a fallback: it is the only path there. ``ppermute`` posts its sends
and receives together (``batch_isend_irecv``), so a ring cannot
deadlock; ``all_to_all`` is one ``all_to_all_single``. Threads of one
process exchange tensors through the line's rendezvous.

Autograd. A tensor that requires grad goes through an
``autograd.Function``:

- ``all_reduce`` (sum, mean): the backward all-reduces the gradient (each
  member's loss reads the same sum);
- ``ppermute``: the inverse permutation;
- ``all_to_all``: the reverse ``all_to_all``;
- ``all_gather``: this member's slice of the gradient. The members of the
  group hold the same gathered value and compute the same loss from it
  (a parameter gathered over a tensor-parallel axis), as the output of
  the JAX package's ``all_gather_invariant`` is; rows mixed across
  members whose losses differ go through ``all_reduce``.

Every member must call a collective of a group in the same order.

Liveness. With a heartbeat directory (``MXTPU_HEARTBEAT_DIR``, see
``heartbeat.py``) and live peers, a collective between processes is
issued asynchronously and awaited in slices of 0.25 s: between slices,
and when the transport fails (gloo reports "connection closed by peer"
as soon as a peer process dies), the peers' heartbeats are read, and a
peer gone stale turns the wait into ``heartbeat.DeadWorkerError``
(channel ``step-execution``) within the heartbeat timeout plus 5 s, in
place of an error or a block until the group's timeout. Without a
directory each collective blocks in the transport as before.

:data:`wire` counts, since the last :func:`reset_wire`, the calls that
reached a transport, the payload bytes this process handed to it (the
tensor each member contributes) and the host seconds spent in it (on
``gloo`` those include the device-to-host copies, which wait for the
work queued before them).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time

import torch

from ..base import MXNetError
from .mesh import AxisGroup

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "ppermute", "all_to_all", "barrier", "world_size",
           "DifferentiableSum", "wire", "reset_wire"]

_OPS = ("sum", "mean", "max", "min")

wire = {"calls": 0, "bytes": 0, "seconds": 0.0}   # guarded by: _wire_lock
_wire_lock = threading.Lock()


def reset_wire():
    with _wire_lock:
        wire.update(calls=0, bytes=0, seconds=0.0)


@contextlib.contextmanager
def _on_wire(x):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _wire_lock:
            wire["calls"] += 1
            wire["bytes"] += x.numel() * x.element_size()
            wire["seconds"] += dt


def _dist():
    import torch.distributed as tdist
    return tdist if tdist.is_available() and tdist.is_initialized() \
        else None


def _live(group):
    """``group``, with None (the default group) read as the survivors'
    group after a member loss (``dist.live_group``)."""
    if group is not None:
        return group
    from .. import dist
    return dist.live_group()


def world_size(group=None):
    """Members of ``group`` (1 outside a multi-process run)."""
    if isinstance(group, AxisGroup):
        return group.size
    group = _live(group)
    from ..dist import ALONE
    if group is ALONE:
        return 1
    tdist = _dist()
    return tdist.get_world_size(group) if tdist is not None else 1


_SLICE = datetime.timedelta(seconds=0.25)
_ERROR_SLACK_S = 5.0


def _watched_peers():
    """The live peers to watch while a collective is in flight: every
    live rank but this one when a heartbeat directory is set, else
    None (the transport's own blocking wait)."""
    from .. import dist, heartbeat
    if not os.environ.get(heartbeat.ENV_DIR) or not dist.initialized():
        return None
    me = dist.rank()
    return [r for r in dist.live_ranks() if r != me] or None


def _transport(fn, *args, **kwargs):
    """Run one ``torch.distributed`` call: blocking, or, with liveness
    watched, asynchronously and awaited by :func:`_await`."""
    peers = _watched_peers()
    if peers is None:
        return fn(*args, **kwargs)
    _await([fn(*args, async_op=True, **kwargs)], peers)


def _await(works, peers):
    """Wait for ``works`` while watching ``peers``' heartbeats: a peer
    gone stale raises ``DeadWorkerError`` (channel ``step-execution``).
    A transport error is held until the heartbeat timeout plus
    :data:`_ERROR_SLACK_S` has shown whether a peer died; if none did,
    it is raised as it came."""
    from .. import heartbeat
    timeout = heartbeat._timeout(None)
    for work in works:
        while True:
            try:
                work.wait(_SLICE)
                break
            except RuntimeError as e:
                if not work.is_completed():     # the slice ran out
                    dead = heartbeat.stale_ranks(peers)
                    if dead:
                        raise _in_flight(dead, "stale heartbeat") from e
                    continue
                deadline = time.monotonic() + timeout + _ERROR_SLACK_S
                while time.monotonic() < deadline:
                    dead = heartbeat.stale_ranks(peers)
                    if dead:
                        raise _in_flight(dead, str(e).splitlines()[0][-160:]) \
                            from e
                    time.sleep(0.1)
                raise


def _in_flight(dead, what):
    from ..heartbeat import DeadWorkerError
    return DeadWorkerError(dead, channel="step-execution", evidence={
        r: "died with a collective in flight (%s)" % what for r in dead})


def _staged(x, pg):
    """Whether ``x`` must go through host memory on ``pg``'s backend."""
    return x.is_cuda and _dist().get_backend(pg) == "gloo"


def _host(x):
    h = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                    pin_memory=x.is_cuda)
    h.copy_(x)
    return h


def _reduce_op(op):
    tdist = _dist()
    return {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX,
            "min": tdist.ReduceOp.MIN, "mean": tdist.ReduceOp.SUM}[op]


class _Proc:
    """A group whose members are processes: ``pg`` (None: the default
    group), member ``i`` is group rank ``order[i]``, this process is
    member ``index``."""

    def __init__(self, pg, order, index):
        self.pg, self.order, self.index = pg, order, index
        self.size = len(order)

    def global_rank(self, member):
        r = self.order[member]
        return r if self.pg is None else _dist().get_global_rank(self.pg, r)


def _pg_all_gather(x, pg):
    """Every group rank's ``x`` over ``pg``, in group-rank order, on
    ``x``'s device."""
    staged = _staged(x, pg)
    src = _host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(_dist().get_world_size(pg))]
    _transport(_dist().all_gather, parts, src, group=pg)
    return [p.to(x.device) for p in parts] if staged else parts


def _resolve(group):
    """None (a group of one), a :class:`_Proc`, or the AxisGroup itself
    (its members meet through ``AxisGroup.exchange``)."""
    if isinstance(group, AxisGroup):
        if group.size == 1:
            return None
        if group.uses_process_group():
            return _Proc(_live(group.line.pg), group.order, group.index)
        return group
    group = _live(group)
    n = world_size(group)
    if n == 1:
        return None
    return _Proc(group, list(range(n)), _dist().get_rank(group))


def _grad_on(*xs):
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


# -- all_reduce ------------------------------------------------------------------

def _all_reduce(x, group, op):
    g = _resolve(group)
    if g is None:
        return x.clone()
    with _on_wire(x):
        out = _all_reduce_on(x, g, op)
    return out / g.size if op == "mean" else out


def _all_reduce_on(x, g, op):
    if isinstance(g, _Proc):
        if _staged(x, g.pg):
            h = _host(x)
            _transport(_dist().all_reduce, h, op=_reduce_op(op), group=g.pg)
            out = h.to(x.device)
        else:
            out = x.clone()
            _transport(_dist().all_reduce, out, op=_reduce_op(op),
                       group=g.pg)
    else:
        parts = g.exchange(x)
        out = parts[0]
        for p in parts[1:]:
            out = {"sum": torch.add, "mean": torch.add,
                   "max": torch.maximum, "min": torch.minimum}[op](out, p)
    return out


class DifferentiableSum(torch.autograd.Function):
    """``all_reduce`` sum under autograd: the backward of a sum over the
    members is the sum of every member's incoming gradient (each
    member's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group=None):
        ctx.group = group
        return _all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, "sum"), None


def all_reduce(x, group=None, op="sum"):
    """A new tensor: ``op`` of ``x`` over the group's members, the same
    bits on every member. Differentiable for ``sum`` and ``mean``."""
    if op not in _OPS:
        raise MXNetError("unknown op %r" % (op,))
    if op in ("sum", "mean") and _grad_on(x):
        out = DifferentiableSum.apply(x, group)
        return out / world_size(group) if op == "mean" else out
    return _all_reduce(x, group, op)


# -- broadcast ---------------------------------------------------------------------

def broadcast(x, src=0, group=None):
    """A new tensor holding member ``src``'s ``x`` on every member."""
    g = _resolve(group)
    if g is None:
        return x.clone()
    with _on_wire(x):
        return _broadcast_on(x, src, g)


def _broadcast_on(x, src, g):
    if isinstance(g, _Proc):
        root = g.global_rank(src)
        if _staged(x, g.pg):
            h = _host(x)
            _transport(_dist().broadcast, h, src=root, group=g.pg)
            return h.to(x.device)
        out = x.clone()
        _transport(_dist().broadcast, out, src=root, group=g.pg)
        return out
    return g.exchange(x)[src]


def barrier(group=None):
    """Block until every member of ``group`` (default: the job's live
    processes) gets here."""
    g = _resolve(group)
    if g is None:
        return
    if isinstance(g, _Proc):
        _transport(_dist().barrier, group=g.pg)
        return
    g.exchange(torch.zeros(1))


# -- all_gather --------------------------------------------------------------------

def _all_gather_parts(x, group):
    g = _resolve(group)
    if g is None:
        return [x.clone()], 0
    with _on_wire(x):
        if isinstance(g, _Proc):
            parts = _pg_all_gather(x, g.pg)
            return [parts[r] for r in g.order], g.index
        return g.exchange(x), g.index


def _all_gather(x, group, axis, tiled):
    parts, _ = _all_gather_parts(x, group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts)


class _AllGather(torch.autograd.Function):
    """``all_gather`` whose backward keeps this member's slice of the
    gradient (the members compute the same loss from the gathered
    value)."""

    @staticmethod
    def forward(ctx, x, group, axis, tiled):
        ctx.group, ctx.axis, ctx.tiled = group, axis, tiled
        ctx.n, ctx.me = world_size(group), _member_index(group)
        return _all_gather(x, group, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        if ctx.tiled:
            mine = g.chunk(ctx.n, dim=ctx.axis)[ctx.me]
        else:
            mine = g[ctx.me]
        return mine.contiguous(), None, None, None


def _member_index(group):
    if isinstance(group, AxisGroup):
        return group.index
    group = _live(group)
    return _dist().get_rank(group) if world_size(group) > 1 else 0


def all_gather(x, group=None, axis=0, tiled=True):
    """Every member's ``x``, concatenated along ``axis`` in member order
    (``tiled``) or stacked on a new leading axis."""
    if _grad_on(x):
        return _AllGather.apply(x, group, axis, tiled)
    return _all_gather(x, group, axis, tiled)


def reduce_scatter(x, group=None, scatter_dimension=0):
    """This member's block of the sum of ``x`` over the group, ``x``
    split evenly along ``scatter_dimension`` in member order."""
    n = world_size(group)
    if x.shape[scatter_dimension] % n:
        raise MXNetError("reduce_scatter: dim %d of size %d does not split "
                         "over %d members"
                         % (scatter_dimension, x.shape[scatter_dimension], n))
    total = all_reduce(x, group)
    return total.chunk(n, dim=scatter_dimension)[_member_index(group)] \
        .contiguous()


# -- ppermute ------------------------------------------------------------------------

def _check_perm(perm, n):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) \
            or not all(0 <= i < n for i in srcs + dsts):
        raise MXNetError("ppermute: %s is not a permutation of members "
                         "0..%d" % (perm, n - 1))
    return perm


def _ppermute(x, group, perm):
    g = _resolve(group)
    n = world_size(group)
    perm = _check_perm(perm, n)
    if g is None:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    with _on_wire(x):
        return _ppermute_on(x, g, perm)


def _ppermute_on(x, g, perm):
    me = g.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if not isinstance(g, _Proc):
        parts = g.exchange(x)
        return parts[src[0]] if src else torch.zeros_like(x)
    tdist = _dist()
    staged = _staged(x, g.pg)
    out = torch.zeros_like(x)
    send = _host(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    ops = []
    if dst and dst[0] != me:
        ops.append(tdist.P2POp(tdist.isend, send, g.global_rank(dst[0]),
                               g.pg))
    if src and src[0] != me:
        ops.append(tdist.P2POp(tdist.irecv, recv, g.global_rank(src[0]),
                               g.pg))
    if ops:
        works = tdist.batch_isend_irecv(ops)
        peers = _watched_peers()
        if peers is None:
            for w in works:
                w.wait()
        else:
            _await(works, peers)
    if src:
        out = x.clone() if src[0] == me else recv.to(x.device)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g.contiguous(), ctx.group, inverse), None, None


def ppermute(x, group, perm):
    """Send ``x`` from member ``s`` to member ``d`` for every ``(s, d)``
    of ``perm`` (``lax.ppermute``); a member no pair sends to gets
    zeros. Differentiable: the backward sends the gradient back along
    the inverse permutation."""
    if _grad_on(x):
        return _PPermute.apply(x, group, [tuple(p) for p in perm])
    return _ppermute(x, group, perm)


# -- all_to_all ------------------------------------------------------------------------

def _all_to_all(x, group, split_axis, concat_axis, tiled):
    n = world_size(group)
    if x.shape[split_axis] % n:
        raise MXNetError("all_to_all: dim %d of size %d does not split "
                         "over %d members" % (split_axis, x.shape[split_axis],
                                              n))
    if not tiled and x.shape[split_axis] != n:
        raise MXNetError("all_to_all(tiled=False): dim %d must have size %d"
                         % (split_axis, n))
    g = _resolve(group)
    if g is None:
        recv = [x.clone()]
    else:
        with _on_wire(x):
            recv = _all_to_all_on(x, g, n, split_axis)
    if tiled:
        return torch.cat(recv, dim=concat_axis)
    return torch.stack([r.squeeze(split_axis) for r in recv],
                       dim=concat_axis)


def _all_to_all_on(x, g, n, split_axis):
    if isinstance(g, _Proc):
        chunks = x.chunk(n, dim=split_axis)
        # member m's chunk goes to group rank order[m]
        by_rank = [None] * n
        for m, c in enumerate(chunks):
            by_rank[g.order[m]] = c
        send = torch.stack([c.contiguous() for c in by_rank])
        staged = _staged(x, g.pg)
        if staged:
            send = _host(send)
        out = torch.empty_like(send)
        _transport(_dist().all_to_all_single, out, send, group=g.pg)
        if staged:
            out = out.to(x.device)
        return [out[g.order[m]] for m in range(n)]
    me = g.index
    return [p.chunk(n, dim=split_axis)[me] for p in g.exchange(x)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tiled):
        ctx.args = (group, split_axis, concat_axis, tiled)
        return _all_to_all(x, group, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, tiled = ctx.args
        if tiled:
            back = _all_to_all(g.contiguous(), group, concat_axis,
                               split_axis, True)
        else:
            # the forward removed ``split_axis`` and added ``concat_axis``
            back = _all_to_all(g.contiguous(), group, concat_axis,
                               split_axis, False)
        return back, None, None, None, None


def all_to_all(x, group, split_axis, concat_axis, tiled=True):
    """``lax.all_to_all``: ``x`` split into ``n`` chunks along
    ``split_axis``, chunk ``m`` sent to member ``m``, the chunks received
    concatenated in member order along ``concat_axis`` (``tiled``), or,
    untiled, a ``split_axis`` of size ``n`` traded for a new
    ``concat_axis``. Differentiable: the backward is the reverse
    ``all_to_all``."""
    if _grad_on(x):
        return _AllToAll.apply(x, group, split_axis, concat_axis, tiled)
    return _all_to_all(x, group, split_axis, concat_axis, tiled)
