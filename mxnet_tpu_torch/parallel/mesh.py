"""Device meshes: named axes over Contexts and worker processes.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (``make_mesh``,
``default_mesh``, ``mesh_from_contexts``, ``barrier``). A :class:`Mesh`
names its axes, holds this process's Contexts and the number of
processes it spans. Device ``g`` of the whole mesh is this process's
Context ``j`` on process ``r`` with ``g = r * len(devices) + j``, and its
coordinate is the one ``np.array(devices).reshape(sizes)`` gives device
``g`` in the JAX package (``cpu(0)``, ``cpu(1)`` are two devices even
though both are the host, as the JAX package's virtual CPU devices are).

SPMD. The JAX package runs one program over the whole mesh; here every
device of the mesh runs the same Python code on its own shard (a
*member*): one member per worker process, and one thread per Context
inside a process (:meth:`Mesh.run_local`). Members meet in collectives
over the *line* of an axis through them (:meth:`Mesh.group`, an
:class:`AxisGroup`; a tuple of axes names the plane they span):

- the members of a line inside one process exchange tensors through a
  shared rendezvous (a barrier and one slot per member);
- a line of one member per process runs over its own
  ``torch.distributed`` subgroup; every process creates every subgroup of
  an axis, in one order, the first time any member asks for the axis
  (``new_group`` is a collective of the default group);
- a line with several members on each of several processes combines
  both: the members of each process meet, and the first of them
  exchanges its process's tensors with the other processes.

Duplicate Contexts raise.
"""
from __future__ import annotations

import math
import threading

import numpy as np

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["Mesh", "AxisGroup", "PartitionSpec", "P", "make_mesh",
           "default_mesh", "mesh_from_contexts", "job_processes", "barrier",
           "DP_AXIS"]

DP_AXIS = "dp"
# seconds a member waits at an in-process rendezvous before it gives up
RENDEZVOUS_TIMEOUT_S = 600.0


class PartitionSpec(tuple):
    """One mesh-axis name (or None, or a tuple of names) per array
    dimension, like ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


P = PartitionSpec


class _Rendezvous:
    """The members of one line inside this process: each puts its tensor
    in its slot, and every member reads every slot between two barriers
    (the second keeps a slot from being overwritten before all read)."""

    def __init__(self, n, aborted=None):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)
        self.shared = None
        self.aborted = aborted          # the mesh's: a member has failed

    def _wait(self):
        try:
            if self.aborted is not None and self.aborted.is_set():
                raise threading.BrokenBarrierError
            self.barrier.wait(RENDEZVOUS_TIMEOUT_S)
        except threading.BrokenBarrierError:
            raise MXNetError("mesh: a member of this process left a "
                             "collective (it failed, or waited more than "
                             "%gs)" % RENDEZVOUS_TIMEOUT_S) from None

    def exchange(self, i, x):
        self.slots[i] = x
        self._wait()
        got = list(self.slots)
        self._wait()
        return got

    def share(self, i, make):
        """Member 0 runs ``make()``; every member gets its value."""
        if i == 0:
            self.shared = make()
        self._wait()
        got = self.shared
        self._wait()
        return got


class _Line:
    """The devices of one line of an axis (or plane of several axes), in
    ascending global index: which are this process's, which processes
    hold the rest, and how they meet."""

    def __init__(self, mesh, members):
        self.members = tuple(members)              # global device indices
        nl = len(mesh.devices)
        self.procs = sorted({g // nl for g in self.members})
        self.local = [g for g in self.members if g // nl == mesh.rank]
        per = {p: sum(1 for g in self.members if g // nl == p)
               for p in self.procs}
        if len(set(per.values())) != 1:
            raise MXNetError("mesh %s: line %s has an uneven number of "
                             "devices on each process" % (mesh.shape,
                                                          self.members))
        self.rv = _Rendezvous(len(self.local), mesh._aborted) \
            if len(self.local) > 1 else None
        self.pg = None                  # set by Mesh._make_groups
        self.spans = len(self.procs) > 1

    def canon(self, g):
        return self.members.index(g)

    def local_pos(self, g):
        return self.local.index(g)


class AxisGroup:
    """One member's view of the line of ``axes`` through it: ``size``
    members, this one at ``index`` (row-major over ``axes`` in the order
    given). The collectives of ``collectives.py`` take it as their
    ``group``."""

    def __init__(self, mesh, axes, line, me, order):
        self.mesh, self.axes, self.line = mesh, axes, line
        self.me = me                      # this member's global index
        self.order = order                # member index -> canonical index
        self.size = len(order)
        self.index = order.index(line.canon(me))
        self.device = mesh.devices[me % len(mesh.devices)].torch_device()

    def __repr__(self):
        return "AxisGroup(%s, %d of %d)" % (self.axes, self.index, self.size)

    # -- the transport: canonical order in, canonical order out -----------
    def exchange(self, x):
        """Every member's ``x`` (same shape and dtype on every member), in
        member order, on this member's device."""
        from . import collectives as C
        line = self.line
        x = x.detach()
        if not line.spans:
            got = line.rv.exchange(line.local_pos(self.me), x) \
                if line.rv is not None else [x]
        elif line.rv is None:
            got = C._pg_all_gather(x, line.pg)
        else:
            pos = line.local_pos(self.me)
            mine = line.rv.exchange(pos, x)

            def gather():
                import torch
                stacked = torch.stack([t.to(x.device) for t in mine])
                return [t for part in C._pg_all_gather(stacked, line.pg)
                        for t in part.unbind(0)]
            got = line.rv.share(pos, gather)
        return [got[c].to(self.device, copy=True) for c in self.order]

    def uses_process_group(self):
        """Whether the line is one member per process (the torch
        collectives run over ``self.line.pg`` directly)."""
        return self.line.spans and self.line.rv is None


class Mesh:
    """Named axes over this process's Contexts and ``processes`` processes.

    ``shape`` maps each axis name to its global size (in axis order),
    ``devices`` lists this process's Contexts, ``processes`` how many
    processes the mesh spans (each contributing as many Contexts) and
    ``rank`` this process's index among them. ``device`` is the Context
    of the member running the calling code.
    """

    def __init__(self, devices, axes, processes=1, rank=0):
        self.devices = list(devices)
        self.shape = dict(axes)
        self.processes = int(processes)
        self.rank = int(rank) if self.processes > 1 else 0
        if math.prod(self.shape.values()) != len(self.devices) \
                * self.processes:
            raise MXNetError("mesh axes %s do not cover %d device(s) on %d "
                             "process(es)" % (self.shape, len(self.devices),
                                              self.processes))
        self._sizes = tuple(self.shape.values())
        self._local = threading.local()
        self._lock = threading.Lock()
        self._lines = {}          # axes tuple -> {global index: _Line}
        self._pgs = {}            # members tuple -> torch group (or None)
        # set while a failed member's run is ending: a rendezvous made or
        # entered after the failure breaks at once instead of waiting
        self._aborted = threading.Event()

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self):
        """Devices in the whole mesh (every process)."""
        return len(self.devices) * self.processes

    @property
    def is_process_spanning(self):
        return self.processes > 1

    # -- members ------------------------------------------------------------
    def _member(self):
        """The local index of the member running the calling code."""
        j = getattr(self._local, "j", None)
        if j is None:
            if len(self.devices) != 1:
                raise MXNetError(
                    "mesh of %d local devices: run per-device code through "
                    "Mesh.run_local (or SPMDTrainer)" % len(self.devices))
            return 0
        return j

    def global_index(self, j=None):
        j = self._member() if j is None else j
        return self.rank * len(self.devices) + j

    def coords(self, j=None):
        """``{axis: coordinate}`` of a local member (default: the calling
        one)."""
        c = np.unravel_index(self.global_index(j), self._sizes)
        return {a: int(i) for a, i in zip(self.shape, c)}

    def axis_index(self, axis):
        """The calling member's coordinate on ``axis`` (a tuple of axes:
        the row-major index over them)."""
        axes = _axes_tuple(axis)
        c = self.coords()
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def axis_size(self, axis):
        return math.prod(self.shape[a] for a in _axes_tuple(axis))

    @property
    def device(self):
        """The Context of the calling member."""
        return self.devices[self._member()]

    def torch_device(self):
        return self.device.torch_device()

    def run_local(self, fn):
        """``fn(j)`` once for each local device ``j``: member 0 on the
        calling thread, every other member in a thread of its own that
        the mesh knows as member ``j``; returns the results in device
        order. A member that raises breaks the other members'
        collectives, and its exception is raised here."""
        n = len(self.devices)
        prev = getattr(self._local, "j", None)
        if n == 1:
            self._local.j = 0
            try:
                return [fn(0)]
            finally:
                self._local.j = prev
        out, errs = [None] * n, [None] * n

        def body(j):
            self._local.j = j
            try:
                out[j] = fn(j)
            except BaseException as e:        # noqa: BLE001 -- re-raised
                errs[j] = e
                self._abort()
            finally:
                self._local.j = None
        threads = [threading.Thread(target=body, args=(j,), daemon=True,
                                    name="mesh-member-%d" % j)
                   for j in range(1, n)]
        for t in threads:
            t.start()
        try:
            body(0)
        finally:
            self._local.j = prev
        for t in threads:
            t.join()
        failed = [e for e in errs if e is not None]
        if failed:
            self._reset()
            first = next((e for e in failed
                          if not isinstance(e, MXNetError)
                          or "left a collective" not in str(e)), failed[0])
            raise first
        return out

    def _rendezvous(self):
        with self._lock:
            return [ln.rv for lines in self._lines.values()
                    for ln in lines.values() if ln.rv is not None]

    def _abort(self):
        self._aborted.set()
        for rv in self._rendezvous():
            rv.barrier.abort()

    def _reset(self):
        self._aborted.clear()
        for rv in self._rendezvous():
            rv.barrier.reset()

    # -- lines and groups -----------------------------------------------------
    def _lines_of(self, axes):
        with self._lock:
            got = self._lines.get(axes)
            if got is not None:
                return got
            idx = np.arange(self.size).reshape(self._sizes)
            pos = [list(self.shape).index(a) for a in axes]
            rest = [i for i in range(len(self._sizes)) if i not in pos]
            moved = np.transpose(idx, rest + sorted(pos)).reshape(
                -1, math.prod(self._sizes[i] for i in pos))
            lines = {}
            for row in moved:
                line = _Line(self, sorted(int(g) for g in row))
                for g in line.members:
                    lines[g] = line
            self._make_groups(lines)
            self._lines[axes] = lines
            return lines

    def _make_groups(self, lines):
        """One torch subgroup per line that spans processes, created on
        every process in the same order (every line of the axes,
        ascending); a line of every process in rank order is the default
        group."""
        if self.processes == 1:
            return
        import torch.distributed as tdist
        seen = []
        for line in lines.values():
            if line in seen:
                continue
            seen.append(line)
            if not line.spans:
                continue
            key = line.members
            if key not in self._pgs:
                if line.procs == list(range(self.processes)) \
                        and tdist.get_world_size() == self.processes:
                    self._pgs[key] = None
                else:
                    self._pgs[key] = tdist.new_group(ranks=line.procs)
            line.pg = self._pgs[key]

    def group(self, axis):
        """The calling member's :class:`AxisGroup` over ``axis`` (a name
        or a tuple of names)."""
        axes = _axes_tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise MXNetError("mesh has no axis %r (axes %s)"
                                 % (a, tuple(self.shape)))
        me = self.global_index()
        line = self._lines_of(tuple(sorted(axes, key=list(self.shape).index)))[me]
        # member order: row-major over ``axes`` as given
        coords = [np.unravel_index(g, self._sizes) for g in line.members]
        names = list(self.shape)
        key = [tuple(int(c[names.index(a)]) for a in axes) for c in coords]
        order = sorted(range(len(line.members)), key=lambda i: key[i])
        return AxisGroup(self, axes, line, me, order)

    def __repr__(self):
        return "Mesh(%s, %s, processes=%d)" % (self.shape, self.devices,
                                               self.processes)


def _axes_tuple(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _check_contexts(devices):
    for d in devices:
        if not isinstance(d, Context):
            raise MXNetError("mesh devices must be Contexts, got %r" % (d,))
    if len(set(devices)) != len(devices):
        raise MXNetError("duplicate devices in context list %s"
                         % (list(devices),))


def _resolve(names, sizes, n):
    if sizes.count(-1) > 1:
        raise MXNetError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if known <= 0 or n % known != 0:
            raise MXNetError("device count %d not divisible by %d"
                             % (n, known))
        sizes[sizes.index(-1)] = n // known
    return dict(zip(names, sizes))


def _job():
    """(processes, this process's rank) of the launched job."""
    from .. import dist
    if dist.initialized():
        return dist.process_count(), dist.rank()
    return 1, 0


def job_processes(axes, n_local):
    """How many processes a mesh of ``axes`` over ``n_local`` Contexts a
    process spans: every process of a launched job when the axes cover
    its Contexts on each of them (or one axis is -1), else 1."""
    nproc = _job()[0]
    sizes = [int(s) for s in axes.values()]
    known = math.prod(s for s in sizes if s != -1)
    if nproc > 1 and (known == n_local * nproc
                      or (-1 in sizes and known <= n_local * nproc)):
        return nproc
    return 1


def make_mesh(axes, devices=None):
    """A Mesh from ``{axis_name: size}`` over ``devices`` (this process's
    Contexts, default ``[gpu(0)]``). One size may be -1 to absorb the
    devices left. In a launched job of N processes the axes may cover
    ``N x len(devices)`` devices: the mesh then spans the processes.
    Every device is resolved now, so a ``gpu`` mesh without a CUDA
    device raises here."""
    devices = list(devices) if devices is not None else [gpu(0)]
    _check_contexts(devices)
    names, sizes = list(axes), [int(s) for s in axes.values()]
    nproc = job_processes(axes, len(devices))
    rank = _job()[1] if nproc > 1 else 0
    shape = _resolve(names, sizes, len(devices) * nproc)
    total = math.prod(shape.values())
    if total < 1 or not devices:
        raise MXNetError("make_mesh: axes %s over %d device(s) hold no "
                         "device" % (shape, len(devices)))
    if total > len(devices) * nproc:
        raise MXNetError("mesh needs %d devices, have %d"
                         % (total, len(devices) * nproc))
    devices = devices[:total // nproc]
    for d in devices:
        d.torch_device()           # raises for a gpu without a CUDA device
    return Mesh(devices, shape, nproc, rank)


def default_mesh(data_axis=DP_AXIS):
    """Every device of the default context list, on every process of a
    launched job, on one data-parallel axis."""
    return make_mesh({data_axis: -1})


def mesh_from_contexts(contexts, axis=DP_AXIS, axes=None, processes=1):
    """A Mesh over a Module-style context list (``processes`` > 1: the
    same list on each process of a job): one ``axis`` over all of them,
    or ``axes`` (an ordered ``{name: size}``, one size may be -1) folding
    them into several axes."""
    contexts = list(contexts)
    _check_contexts(contexts)
    n = len(contexts) * int(processes)
    if axes is None:
        shape = {axis: n}
    else:
        shape = _resolve(list(axes), [int(s) for s in axes.values()], n)
        if math.prod(shape.values()) != n:
            raise MXNetError("mesh axes %s need %d devices, context list "
                             "has %d" % (shape, math.prod(shape.values()), n))
    rank = _job()[1] if int(processes) > 1 else 0
    return Mesh(contexts, shape, processes, rank)


def barrier():
    """Block until every process of the job gets here (a no-op in a
    one-process run)."""
    from .. import dist
    if dist.initialized() and dist.process_count() > 1:
        import torch.distributed as tdist
        tdist.barrier()
