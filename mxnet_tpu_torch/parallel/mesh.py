"""Device meshes: a data-parallel axis over Contexts and processes.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (``make_mesh``,
``default_mesh``, ``mesh_from_contexts``, ``barrier``). A :class:`Mesh`
names its axes, holds this process's Contexts and the number of
processes it spans. The ``dp`` axis may span several Contexts in one
process (``cpu(0)``, ``cpu(1)`` are two Contexts even though both are
the host, as the JAX package's virtual CPU devices are two devices) or
one Context per process across the processes of a launched job
(``launch.py``); its collectives then run over ``torch.distributed``'s
default group (``collectives.py``). Duplicate Contexts raise. Any other
axis wider than one device waits for ROADMAP Queue 1 item 4, second
half (sequence and model parallelism across devices).
"""
from __future__ import annotations

import math

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["Mesh", "PartitionSpec", "P", "make_mesh", "default_mesh",
           "mesh_from_contexts", "barrier", "DP_AXIS"]

DP_AXIS = "dp"
_SECOND_HALF = "ROADMAP Queue 1 item 4, second half"


class PartitionSpec(tuple):
    """One mesh-axis name (or None) per array dimension, like
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


P = PartitionSpec


class Mesh:
    """Named axes over this process's Contexts and ``processes`` processes.

    ``shape`` maps each axis name to its global size (in axis order),
    ``devices`` lists this process's Contexts, ``processes`` how many
    processes the mesh spans (each contributing as many Contexts), and
    ``device`` is the one Context of a mesh with one local device.
    """

    def __init__(self, devices, axes, processes=1):
        self.devices = list(devices)
        self.shape = dict(axes)
        self.processes = int(processes)
        if math.prod(self.shape.values()) != len(self.devices) \
                * self.processes:
            raise MXNetError("mesh axes %s do not cover %d device(s) on %d "
                             "process(es)" % (self.shape, len(self.devices),
                                              self.processes))

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

    @property
    def device(self):
        if len(self.devices) != 1:
            raise MXNetError("mesh of %d local devices has no single device"
                             % len(self.devices))
        return self.devices[0]

    def torch_device(self):
        return self.device.torch_device()

    def __repr__(self):
        return "Mesh(%s, %s, processes=%d)" % (self.shape, self.devices,
                                               self.processes)


def _check_contexts(devices):
    for d in devices:
        if not isinstance(d, Context):
            raise MXNetError("mesh devices must be Contexts, got %r" % (d,))
    if len(set(devices)) != len(devices):
        raise MXNetError("duplicate devices in context list %s"
                         % (list(devices),))


def _check_axes(shape):
    wide = {a: s for a, s in shape.items() if s > 1 and a != DP_AXIS}
    if wide:
        raise MXNetError(
            "mesh axes %s: only the %r axis may span more than one device; "
            "sequence and model parallelism across devices are not ported "
            "yet (%s)" % (wide, DP_AXIS, _SECOND_HALF))


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


def make_mesh(axes, devices=None):
    """A Mesh from ``{axis_name: size}`` over ``devices`` (this process's
    Contexts, default ``[gpu(0)]``). One size may be -1 to absorb the
    devices left. In a launched job of N processes the axes may cover
    ``N x len(devices)`` devices: the mesh then spans the processes.
    Every device is resolved now, so a ``gpu`` mesh without a CUDA
    device raises here."""
    from .. import dist
    devices = list(devices) if devices is not None else [gpu(0)]
    _check_contexts(devices)
    names, sizes = list(axes), [int(s) for s in axes.values()]
    nproc = dist.process_count() if dist.initialized() else 1
    known = math.prod(s for s in sizes if s != -1)
    if nproc > 1 and (known == len(devices) * nproc
                      or (-1 in sizes and known <= len(devices) * nproc)):
        shape = _resolve(names, sizes, len(devices) * nproc)
    else:
        nproc = 1
        shape = _resolve(names, sizes, len(devices))
    total = math.prod(shape.values())
    if total < 1 or not devices:
        raise MXNetError("make_mesh: axes %s over %d device(s) hold no "
                         "device" % (shape, len(devices)))
    if total > len(devices) * nproc:
        raise MXNetError("mesh needs %d devices, have %d"
                         % (total, len(devices) * nproc))
    _check_axes(shape)
    devices = devices[:total // nproc]
    for d in devices:
        d.torch_device()           # raises for a gpu without a CUDA device
    return Mesh(devices, shape, nproc)


def default_mesh(data_axis=DP_AXIS):
    """Every device of the default context list, on every process of a
    launched job, on one data-parallel axis."""
    return make_mesh({data_axis: -1})


def mesh_from_contexts(contexts, axis=DP_AXIS, axes=None, processes=1):
    """A one-axis data-parallel Mesh over a Module-style context list
    (``processes`` > 1: the same list on each process of a job).
    ``axes`` (an ordered ``{name: size}``, one size may be -1) folds the
    list into several axes, of which only ``dp`` may be wider than 1."""
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
    _check_axes(shape)
    return Mesh(contexts, shape, processes)


def barrier():
    """Block until every process of the job gets here (a no-op in a
    one-process run)."""
    from .. import dist
    if dist.initialized() and dist.process_count() > 1:
        import torch.distributed as tdist
        tdist.barrier()
