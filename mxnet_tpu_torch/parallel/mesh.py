"""Device meshes, one device for now.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. A :class:`Mesh` names its
axes and holds the port ``Context``s it spans. This slice runs on one
device: a mesh whose axes multiply to more than one device raises
``MXNetError`` until the distributed slice (ROADMAP queue 6), where
``torch.distributed`` takes over.
"""
from __future__ import annotations

import math

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["Mesh", "PartitionSpec", "P", "make_mesh", "default_mesh"]


class PartitionSpec(tuple):
    """One mesh-axis name (or None) per array dimension, like
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


P = PartitionSpec


class Mesh:
    """Named axes over a list of port Contexts.

    ``shape`` maps each axis name to its size (in axis order),
    ``devices`` lists the Contexts and ``device`` is the one Context of
    a one-device mesh.
    """

    def __init__(self, devices, axes):
        self.devices = list(devices)
        self.shape = dict(axes)
        if math.prod(self.shape.values()) != len(self.devices):
            raise MXNetError("mesh axes %s do not cover %d device(s)"
                             % (self.shape, len(self.devices)))

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        if self.size != 1:
            raise MXNetError("mesh of %d devices has no single device"
                             % self.size)
        return self.devices[0]

    def torch_device(self):
        return self.device.torch_device()

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, self.devices)


def make_mesh(axes, devices=None):
    """A Mesh from ``{axis_name: size}`` over ``devices`` (port Contexts,
    default ``[gpu(0)]``). One size may be -1 to absorb the devices left.
    Every device is resolved now, so a ``gpu`` mesh without a CUDA device
    raises here; so does a mesh of more than one device."""
    devices = list(devices) if devices is not None else [gpu(0)]
    for d in devices:
        if not isinstance(d, Context):
            raise MXNetError("make_mesh: devices must be Contexts, got %r"
                             % (d,))
    names, sizes = list(axes), [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise MXNetError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if known <= 0 or len(devices) % known != 0:
            raise MXNetError("device count %d not divisible by %d"
                             % (len(devices), known))
        sizes[sizes.index(-1)] = len(devices) // known
    total = math.prod(sizes)
    if total > 1:
        raise MXNetError(
            "make_mesh: a mesh of %d devices (%s) needs the distributed "
            "slice (ROADMAP queue 6, torch.distributed); this port runs "
            "meshes of one device" % (total, dict(zip(names, sizes))))
    if total < 1 or not devices:
        raise MXNetError("make_mesh: axes %s over %d device(s) hold no "
                         "device" % (dict(zip(names, sizes)), len(devices)))
    devices = devices[:1]
    for d in devices:
        d.torch_device()           # raises for a gpu without a CUDA device
    return Mesh(devices, dict(zip(names, sizes)))


def default_mesh(data_axis="dp"):
    """All devices of the default context list on one data-parallel
    axis (one device here)."""
    return make_mesh({data_axis: -1})
