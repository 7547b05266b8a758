"""Device contexts.

Counterpart of ``mxnet_tpu/context.py``. A Context names a
``torch.device``: ``gpu(i)`` is CUDA device ``i`` and ``cpu()`` the host.
The default context is ``gpu(0)``: an entry point that finds no CUDA
device raises ``MXNetError`` unless the caller passed ``ctx=cpu()``.
There is no silent CPU fallback.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "current_context",
           "num_gpus"]


class Context:
    """A device context (comparable, hashable)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def torch_device(self):
        """The ``torch.device`` of this context. A ``gpu`` context with no
        CUDA device present raises instead of falling back to the CPU."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %r: no CUDA device is present; pass ctx=mx.cpu() "
                "to run on the host" % (self,))
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %r: only %d CUDA device(s)"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def cpu_pinned(device_id=0):
    """Host memory for staging transfers: the host device (PyTorch pins
    its own staging buffers)."""
    return Context("cpu_pinned", device_id)


def tpu(device_id=0):
    """The port has no TPU: this raises, naming ``mx.gpu``. Standing in
    for the GPU in silence would hide which device a program runs on."""
    raise MXNetError("mx.tpu(%d): the PyTorch port runs on CUDA devices; "
                     "use mx.gpu(%d)" % (device_id, device_id))


def num_gpus():
    """The number of CUDA devices (parity: mx.context.num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The default context: ``gpu(0)``."""
    return gpu(0)


def context_of(tensor):
    """The Context a torch tensor lives on."""
    if tensor.device.type == "cuda":
        return gpu(tensor.device.index or 0)
    return cpu()
