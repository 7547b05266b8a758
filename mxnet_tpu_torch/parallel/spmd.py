"""The SPMD train step, on one device so far.

Counterpart of ``mxnet_tpu/parallel/spmd.py`` (``SPMDTrainer`` and
``shard_params_rule``). The JAX trainer compiles loss, gradient and
optimizer update into one jitted program with donated buffers and lets
GSPMD place every array by its ``PartitionSpec``. Here the step runs
eagerly on the mesh's one device: ``loss = apply_fn(params, *batch)``,
``torch.autograd.grad``, then the optimizer kernel per parameter.
Specs are accepted and checked against the mesh; sharding across cards
comes with the distributed slice (ROADMAP queue 6), and one captured
CUDA graph per step (the counterpart of jit plus donation) is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..weights import tree_from_numpy
from .mesh import PartitionSpec as P

__all__ = ["SPMDTrainer", "shard_params_rule"]


def shard_params_rule(params, mesh, tp_axis=None):
    """Default parameter specs: replicate 1-D params; shard dim 0 of
    matrices over ``tp_axis`` when it divides evenly (the reference's
    Megatron-style column split)."""
    specs = {}
    tp = mesh.shape[tp_axis] if tp_axis else 1
    for name, arr in params.items():
        shape = tuple(arr.shape)
        if tp_axis and len(shape) >= 2 and shape[0] % tp == 0 \
                and shape[0] >= tp:
            specs[name] = P(tp_axis, *([None] * (len(shape) - 1)))
        elif tp_axis and len(shape) == 1 and shape[0] % tp == 0 \
                and shape[0] >= 128:
            specs[name] = P(tp_axis)
        else:
            specs[name] = P()
    return specs


def _check_spec(what, spec, mesh, ndim=None):
    spec = P(*spec) if not isinstance(spec, P) else spec
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None and ax not in mesh.shape:
                raise MXNetError("%s: spec %r names axis %r, the mesh has %s"
                                 % (what, spec, ax, tuple(mesh.shape)))
    if ndim is not None and len(spec) > ndim:
        raise MXNetError("%s: spec %r has more entries than the %d-D array"
                         % (what, spec, ndim))
    return spec


class SPMDTrainer:
    """Run a train step on a mesh (one device so far).

    Parameters
    ----------
    apply_fn : fn(params_dict, *batch_tensors) -> scalar loss tensor
    params : dict name -> numpy array or tensor (initial values); copied
        onto the mesh's device
    mesh : ``parallel.Mesh``
    data_axis : mesh axis the batch is laid out over
    tp_axis : optional mesh axis for tensor-parallel parameter specs
    optimizer : name or ``mx.optimizer`` instance (``sgd``, ``nag``)
    """

    def __init__(self, apply_fn, params, mesh, data_axis="dp", tp_axis=None,
                 optimizer="sgd", learning_rate=0.01, momentum=0.0, wd=0.0,
                 param_specs=None, batch_specs=None, n_batch_args=2,
                 **optimizer_kwargs):
        from . import opt_kernels
        from .. import optimizer as opt_mod
        self.mesh = mesh
        self.data_axis = data_axis
        self._apply = apply_fn
        if not isinstance(optimizer, opt_mod.Optimizer):
            okw = dict(optimizer_kwargs)
            okw.setdefault("learning_rate", learning_rate)
            okw.setdefault("wd", wd)
            if momentum:
                okw.setdefault("momentum", momentum)
            optimizer = opt_mod.create(optimizer, **okw)
        kname, hyper = opt_kernels.hyper_from_optimizer(optimizer)
        init_fn, self._update_fn = opt_kernels.get_kernel(kname)
        self.lr = hyper["lr"]
        self.momentum = hyper.get("momentum", 0.0)
        self.wd = hyper["wd"]
        self._hyper = hyper
        self._num_update = 0

        if param_specs is None:
            param_specs = shard_params_rule(params, mesh, tp_axis)
        missing = sorted(set(params) - set(param_specs))
        if missing:
            raise MXNetError("SPMDTrainer: no param_specs for %s" % missing)
        self.param_specs = {k: _check_spec("param %r" % k, param_specs[k],
                                           mesh, len(params[k].shape))
                            for k in params}
        if batch_specs is None:
            batch_specs = [P(data_axis)] * n_batch_args
        self.batch_specs = [_check_spec("batch arg %d" % i, s, mesh)
                            for i, s in enumerate(batch_specs)]

        self.device = mesh.torch_device()
        self.params = tree_from_numpy(params, ctx=mesh.device)
        self.opt_state = {k: tuple(init_fn(v))
                          for k, v in self.params.items()}

    @property
    def mom(self):
        """SGD momentum state by parameter name (None without momentum)."""
        if not self.momentum:
            return None
        return {k: s[0] for k, s in self.opt_state.items()}

    def _put(self, i, b):
        from ..ndarray.ndarray import NDArray
        if isinstance(b, NDArray):
            b = b._data
        elif not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        _check_spec("batch arg %d" % i, self.batch_specs[i], self.mesh,
                    b.ndim)
        return b.to(self.device)

    def step(self, *batch):
        """Run one train step; returns the scalar loss (a detached
        tensor)."""
        if len(batch) != len(self.batch_specs):
            raise MXNetError("SPMDTrainer.step: %d batch args, %d batch "
                             "specs" % (len(batch), len(self.batch_specs)))
        batch = [self._put(i, b) for i, b in enumerate(batch)]
        self._num_update += 1
        names = list(self.params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        loss = self._apply(leaves, *batch)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        h = dict(self._hyper)
        h["lr"] = self.lr
        new_params, new_state = {}, {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = self.params[k]
                new_params[k], new_state[k] = self._update_fn(
                    p, g if g is not None else torch.zeros_like(p),
                    self.opt_state[k], self._num_update, h)
        self.params, self.opt_state = new_params, new_state
        return loss.detach()

    def get_params(self):
        """The parameters as numpy arrays (bfloat16 widens to float32)."""
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy() for k, v in self.params.items()}
