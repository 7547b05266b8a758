"""The SPMD train step and the data-parallel layout.

Counterpart of ``mxnet_tpu/parallel/spmd.py`` (``SPMDTrainer``,
``shard_params_rule``, ``dp_spec``, ``dist_dp_spec``,
``broadcast_from_zero``, ``check_batch_divisible``). The JAX trainer
compiles loss, gradient and optimizer update into one jitted program
and lets GSPMD place every array and insert the gradient all-reduce.
Here the step runs eagerly: on a mesh of one device, ``loss =
apply_fn(params, *batch)``, ``torch.autograd.grad`` and the optimizer
kernel per parameter. On a ``dp`` axis wider than one device (several
Contexts in this process, or one per worker process of a launched job,
or both) every device keeps a replica of the parameters and runs
``apply_fn`` on its rows of the global batch; the replicas' gradients
are summed on this process's first device, summed over the processes
with the losses in ONE bucketed all-reduce and divided by the ``dp``
size (``apply_fn`` averages over its rows: the mean of equal shards'
means is the JAX trainer's mean over the global batch), and the update
runs once per process and is copied to the other local replicas.
``apply_fn`` sees only its replica's rows: a function that mixes rows
(batch statistics) computes them per replica here, over the global
batch in the JAX trainer (ROADMAP Queue 3, open fault 1). Every
process starts from rank 0's parameters (``broadcast_from_zero``), so
the replicas stay equal bit for bit. One captured CUDA graph per step
(the counterpart of jit plus donation) is later work.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..base import MXNetError
from ..weights import tree_from_numpy
from .mesh import PartitionSpec as P, DP_AXIS, mesh_from_contexts

__all__ = ["SPMDTrainer", "shard_params_rule", "DataParallelSpec",
           "dp_spec", "dist_dp_spec", "check_batch_divisible", "broadcast_from_zero", "local_rows",
           "DP_AXIS", "MP_AXIS"]

MP_AXIS = "mp"


class DataParallelSpec(collections.namedtuple("DataParallelSpec",
                                              ["mesh", "data_axis"])):
    """A data-parallel layout: the mesh and the axis the batch splits
    over (parameters are replicated)."""
    __slots__ = ()

    @property
    def num_devices(self):
        return self.mesh.size

    @property
    def dp_size(self):
        """What the global batch must divide by."""
        return int(self.mesh.shape.get(self.data_axis, 1))


def dp_spec(mesh, data_axis=DP_AXIS):
    """DataParallelSpec for a one-axis data-parallel mesh."""
    if data_axis not in mesh.shape:
        raise MXNetError("dp_spec: mesh %s has no %r axis"
                         % (tuple(mesh.shape), data_axis))
    return DataParallelSpec(mesh, data_axis)


def dist_dp_spec(contexts, data_axis=DP_AXIS):
    """The process-spanning spec: this process's ``contexts`` on each
    worker of the job, one ``dp`` axis over all of them (workers bind
    the same number of contexts)."""
    from .. import dist
    return dp_spec(mesh_from_contexts(contexts, axis=data_axis,
                                      processes=dist.process_count()),
                   data_axis)


def check_batch_divisible(batch_dim, n_devices, what="batch size",
                          axis=None):
    """The one owner of the dp divisibility rule: bind-time checks and
    per-step feeds raise the same error instead of padding."""
    if batch_dim % n_devices != 0:
        if axis is not None:
            raise MXNetError(
                "%s %d not divisible by the %r mesh axis (size %d; the "
                "batch shards over %r only, not over every device)"
                % (what, batch_dim, axis, n_devices, axis))
        raise MXNetError("%s %d not divisible by %d devices"
                         % (what, batch_dim, n_devices))


def broadcast_from_zero(tree):
    """Rank 0's values of a dict/list/tuple of tensors or numpy arrays on
    every process (one broadcast per leaf; the input unchanged outside a
    multi-process run)."""
    from . import collectives
    if collectives.world_size() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: broadcast_from_zero(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_zero(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return collectives.broadcast(torch.from_numpy(
            np.ascontiguousarray(tree))).numpy()
    return collectives.broadcast(tree)


def local_rows(batch_dim, spec):
    """The row slices of a global batch of ``batch_dim`` rows that this
    process's devices take, in mesh order (each device its contiguous
    shard)."""
    from .. import dist
    dp = spec.dp_size
    check_batch_divisible(batch_dim, dp, "batch size", axis=spec.data_axis)
    per = batch_dim // dp
    n_local = len(spec.mesh.devices)
    first = (dist.rank() if spec.mesh.processes > 1 else 0) * n_local
    return [slice((first + i) * per, (first + i + 1) * per)
            for i in range(n_local)]


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
    """Run a train step on a mesh: one device, or a ``dp`` axis over
    several Contexts and/or worker processes.

    Parameters
    ----------
    apply_fn : fn(params_dict, *batch_tensors) -> scalar loss tensor
    params : dict name -> numpy array or tensor (initial values); copied
        onto every device of the mesh in this process (rank 0's values
        on every process)
    mesh : ``parallel.Mesh``
    data_axis : mesh axis the batch is laid out over
    tp_axis : optional mesh axis for tensor-parallel parameter specs
    optimizer : name or ``mx.optimizer`` instance (``sgd``, ``nag``, ...)
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

        self._spec = dp_spec(mesh, data_axis) if data_axis in mesh.shape \
            else None
        self._devices = [d.torch_device() for d in mesh.devices]
        self.device = self._devices[0]
        if mesh.processes > 1:
            params = broadcast_from_zero(
                {k: (v if isinstance(v, (np.ndarray, torch.Tensor))
                     else np.asarray(v)) for k, v in params.items()})
        self.params = tree_from_numpy(params, ctx=mesh.devices[0])
        self._replicas = [self.params] + [
            {k: v.to(dev, copy=True) for k, v in self.params.items()}
            for dev in self._devices[1:]]
        self.opt_state = {k: tuple(init_fn(v))
                          for k, v in self.params.items()}

    @property
    def dp_size(self):
        return self._spec.dp_size if self._spec is not None else 1

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
        return b

    def _shards(self, batch):
        """Per local device, its rows of every batch argument laid out
        over the data axis (the whole argument where its spec is
        replicated)."""
        if self.dp_size == 1:
            return [[b.to(self.device) for b in batch]]
        out = [[] for _ in self._devices]
        for b, spec in zip(batch, self.batch_specs):
            split = len(spec) > 0 and spec[0] == self.data_axis
            rows = local_rows(b.shape[0], self._spec) if split else None
            for j, dev in enumerate(self._devices):
                out[j].append((b[rows[j]] if split else b).to(dev))
        return out

    def _grads(self, params, batch):
        names = list(params)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = self._apply(leaves, *batch)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        return loss.detach(), [g if g is not None else torch.zeros_like(p)
                               for g, p in zip(grads, params.values())]

    def step(self, *batch):
        """Run one train step on the global batch (each device takes its
        rows); returns the scalar loss (a detached tensor: the global
        batch's mean)."""
        if len(batch) != len(self.batch_specs):
            raise MXNetError("SPMDTrainer.step: %d batch args, %d batch "
                             "specs" % (len(batch), len(self.batch_specs)))
        batch = [self._put(i, b) for i, b in enumerate(batch)]
        self._num_update += 1
        names = list(self.params)
        losses, grads = [], None
        for replica, shard in zip(self._replicas, self._shards(batch)):
            loss, g = self._grads(replica, shard)
            losses.append(loss.to(self.device))
            grads = [x.to(self.device) for x in g] if grads is None else \
                [a + b.to(self.device) for a, b in zip(grads, g)]
        loss = torch.stack(losses).sum()
        if self.mesh.processes > 1:
            from ..kvstore import bucketed_all_reduce
            with torch.no_grad():
                reduced = bucketed_all_reduce(grads + [loss.reshape(1)])
            grads, loss = reduced[:-1], reduced[-1][0]
        if self.dp_size > 1:
            grads = [g / self.dp_size for g in grads]
            loss = loss / self.dp_size
        h = dict(self._hyper)
        h["lr"] = self.lr
        new_params, new_state = {}, {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                new_params[k], new_state[k] = self._update_fn(
                    self.params[k], g, self.opt_state[k], self._num_update,
                    h)
            self.params, self.opt_state = new_params, new_state
            self._replicas = [self.params] + [
                {k: v.to(dev, copy=True) for k, v in self.params.items()}
                for dev in self._devices[1:]]
        return loss.detach()

    def get_params(self):
        """The parameters as numpy arrays (bfloat16 widens to float32)."""
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy() for k, v in self.params.items()}
