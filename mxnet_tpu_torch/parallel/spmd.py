"""The SPMD train step and the mesh layouts.

Counterpart of ``mxnet_tpu/parallel/spmd.py`` (``SPMDTrainer``,
``shard_params_rule``, ``DataParallelSpec``, ``dp_spec``, ``rule_spec``,
``dist_dp_spec``, ``shard_put``, ``broadcast_from_zero``,
``check_batch_divisible``). The JAX trainer compiles loss, gradient and
optimizer update into one jitted program over global arrays and lets
GSPMD place every array and insert the collectives. Here every device of
the mesh is a member (``mesh.py``: one per worker process, one thread
per Context inside a process) that runs the step eagerly on its own
shard:

- it stores only its shards of each sharded parameter, and their
  optimizer state;
- it takes its block of every batch argument: ``P("dp", "sp")`` splits
  rows over ``dp`` and sequence positions over ``sp``;
- it gathers each sharded parameter for the forward (an ``all_gather``
  whose backward keeps this member's slice: along an axis that does not
  split the batch every member computes the same loss; along one that
  does, the slices' gradients are summed over it first);
- it runs ``apply_fn`` on its block, and ``torch.autograd.grad``;
- it averages loss and gradients over the axes that split the batch
  (one bucketed all-reduce per group of parameters placed alike),
  then runs the optimizer kernel on its shards.

The contract of ``apply_fn``. The JAX ``apply_fn`` is written over
global shapes and GSPMD partitions it. The port's ``apply_fn`` sees this
member's block (``batch`` rows of ``seq`` positions), so its shapes are
the local ones, and every operation that mixes rows or positions across
members goes through a mesh-aware op: ``ops.nn.batch_stats_over`` (batch
statistics), ``ring_attention``, ``ulysses_attention``, ``moe_ffn`` or
``pipeline_apply``. The results are the JAX trainer's. Members whose
coordinates differ only along axes that do not split the batch hold the
same loss; their gradients of a replicated parameter are averaged too,
which keeps every copy of a parameter equal bit for bit.

Every process of a launched job starts from rank 0's parameters
(``broadcast_from_zero``). ``step`` and ``get_params`` are collectives:
every process calls them.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

from ..base import MXNetError
from ..weights import tree_from_numpy
from . import collectives as C
from .mesh import PartitionSpec as P, DP_AXIS, mesh_from_contexts
from .partition import Placement, PartitionRules, sharding_for

__all__ = ["SPMDTrainer", "shard_params_rule", "DataParallelSpec",
           "dp_spec", "rule_spec", "dist_dp_spec", "check_batch_divisible",
           "shard_put", "broadcast_from_zero", "DP_AXIS", "MP_AXIS"]

# the model-parallel axis name the partition-rule engine shards over on a
# 2-D (dp, mp) mesh
MP_AXIS = "mp"


class DataParallelSpec(collections.namedtuple(
        "DataParallelSpec", ["mesh", "data_axis", "rules"],
        defaults=(DP_AXIS, None))):
    """One mesh layout: the mesh, the axis the batch splits over and,
    for a rule-sharded mesh, the ``PartitionRules`` that place each
    parameter (None: every parameter replicated)."""
    __slots__ = ()

    @property
    def num_devices(self):
        return self.mesh.size

    @property
    def dp_size(self):
        """What the batch dimension must divide by (the data axis, not
        the device count)."""
        return int(self.mesh.shape.get(self.data_axis, 1))

    @property
    def mp_size(self):
        """Product of the non-data axes (1 on a pure dp mesh)."""
        return self.num_devices // max(self.dp_size, 1)

    @property
    def data_sharding(self):
        return Placement(self.mesh, P(self.data_axis))

    @property
    def repl_sharding(self):
        return Placement(self.mesh, P())

    def param_sharding(self, name, shape):
        """The rule-resolved :class:`Placement` of one parameter (the
        replicated one when no rules are bound)."""
        if self.rules is None:
            return self.repl_sharding
        return sharding_for(self.mesh, name, shape,
                            self.rules.spec_for(name, shape))


def dp_spec(mesh, data_axis=DP_AXIS):
    """DataParallelSpec for a data-parallel mesh."""
    if data_axis not in mesh.shape:
        raise MXNetError("dp_spec: mesh %s has no %r axis"
                         % (tuple(mesh.shape), data_axis))
    return DataParallelSpec(mesh, data_axis)


def rule_spec(mesh, rules, data_axis=DP_AXIS):
    """Spec for a rule-sharded mesh: batch over ``data_axis``,
    parameters by the ``PartitionRules`` (None: replicate everything)."""
    if data_axis not in mesh.shape:
        raise MXNetError("rule_spec: mesh %s has no %r data axis"
                         % (tuple(mesh.shape), data_axis))
    return DataParallelSpec(mesh, data_axis, rules)


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
    """The one owner of the divisibility rule: bind-time checks and
    per-step feeds raise the same error instead of padding."""
    if batch_dim % n_devices != 0:
        if axis is not None:
            raise MXNetError(
                "%s %d not divisible by the %r mesh axis (size %d; the "
                "batch shards over %r only, not over every device)"
                % (what, batch_dim, axis, n_devices, axis))
        raise MXNetError("%s %d not divisible by %d devices"
                         % (what, batch_dim, n_devices))


def shard_put(raw, sharding):
    """The calling member's shard of a whole array (numpy, tensor or
    NDArray) placed by ``sharding`` (a :class:`Placement`), on the
    member's device: the counterpart of the JAX package's sharded
    ``device_put`` (each device receives only its shard)."""
    from .. import telemetry
    from ..ndarray.ndarray import NDArray
    with telemetry.span("shard_put"):
        if isinstance(raw, NDArray):
            raw = raw._data
        elif not isinstance(raw, torch.Tensor):
            raw = np.asarray(raw)
            telemetry.record_transfer(raw.nbytes)
            raw = torch.from_numpy(np.ascontiguousarray(raw))
        mesh = sharding.mesh
        _check_spec("shard_put", sharding.spec, mesh, raw.ndim)
        return sharding.shard(raw, mesh.coords()).to(mesh.torch_device())


def broadcast_from_zero(tree):
    """Rank 0's values of a dict/list/tuple of tensors or numpy arrays on
    every process (one broadcast per leaf; the input unchanged outside a
    multi-process run)."""
    if C.world_size() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: broadcast_from_zero(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_from_zero(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return C.broadcast(torch.from_numpy(
            np.ascontiguousarray(tree))).numpy()
    return C.broadcast(tree)


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


class _GatherShard(torch.autograd.Function):
    """A parameter's shards gathered along ``dim`` over ``group`` for the
    forward. The backward keeps this member's slice of the gradient,
    first summed over ``sum_group`` (the entry's axes that split the
    batch, whose members' losses differ)."""

    @staticmethod
    def forward(ctx, x, group, dim, sum_group):
        ctx.group, ctx.dim, ctx.sum_group = group, dim, sum_group
        return C._all_gather(x, group, dim, True)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_group is not None:
            g = C._all_reduce(g.contiguous(), ctx.sum_group, "sum")
        mine = g.chunk(ctx.group.size, dim=ctx.dim)[ctx.group.index]
        return mine.contiguous(), None, None, None


class SPMDTrainer:
    """Run a train step on a mesh: one device, or any axes over several
    Contexts and/or worker processes.

    Parameters
    ----------
    apply_fn : fn(params_dict, *batch_tensors) -> scalar loss tensor, on
        this member's block of the batch (see the module docstring); the
        parameters it gets are whole (sharded ones gathered)
    params : dict name -> numpy array or tensor (initial values; rank 0's
        on every process)
    mesh : ``parallel.Mesh``
    data_axis : mesh axis the default batch specs split rows over
    tp_axis : mesh axis of the default parameter specs
        (``shard_params_rule``)
    param_specs : {name: PartitionSpec} or a ``PartitionRules`` (whose
        specs downgrade to replicate where the mesh cannot place them)
    batch_specs : one PartitionSpec per batch argument (default
        ``P(data_axis)``); the axes they name split the batch
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
        elif isinstance(param_specs, PartitionRules):
            param_specs = {k: sharding_for(mesh, k, v.shape,
                                           param_specs.spec_for(k, v.shape))
                           .spec for k, v in params.items()}
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
        named = {a for s in self.batch_specs for e in s
                 for a in (e if isinstance(e, tuple) else (e,))
                 if a is not None}
        self.batch_axes = tuple(a for a in mesh.shape if a in named)
        self._n_batch = math.prod(mesh.shape[a] for a in self.batch_axes)
        self._placements = {k: Placement(mesh, s)
                            for k, s in self.param_specs.items()}
        for k, pl in self._placements.items():
            shape = tuple(params[k].shape)
            for dim in range(len(pl.spec)):
                n = mesh.axis_size(pl.split(dim)) if pl.split(dim) else 1
                if shape[dim] % n:
                    raise MXNetError(
                        "param %r: dim %d of size %d does not split over "
                        "%r (%d devices)" % (k, dim, shape[dim],
                                             pl.split(dim), n))
        if mesh.processes > 1:
            params = broadcast_from_zero(
                {k: (v if isinstance(v, (np.ndarray, torch.Tensor))
                     else np.asarray(v)) for k, v in params.items()})
        whole = tree_from_numpy(params, ctx=_cpu())
        self._members = mesh.run_local(
            lambda j: self._member_init(j, whole, init_fn))

    # -- members ------------------------------------------------------------
    def _member_init(self, j, whole, init_fn):
        mesh = self.mesh
        coords = mesh.coords(j)
        dev = mesh.devices[j].torch_device()
        params = {k: pl.shard(whole[k], coords).to(dev, copy=True)
                  .contiguous() for k, pl in self._placements.items()}
        # the groups every step uses, created now on every member in one
        # order (creating a process subgroup is a collective)
        gathers = {k: self._gather_plan(pl) for k, pl in
                   self._placements.items()}
        reduce_axes = {k: pl.replica_axes() for k, pl in
                       self._placements.items()}
        groups = {axes: mesh.group(axes) for axes in
                  sorted(set(reduce_axes.values()) | {self.batch_axes})
                  if axes and mesh.axis_size(axes) > 1}
        return {"params": params, "device": dev, "gathers": gathers,
                "reduce_axes": reduce_axes, "groups": groups,
                "state": {k: tuple(init_fn(v)) for k, v in params.items()}}

    def _gather_plan(self, pl):
        plan = []
        for dim in range(len(pl.spec)):
            axes = pl.split(dim)
            if not axes or self.mesh.axis_size(axes) == 1:
                continue
            summed = tuple(a for a in axes if a in self.batch_axes)
            plan.append((dim, self.mesh.group(axes),
                         self.mesh.group(summed) if summed else None))
        return plan

    def _whole(self, m, k, x, grad):
        for dim, group, sum_group in m["gathers"][k]:
            x = _GatherShard.apply(x, group, dim, sum_group) if grad \
                else C._all_gather(x, group, dim, True)
        return x

    @property
    def params(self):
        """The first local member's parameters (its shards)."""
        return self._members[0]["params"]

    @property
    def opt_state(self):
        return self._members[0]["state"]

    @property
    def dp_size(self):
        return int(self.mesh.shape.get(self.data_axis, 1))

    @property
    def mom(self):
        """SGD momentum state by parameter name, whole (None without
        momentum); a collective like :meth:`get_params`."""
        if not self.momentum:
            return None
        return self.mesh.run_local(lambda j: {
            k: self._whole(self._members[j], k, s[0], False)
            for k, s in self._members[j]["state"].items()})[0]

    def _put(self, i, b):
        from ..ndarray.ndarray import NDArray
        if isinstance(b, NDArray):
            b = b._data
        elif not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.ascontiguousarray(b))
        spec = self.batch_specs[i]
        _check_spec("batch arg %d" % i, spec, self.mesh, b.ndim)
        pl = Placement(self.mesh, spec)
        for dim in range(len(spec)):
            if pl.split(dim):
                check_batch_divisible(
                    b.shape[dim], self.mesh.axis_size(pl.split(dim)),
                    "batch arg %d dim %d" % (i, dim),
                    axis="x".join(pl.split(dim)))
        return b, pl

    def step(self, *batch):
        """Run one train step on the global batch (each member takes its
        block); returns the scalar loss (a detached tensor: the mean over
        the members that split the batch, the JAX trainer's mean over the
        global batch)."""
        if len(batch) != len(self.batch_specs):
            raise MXNetError("SPMDTrainer.step: %d batch args, %d batch "
                             "specs" % (len(batch), len(self.batch_specs)))
        batch = [self._put(i, b) for i, b in enumerate(batch)]
        self._num_update += 1
        return self.mesh.run_local(
            lambda j: self._member_step(j, batch))[0]

    def _member_step(self, j, batch):
        m = self._members[j]
        coords = self.mesh.coords(j)
        block = [pl.shard(b, coords).to(m["device"]) for b, pl in batch]
        names = list(m["params"])
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in m["params"].items()}
        whole = {k: self._whole(m, k, leaves[k], True) for k in names}
        loss = self._apply(whole, *block)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = {k: g if g is not None else torch.zeros_like(leaves[k])
                 for k, g in zip(names, grads)}
        grads, loss = self._reduce(m, grads, loss.detach())
        h = dict(self._hyper)
        h["lr"] = self.lr
        with torch.no_grad():
            for k in names:
                m["params"][k], m["state"][k] = self._update_fn(
                    m["params"][k], grads[k], m["state"][k],
                    self._num_update, h)
        return loss

    def _reduce(self, m, grads, loss):
        """Loss and gradients averaged over the batch-splitting members
        (and the copies of each parameter along the other axes): one
        all-reduce per (axes, dtype) bucket, the loss riding with the
        gradients reduced over exactly the batch axes."""
        buckets = collections.OrderedDict()
        for k, g in grads.items():
            buckets.setdefault((m["reduce_axes"][k], g.dtype), []).append(k)
        loss_key = (self.batch_axes, loss.dtype)
        buckets.setdefault(loss_key, []).append(None)      # None: the loss
        vals = dict(grads)
        vals[None] = loss.reshape(1)
        with torch.no_grad():
            for (axes, _), names in buckets.items():
                group = m["groups"].get(axes)
                if group is not None:
                    flat = C._all_reduce(torch.cat(
                        [vals[k].reshape(-1) for k in names]), group, "sum")
                    at = 0
                    for k in names:
                        n = vals[k].numel()
                        vals[k] = flat[at:at + n].reshape(vals[k].shape)
                        at += n
                n = self._n_batch * math.prod(
                    self.mesh.shape[a] for a in axes
                    if a not in self.batch_axes)
                if n > 1:
                    for k in names:
                        vals[k] = vals[k] / n
        return vals, vals.pop(None).reshape(())

    def get_params(self):
        """The parameters as whole numpy arrays (bfloat16 widens to
        float32); a collective on a mesh that spans processes."""
        def whole(j):
            m = self._members[j]
            return {k: self._whole(m, k, v, False)
                    for k, v in m["params"].items()}
        got = self.mesh.run_local(whole)[0]
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy() for k, v in got.items()}


def _cpu():
    from ..context import cpu
    return cpu()
