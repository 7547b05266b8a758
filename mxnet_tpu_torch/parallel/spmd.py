"""The SPMD train step and the mesh layouts.

Counterpart of ``mxnet_tpu/parallel/spmd.py`` (``SPMDTrainer``,
``shard_params_rule``, ``DataParallelSpec``, ``dp_spec``, ``rule_spec``,
``dist_dp_spec``, ``shard_put``, ``broadcast_from_zero``,
``check_batch_divisible``, ``commit_dp_placements``). The engines and
``Module`` run a bound graph on a mesh through :class:`MeshParams` (a
member's shards, per-op gathers, the ``dp`` gradient sum) and
:func:`run_members`. The JAX trainer compiles loss, gradient and
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
           "shard_put", "broadcast_from_zero", "MeshParams", "as_rules",
           "commit_dp_placements", "run_members", "DP_AXIS", "MP_AXIS"]

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


def as_rules(what, rules):
    """``rules`` as a ``PartitionRules`` (None stays None): one already,
    or its list of ``(pattern, spec)`` pairs."""
    if rules is None or isinstance(rules, PartitionRules):
        return rules
    try:
        return PartitionRules(rules)
    except TypeError:
        raise MXNetError("%s: partition_rules must be a PartitionRules or a "
                         "list of (pattern, spec) pairs, got %r"
                         % (what, rules)) from None


def engine_spec(what, partition_rules, mesh_axes, contexts, ctx):
    """The rule spec of a serving or decode engine's mesh: ``contexts``
    (default ``[ctx]``) laid out by ``mesh_axes`` (default ``{"dp": 1,
    "mp": -1}``), over every process of a launched job when the axes
    cover them; ``partition_rules`` a ``PartitionRules`` or its list of
    pairs (None: every parameter replicated)."""
    from ..context import current_context
    from .mesh import job_processes
    rules = as_rules(what, partition_rules)
    ctxs = list(contexts) if contexts else \
        [ctx if ctx is not None else current_context()]
    for c in ctxs:
        c.torch_device()            # a gpu without a CUDA device raises
    axes = dict(mesh_axes) if mesh_axes else {DP_AXIS: 1, MP_AXIS: -1}
    mesh = mesh_from_contexts(ctxs, axes=axes,
                              processes=job_processes(axes, len(ctxs)))
    return rule_spec(mesh, rules)


def dist_dp_spec(contexts, data_axis=DP_AXIS, live_ranks=None):
    """The process-spanning spec: this process's ``contexts`` on each
    live worker of the job (``live_ranks``, default ``dist.live_ranks()``:
    the survivors after a member loss), one ``dp`` axis over all of them
    (workers bind the same number of contexts)."""
    from .. import dist
    live = dist.live_ranks() if live_ranks is None else live_ranks
    return dp_spec(mesh_from_contexts(contexts, axis=data_axis,
                                      processes=len(live)), data_axis)


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


class MeshParams:
    """The members' side of one rule-sharded layout: what the JAX
    package's committed placements and GSPMD do for a bound graph, done
    by each member of ``spec.mesh`` on its own shard.

    - A member holds its shard of every parameter and aux state
      (``shard``, ``shard_shape``); inputs are its rows of the data axis,
      the same on every member of one ``dp`` slice.
    - An op that reads a sharded tensor reads it gathered whole over the
      placement's axes (``whole``), and the whole tensor is dropped after
      the op unless an autograd graph holds it. Under autograd the gather
      is :class:`_GatherShard`: its backward keeps the member's slice,
      summed over the data axis first when the placement splits that
      axis (the slices' rows differ there).
    - ``reduce_grads`` sums a gradient over the data axis wherever the
      placement holds copies along it: the members of one ``dp`` slice
      compute the same rows, so only the ``dp`` line is summed.
    - ``batch_stats`` takes training-mode batch statistics over the data
      axis (``ops.nn.batch_stats_over(group=)``): the global batch's.

    ``shapes`` maps every parameter and aux state to its whole shape;
    ``placements`` (default: the spec's rules) places each, and
    ``batch_axes`` (default: the data axis) are the axes whose members
    see different rows.
    """

    def __init__(self, spec, shapes, placements=None, batch_axes=None):
        mesh = self.mesh = spec.mesh
        self.spec = spec
        self.shapes = {n: tuple(int(d) for d in s) for n, s in shapes.items()}
        self.placements = placements or {
            n: spec.param_sharding(n, s) for n, s in self.shapes.items()}
        data = spec.data_axis
        batch = (data,) if batch_axes is None else tuple(batch_axes)
        self.dp = int(mesh.shape.get(data, 1))
        self._steps, self._reduce = {}, {}
        for n, pl in self.placements.items():
            steps = [(dim, pl.split(dim),
                      tuple(a for a in pl.split(dim) if a in batch))
                     for dim in range(len(pl.spec))
                     if pl.split(dim) and mesh.axis_size(pl.split(dim)) > 1]
            if steps:
                self._steps[n] = steps
            if self.dp > 1 and data in pl.replica_axes():
                self._reduce[n] = (data,)

    @property
    def ledger_key(self):
        return "mesh(%ddev)" % self.mesh.size

    def is_sharded(self, name):
        return name in self._steps

    def groups(self):
        """Create every line the layout meets on, in one order: call it on
        every member before the first step (a line across processes is a
        ``torch.distributed`` subgroup, and creating one is a
        collective)."""
        lines = set(self._reduce.values())
        for steps in self._steps.values():
            for _, axes, summed in steps:
                lines |= {axes, summed}
        if self.dp > 1:
            lines.add((self.spec.data_axis,))
        for axes in sorted(a for a in lines if a):
            self.mesh.group(axes)

    def shard_shape(self, name):
        pl = self.placements.get(name)
        shape = self.shapes.get(name)
        return shape if pl is None else pl.shard_shape(shape)

    def own(self, name, whole):
        """The calling member's block of a whole tensor ``name`` (a view;
        the tensor itself when the layout does not shard it)."""
        if name not in self._steps:
            return whole
        return self.placements[name].shard(whole, self.mesh.coords())

    def own_at(self, name, whole, coords):
        """``own`` for the member at mesh ``coords``."""
        if name not in self._steps:
            return whole
        return self.placements[name].shard(whole, coords)

    def shard(self, name, whole, device):
        """The calling member's block of ``whole`` as a contiguous copy on
        ``device``."""
        return self.own(name, whole).to(device, copy=True).contiguous()

    def whole(self, name, x):
        """``x``, the calling member's shard of ``name``, gathered whole
        (``x`` itself for a tensor the layout does not shard)."""
        for dim, axes, summed in self._steps.get(name, ()):
            group = self.mesh.group(axes)
            if x.requires_grad and torch.is_grad_enabled():
                x = _GatherShard.apply(
                    x, group, dim, self.mesh.group(summed) if summed
                    else None)
            else:
                x = C._all_gather(x, group, dim, True)
        return x

    def reduce_grads(self, grads):
        """``{name: gradient}`` of the calling member, each summed over
        the data axis where its placement holds copies along it: one
        all-reduce per dtype, the gradients laid end to end."""
        buckets = collections.OrderedDict()
        for n, g in grads.items():
            axes = self._reduce.get(n)
            if axes:
                buckets.setdefault((axes, g.dtype), []).append(n)
        if not buckets:
            return grads
        out = dict(grads)
        with torch.no_grad():
            for (axes, _), names in buckets.items():
                flat = C._all_reduce(torch.cat(
                    [out[n].reshape(-1) for n in names]),
                    self.mesh.group(axes), "sum")
                at = 0
                for n in names:
                    k = out[n].numel()
                    out[n] = flat[at:at + k].view(out[n].shape)
                    at += k
        return out

    def batch_stats(self):
        """The scope in which training-mode batch statistics span the
        data axis (nothing to span at ``dp`` 1)."""
        import contextlib
        if self.dp == 1:
            return contextlib.nullcontext()
        from ..ops.nn import batch_stats_over
        return batch_stats_over(group=self.mesh.group(self.spec.data_axis))

    def rows(self, x, dim=0):
        """The calling member's rows of a whole batch ``x`` (a view)."""
        if self.dp == 1:
            return x
        return x.chunk(self.dp, dim=dim)[
            self.mesh.coords()[self.spec.data_axis]]

    def gather_rows(self, x, dim=0):
        """A member's rows gathered back into the whole batch, in ``dp``
        order, on every member (a collective over the data axis)."""
        if self.dp == 1:
            return x
        return C._all_gather(x, self.mesh.group(self.spec.data_axis), dim,
                             True)

    def track(self, tensor, kind="param"):
        """Charge a member's tensor to the buffer ledger under the mesh
        key: summed over the members, the committed bytes of the JAX
        package's placed array (per-shard bytes times devices)."""
        from .. import telemetry
        telemetry.ledger_track(tensor, self.ledger_key,
                               tensor.numel() * tensor.element_size(),
                               shape=tuple(tensor.shape),
                               dtype=str(tensor.dtype), kind=kind)


def commit_dp_placements(executor, values, layout):
    """Copy the calling member's shard of each whole value in ``values``
    (``{name: tensor}``, parameters and aux states) into the member's
    bound ``executor`` (its arrays hold the shard shapes): the
    counterpart of the JAX package's commit onto the mesh placements.
    Names the executor does not hold are passed over."""
    args, aux = executor.arg_dict, executor.aux_dict
    with torch.no_grad():
        for name, whole in values.items():
            arr = args.get(name) if name in args else aux.get(name)
            if arr is None:
                continue
            raw = arr._data
            raw.copy_(layout.own(name, whole).to(raw.device, raw.dtype))


def run_members(mesh, fn, quiet_first=True):
    """``mesh.run_local(fn)`` with the instrumented entry points of every
    member run bare (``executor.quiet``), or of every member but the
    first with ``quiet_first=False``: an engine around the members
    carries the card and the fault site, or member 0 carries them."""
    from ..executor import quiet

    def body(j):
        with quiet(j > 0 or quiet_first):
            return fn(j)
    return mesh.run_local(body)


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
        self._layout = MeshParams(
            DataParallelSpec(mesh, data_axis),
            {k: tuple(v.shape) for k, v in params.items()},
            placements=self._placements, batch_axes=self.batch_axes)
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
        self._layout.groups()
        reduce_axes = {k: pl.replica_axes() for k, pl in
                       self._placements.items()}
        groups = {axes: mesh.group(axes) for axes in
                  sorted(set(reduce_axes.values()) | {self.batch_axes})
                  if axes and mesh.axis_size(axes) > 1}
        return {"params": params, "device": dev,
                "reduce_axes": reduce_axes, "groups": groups,
                "state": {k: tuple(init_fn(v)) for k, v in params.items()}}

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
            k: self._layout.whole(k, s[0])
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
        whole = {k: self._layout.whole(k, leaves[k]) for k in names}
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
            return {k: self._layout.whole(k, v)
                    for k, v in m["params"].items()}
        got = self.mesh.run_local(whole)[0]
        return {k: (v.float() if v.dtype == torch.bfloat16 else v)
                .cpu().numpy() for k, v in got.items()}


def _cpu():
    from ..context import cpu
    return cpu()
