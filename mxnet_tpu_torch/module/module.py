"""Module — symbolic training on bound executors.

Counterpart of ``mxnet_tpu/module/module.py`` (parity: reference
``module/module.py``): ``bind`` (``simple_bind`` with gradient arrays),
``reshape``, ``init_params``, ``init_optimizer`` with or without a
kvstore, forward/backward/update, the fused batch step,
``get_params`` / ``set_params``, ``borrow_optimizer`` and checkpoints.
The JAX package compiles the fused step into one jitted program with
donated buffers; here it is one eager function
(``executor._GraphProgram.train_step_fn``): forward and backward through
``torch.autograd``, the ``FusedUpdater``'s loop over the parameters, the
metric accumulated on the device. The phase-split path
(``forward_backward``, ``update``, ``update_metric``) runs the same
arithmetic, so the two give the same result. With a store object
(``update_on_kvstore``) the optimizer lives in the store: ``update``
pushes the gradients and pulls the weights, and the fused step runs the
store's updater and then copies the new weights into the store's copies.

Several contexts (data parallelism in one process): where the JAX
package shards one program's batch over a mesh, the port binds one
executor per Context (``cpu(0)`` and ``cpu(1)`` are two, as the JAX
package's virtual CPU devices are), each on its equal slice of the batch
(a batch that does not divide raises). The gradients are summed over
the contexts (through the store's push of shard lists on the
phase-split path, on the first context in the fused step), the update
runs once on the first context's weights, and the other replicas take
a copy. The executors run as one program (``executor.ReplicaSet``):
a training forward evaluates them node by node together, so
BatchNorm's statistics are the whole batch's, as in the JAX package's
one sharded program, and one backward runs over their joint graph. A
``dist*`` store adds the worker processes of a launched job: the
phase-split update pushes through the store's one batched collective
and BatchNorm takes each worker's own rows (the JAX package drops the
process-spanning placement there); the fused step over a synchronous
store takes BatchNorm's statistics over every worker's rows too (the
JAX package's process-spanning program), all-reduces the gradients in
one bucketed collective and runs the store's update, with no push/pull
per key; ``dist_async`` and compressed stores take the phase-split path
(``FUSED_FALLBACK_CODES["kvstore_dist"]``, as in the JAX package).
``compression_params`` goes to the store at ``init_optimizer``.

A mesh (``partition_rules=``, ``mesh_axes=``; the JAX package's
rule-sharded ``dp x mp`` layout): the context list (and, in a launched
job whose processes the axes cover, the same list on every process) is
laid out by ``mesh_axes`` (default ``{"dp": -1}``), one member a device
(``parallel.spmd.MeshParams``). Each member binds an executor on its
rows of the batch (the batch splits over ``dp`` only) and holds its
shards of the parameters, gradients, aux states and optimizer states;
an op reads a sharded parameter gathered whole, BatchNorm takes its
statistics over the ``dp`` line, gradients are summed over ``dp``, and
the update runs on the shards, in the fused step and on the phase-split
path alike. The members of one process run together
(``Mesh.run_local``); ``get_params``, ``get_outputs`` and the optimizer
states gather the whole tensors (collectives: every process calls them).
A mesh of one device is the plain path. A ``dist*`` store with a mesh
raises, as in the JAX package.

Elastic training (``heartbeat.py``): the fused step over a synchronous
``dist*`` store crosses a pre-collective gate (channel ``step``) once a
step, so a peer that died before it raises ``DeadWorkerError``; a peer
that dies inside the step's collectives is named by the collectives'
liveness-aware wait (channel ``step-execution``). ``fit`` then calls
:meth:`Module._elastic_remesh` (the survivors' membership, their
process group, a fresh gate) and resumes from its checkpoint
(``base_module.py``).

``group2ctxs`` (the reference's model parallelism by op group): a
``{group: Context}`` map binds each node whose ``ctx_group`` attribute
names a group on that group's device (``executor._GraphProgram``); the
module's one context is the default. It cannot be combined with a
context list, and ``fit`` phase-splits (fallback code ``group2ctx``).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..context import Context, cpu, current_context
from ..executor import ReplicaSet, record_dispatch
from .. import telemetry
from ..initializer import InitDesc, Uniform
from ..model import _create_kvstore, save_checkpoint, load_checkpoint
from .. import optimizer as opt
from .base_module import BaseModule, FusedFallback
from .executor_group import slice_descs, split_batch, merge_outputs

class Module(BaseModule):
    """(parity: module.Module)"""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None, partition_rules=None,
                 mesh_axes=None):
        super().__init__(logger=logger)
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        from ..parallel.spmd import as_rules
        self._partition_rules = as_rules("Module", partition_rules)
        self._mesh_axes = dict(mesh_axes) if mesh_axes else None
        self._mesh_spec = None
        self._layout = None
        self._context = list(context)
        if not self._context:
            raise MXNetError("Module: empty context list")
        if len(set(self._context)) != len(self._context):
            raise MXNetError("duplicate devices in context list %s"
                             % (self._context,))
        for c in self._context:
            c.torch_device()                # no such device: raise now
        self._compression_params = compression_params
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._state_names = list(state_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        input_names = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._exec = None
        self._execs = []
        self._replicas = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = None
        self._fused_fallback_reason = None
        self._preload_opt_states = None
        self._group2ctxs = group2ctxs
        self._step_gate = None

    # -- introspection -----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        shapes = {d.name: d.shape for d in self._data_shapes
                  + self._label_shapes}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """(parity: module.bind) allocate the executor's arrays for these
        input shapes and dtypes on the module's device."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = [_as_desc(l) for l in label_shapes] \
            if label_shapes else []
        shape_kwargs = {d.name: d.shape
                        for d in self._data_shapes + self._label_shapes}
        type_dict = {d.name: d.dtype
                     for d in self._data_shapes + self._label_shapes
                     if getattr(d, "dtype", None) is not None}
        reqs = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                reqs[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or name in self._state_names \
                    or name in self._fixed_param_names:
                reqs[name] = "null"
            else:
                reqs[name] = grad_req if for_training else "null"
        self._grad_req = reqs
        g2c = self._group2ctxs
        if isinstance(g2c, (list, tuple)):
            # the reference's per-context list; one executor takes the
            # first entry
            g2c = g2c[0] if g2c else None
        if g2c and len(self._context) > 1:
            raise MXNetError(
                "group2ctxs cannot be combined with a multi-device context "
                "list; use a single context for model parallelism or drop "
                "group2ctxs for data parallelism")
        if g2c:
            self._execs = [self._symbol.simple_bind(
                ctx=self._context[0], grad_req=reqs, type_dict=type_dict,
                group2ctx=g2c, **shape_kwargs)]
            self._replicas = ReplicaSet(self._execs)
        elif self._mesh_wanted():
            self._bind_mesh(shape_kwargs, type_dict)
        else:
            descs = slice_descs(self._data_shapes + self._label_shapes,
                                len(self._context))
            shape_kwargs = {d.name: d.shape for d in descs}
            self._execs = [self._symbol.simple_bind(
                ctx=c, grad_req=reqs, type_dict=type_dict, **shape_kwargs)
                for c in self._context]
            self._replicas = ReplicaSet(self._execs)
        self._exec = self._execs[0]
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized and self._arg_params is not None:
            # Module.load: the checkpoint's params install at bind time
            self.set_params(self._arg_params, self._aux_params or {})

    # -- the mesh ----------------------------------------------------------
    def _mesh_wanted(self):
        """Rules or axes over more than one device (a mesh of one device
        is the plain path, as the JAX package ignores them there)."""
        if self._partition_rules is None and not self._mesh_axes:
            return False
        from ..parallel.mesh import job_processes
        axes = self._mesh_axes or {"dp": -1}
        return len(self._context) * job_processes(axes,
                                                  len(self._context)) > 1

    def _bind_mesh(self, shape_kwargs, type_dict):
        """One executor a local member, on its rows of the batch, holding
        its shards of every parameter, gradient and aux state (zeros,
        charged to the ledger under the mesh key)."""
        from ..executor import Executor, _GraphProgram, infer_graph_attrs
        from ..ndarray import zeros
        from ..parallel import mesh as _pmesh, spmd as _spmd
        axes = self._mesh_axes or {_spmd.DP_AXIS: -1}
        mesh = _pmesh.mesh_from_contexts(
            self._context, axes=axes,
            processes=_pmesh.job_processes(axes, len(self._context)))
        spec = self._mesh_spec = _spmd.rule_spec(mesh, self._partition_rules)
        local = {d.name: d.shape for d in slice_descs(
            self._data_shapes + self._label_shapes, spec.dp_size)}
        arg_shapes, _, aux_shapes, arg_types, _, aux_types = \
            infer_graph_attrs(self._symbol, shape_kwargs,
                              known_types=type_dict)
        arg_names = self._symbol.list_arguments()
        shapes = {n: s for n, s in zip(arg_names, arg_shapes)
                  if n in self._param_names}
        shapes.update(zip(self._aux_names, aux_shapes))
        layout = self._layout = _spmd.MeshParams(spec, shapes)
        reqs = self._grad_req

        def bind(j):
            layout.groups()
            ctx = mesh.devices[j]
            prog = _GraphProgram(self._symbol)
            prog.layout = layout
            args, grads = [], []
            for name, shape, dt in zip(arg_names, arg_shapes, arg_types):
                shape = layout.shard_shape(name) if name in shapes \
                    else local.get(name, shape)
                args.append(zeros(shape, ctx=ctx, dtype=dt))
                grads.append(zeros(shape, ctx=ctx, dtype=dt)
                             if reqs.get(name, "null") != "null" else None)
            aux = [zeros(layout.shard_shape(n), ctx=ctx, dtype=dt)
                   for n, dt in zip(self._aux_names, aux_types)]
            for a in [a for n, a in zip(arg_names, args) if n in shapes] \
                    + aux:
                layout.track(a._data)
            return Executor(self._symbol, ctx, args, aux, program=prog,
                            grad_arrays=grads, grad_req=reqs)
        self._execs = _spmd.run_members(mesh, bind)
        self._replicas = None

    def _members(self, fn):
        """``fn(j, executor)`` on every local member (member 0 carries
        the program cards and the dispatch fault site)."""
        from ..parallel.spmd import run_members
        return run_members(self._mesh_spec.mesh,
                           lambda j: fn(j, self._execs[j]), quiet_first=False)

    def partition_summary(self):
        """JSON-safe layout of this module's mesh (None off a mesh): the
        mesh axes, the data axis, the rule tree and the sharded
        parameters' resolved specs (checkpoint meta records it)."""
        if self._mesh_spec is None:
            return None
        from ..parallel.partition import partition_summary as _summary
        return _summary(self._mesh_spec, {n: self._layout.shapes[n]
                                          for n in self._param_names})

    def _whole_shapes(self):
        """``{name: bound shape}`` of every parameter and aux state (the
        whole shape on a mesh, whose members hold shards)."""
        if self._layout is not None:
            return dict(self._layout.shapes)
        shapes = {n: a.shape for n, a in self._exec.arg_dict.items()
                  if n in self._param_names}
        shapes.update({n: a.shape for n, a in self._exec.aux_dict.items()})
        return shapes

    def reshape(self, data_shapes, label_shapes=None):
        """(parity: module.reshape) rebind at new input shapes over the
        same parameter, gradient and aux arrays: nothing is copied or
        re-initialised, and the optimizer and store stay as they are."""
        if not self.binded:
            raise MXNetError("reshape: bind first")
        self._data_shapes = [_as_desc(d) for d in data_shapes]
        self._label_shapes = [_as_desc(l) for l in label_shapes] \
            if label_shapes else []
        if self._layout is not None:
            descs = slice_descs(self._data_shapes + self._label_shapes,
                                self._mesh_spec.dp_size)
            self._execs = self._members(
                lambda j, old: self._reshaped(old, old._ctx, descs))
        else:
            descs = slice_descs(self._data_shapes + self._label_shapes,
                                len(self._context))
            self._execs = [self._reshaped(old, ctx, descs)
                           for old, ctx in zip(self._execs, self._context)]
            self._replicas = ReplicaSet(self._execs)
        self._exec = self._execs[0]

    def _reshaped(self, old, ctx, descs):
        from ..executor import Executor, infer_graph_attrs
        from ..ndarray import zeros
        arg_shapes, _, _, arg_types, _, _ = infer_graph_attrs(
            self._symbol, {d.name: d.shape for d in descs},
            known_types={d.name: d.dtype for d in descs
                         if getattr(d, "dtype", None) is not None})
        old_args, old_grads = old.arg_dict, old.grad_dict
        args, grads = [], []
        for name, shape, dtype in zip(self._symbol.list_arguments(),
                                      arg_shapes, arg_types):
            if name in self._param_names:
                if self._layout is not None:
                    shape = self._layout.shard_shape(name)
                if old_args[name].shape != tuple(shape):
                    raise MXNetError("reshape: parameter %r would change "
                                     "shape %s -> %s"
                                     % (name, old_args[name].shape,
                                        tuple(shape)))
                args.append(old_args[name])
                grads.append(old_grads[name])
                continue
            args.append(zeros(shape, ctx=ctx, dtype=dtype))
            grads.append(zeros(shape, ctx=ctx, dtype=dtype)
                         if self._grad_req[name] != "null" else None)
        return Executor(self._symbol, ctx, args, old.aux_arrays,
                        program=old._prog, grad_arrays=grads,
                        grad_req=self._grad_req)

    # -- params ------------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """(parity: module.init_params) a given value (NDArray or numpy)
        wins, else the initializer, called with an ``InitDesc`` carrying
        the symbol's attributes (a variable's ``__init__`` picks its own
        initializer). Names in ``arg_params``/``aux_params`` that the
        symbol lacks are ignored, as in the JAX package, whatever
        ``allow_extra`` says (upstream MXNet 0.12 raises for them unless
        ``allow_extra`` is set)."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if arg_params is None and self._arg_params is not None:
            arg_params = self._arg_params
        if aux_params is None and self._aux_params is not None:
            aux_params = self._aux_params
        if self._layout is not None:
            self._init_mesh_params(initializer, arg_params, aux_params,
                                   allow_missing)
            self.params_initialized = True
            return
        args = {n: a for n, a in self._exec.arg_dict.items()
                if n in self._param_names}
        self._fill(args, self._exec.aux_dict, initializer, arg_params,
                   aux_params, allow_missing)
        self._sync_replicas()
        if self._update_on_kvstore and self._kvstore is not None:
            # the store serves pulls from its copies (a restore after
            # init_optimizer must reach them too)
            store = self._kvstore._store
            with torch.no_grad():
                for i, n in enumerate(self._param_names):
                    if i in store:
                        store[i]._data.copy_(args[n]._data)
        self.params_initialized = True

    def _fill(self, args, auxs, initializer, arg_params, aux_params,
              allow_missing):
        """Each array a given value (NDArray or numpy) or else the
        initializer's."""
        attrs = self._symbol.attr_dict()
        for arrays, given in ((args, arg_params), (auxs, aux_params)):
            for name, arr in arrays.items():
                value = (given or {}).get(name)
                if value is not None:
                    arr[:] = value
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)
                elif not allow_missing:
                    raise MXNetError("no initializer and no value for %r"
                                     % name)

    def _init_mesh_params(self, initializer, arg_params, aux_params,
                          allow_missing):
        """The whole values made on the host (rank 0's on every process
        of a mesh across processes), then each member's shards."""
        from ..ndarray import zeros
        from ..parallel.spmd import broadcast_from_zero, commit_dp_placements
        shapes = self._layout.shapes
        ex = self._exec
        host = [{n: zeros(shapes[n], ctx=cpu(), dtype=a.dtype)
                 for n, a in table.items() if n in shapes}
                for table in (ex.arg_dict, ex.aux_dict)]
        self._fill(host[0], host[1], initializer, arg_params, aux_params,
                   allow_missing)
        whole = {n: a._data for part in host for n, a in part.items()}
        if self._mesh_spec.mesh.processes > 1:
            whole = broadcast_from_zero(whole)
        self._members(lambda j, ex: commit_dp_placements(ex, whole,
                                                         self._layout))

    def _sync_replicas(self, names=None):
        """Copy the first context's parameters (``names``; default every
        parameter and aux state) into the other contexts' executors."""
        if len(self._execs) < 2 or self._layout is not None:
            return
        src = self._exec
        with torch.no_grad():
            for ex in self._execs[1:]:
                for n in (self._param_names if names is None else names):
                    ex.arg_dict[n]._data.copy_(src.arg_dict[n]._data)
                if names is None:
                    for n, a in ex.aux_dict.items():
                        a._data.copy_(src.aux_dict[n]._data)

    def init_params_from_preloaded(self):
        """Install the parameters ``Module.load`` read, once bound
        (``bind`` does this itself)."""
        if self.binded and self._arg_params is not None:
            self.set_params(self._arg_params, self._aux_params or {})

    def get_params(self):
        """(parity: module.get_params) copies of the parameters and aux
        states, on the module's device."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("get_params: bind and init_params first")
        if self._layout is not None:
            return self._gathered_params()
        arg_params = {n: arr.copy() for n, arr in self._exec.arg_dict.items()
                      if n in self._param_names}
        aux_params = {n: arr.copy() for n, arr in self._exec.aux_dict.items()}
        return arg_params, aux_params

    def _gathered_params(self):
        """The members' shards gathered whole, as NDArrays on the first
        context (a collective)."""
        from ..ndarray.ndarray import NDArray
        layout, ctx = self._layout, self._context[0]

        def whole(j, ex):
            with torch.no_grad():
                return [{n: layout.whole(n, a._data).clone()
                         for n, a in table.items() if n in layout.shapes}
                        for table in (ex.arg_dict, ex.aux_dict)]
        arg, aux = self._members(whole)[0]
        return ({n: NDArray(t, ctx) for n, t in arg.items()},
                {n: NDArray(t, ctx) for n, t in aux.items()})

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """(parity: module.init_optimizer) ``rescale_grad`` defaults to
        1.0, as in the JAX package (the reference uses 1/batch). A store
        (``model._create_kvstore``) gets every parameter by index and,
        under ``update_on_kvstore``, the optimizer."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("init_optimizer: bind and init_params first")
        if self.optimizer_initialized and not force_init:
            return
        if self._layout is not None:
            self._init_mesh_optimizer(kvstore, optimizer, optimizer_params)
            return
        arg_dict = self._exec.arg_dict
        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context),
            {n: arg_dict[n] for n in self._param_names})
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0)
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        self._optimizer = optimizer
        if kv is not None:
            if kv.type.startswith("dist"):
                # every dist type runs the optimizer in the store, as the
                # JAX package and the reference's servers do
                update_on_kvstore = True
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            # one call for every key: a dist store crosses its gate once
            # for the call, then broadcasts each key
            kv.init(list(range(len(self._param_names))),
                    [arg_dict[n] for n in self._param_names])
            if kv.type.startswith("dist"):
                # rank 0's values seeded the store: train from them
                kv.pull(list(range(len(self._param_names))),
                        out=[arg_dict[n] for n in self._param_names])
                self._sync_replicas(self._param_names)
            if update_on_kvstore:
                kv.set_optimizer(optimizer)
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None if update_on_kvstore \
            else opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _init_mesh_optimizer(self, kvstore, optimizer, optimizer_params):
        """On a mesh the gradients sum over the ``dp`` line and the
        members update their shards: no store takes part (a ``dist*``
        one raises, as in the JAX package)."""
        kv_type = kvstore if isinstance(kvstore, str) \
            else getattr(kvstore, "type", "")
        if kv_type and kv_type.startswith("dist"):
            raise MXNetError(
                "partition_rules/mesh_axes cannot be combined with a "
                "multi-process dist_* kvstore (%r); a mesh spans the job's "
                "processes itself" % kv_type)
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = _MeshUpdater(optimizer, self)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _active_updater(self):
        """The updater that owns the optimizer states: the store's under
        ``update_on_kvstore``, else the module's."""
        return self._kvstore._updater if self._update_on_kvstore \
            else self._updater

    def borrow_optimizer(self, shared_module):
        """Share another module's optimizer, updater and store (parity:
        module.borrow_optimizer)."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("borrow_optimizer: the shared module has no "
                             "optimizer")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """(parity: module.forward)"""
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward: bind and init_params first")
        if is_train is None:
            is_train = self.for_training
        self._set_batch(data_batch)
        if self._layout is not None:
            self._members(lambda j, ex: ex.forward(is_train=is_train))
            return
        self._replicas.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if self._layout is not None:
            parts = None if out_grads is None else split_batch(
                out_grads if isinstance(out_grads, (list, tuple))
                else [out_grads], self._mesh_spec.dp_size)
            self._members(lambda j, ex: ex.backward(
                None if parts is None else parts[self._dp_index(j)]))
            return
        if out_grads is None:
            self._replicas.backward()
        elif len(self._execs) > 1:
            self._replicas.backward(split_batch(
                out_grads if isinstance(out_grads, (list, tuple))
                else [out_grads], len(self._execs)))
        else:
            self._replicas.backward([out_grads])

    def forward_backward(self, data_batch):
        """Forward and backward in one pass of the executors."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("forward_backward: bind and init_params first")
        self._set_batch(data_batch)
        if self._layout is not None:
            self._members(lambda j, ex: ex.forward_backward())
            return
        self._replicas.forward_backward()

    def _dp_index(self, j):
        """Local member ``j``'s coordinate on the data axis."""
        spec = self._mesh_spec
        return spec.mesh.coords(j)[spec.data_axis]

    def _set_batch(self, data_batch):
        """Copy the batch's data (and labels) into the bound storage, on
        each context's device in the bound dtype, each context its slice
        (a ``feed`` span)."""
        with telemetry.span("feed"):
            self._set_batch_impl(data_batch)

    def _set_batch_impl(self, data_batch):
        data = data_batch.data
        if not isinstance(data, (list, tuple)):
            data = [data]
        feeds = list(zip(self._data_shapes, data))
        label = data_batch.label
        if label is not None and self._label_shapes:
            if not isinstance(label, (list, tuple)):
                label = [label]
            feeds += list(zip(self._label_shapes, label))
        n = len(self._execs) if self._layout is None \
            else self._mesh_spec.dp_size
        for desc, arr in feeds:
            if tuple(arr.shape) != tuple(desc.shape):
                raise MXNetError(
                    "batch %r has shape %s, the module is bound to %s; "
                    "call reshape first"
                    % (desc.name, tuple(arr.shape), tuple(desc.shape)))
            parts = split_batch([arr], n)
            if self._layout is not None:       # a member takes its dp rows
                for j, ex in enumerate(self._execs):
                    ex.arg_dict[desc.name][:] = parts[self._dp_index(j)][0]
                continue
            for ex, (part,) in zip(self._execs, parts):
                ex.arg_dict[desc.name][:] = part

    def _live_params(self):
        return [(i, n) for i, n in enumerate(self._param_names)
                if self._grad_req.get(n, "null") != "null"]

    def update(self):
        """One optimizer step over every parameter with a gradient, the
        whole key list in one call (parity: module.update): push the
        gradients (each key's list over the contexts) and pull the
        weights under ``update_on_kvstore``, else push/pull the
        gradients through the store (when there is one; without one the
        contexts' gradients are summed on the first) and run the
        module's ``update_batch``; the other contexts then copy the
        first one's weights."""
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            raise MXNetError("update: bind, init_params and "
                             "init_optimizer first")
        live = self._live_params()
        if not live:
            return
        keys = [i for i, _ in live]
        names = [n for _, n in live]
        if self._layout is not None:       # gradients already summed
            record_dispatch("opt_update")
            with telemetry.span("opt_update"):
                self._updater.update_members(
                    keys, [[ex.grad_dict[n] for n in names]
                           for ex in self._execs],
                    [[ex.arg_dict[n] for n in names] for ex in self._execs])
            return
        multi = len(self._execs) > 1
        grads = [[ex.grad_dict[n] for ex in self._execs] if multi
                 else self._exec.grad_dict[n] for n in names]
        weights = [[ex.arg_dict[n] for ex in self._execs] if multi
                   else self._exec.arg_dict[n] for n in names]
        kv = self._kvstore
        record_dispatch("opt_update")
        with telemetry.span("opt_update"):
            if kv is not None and self._update_on_kvstore:
                kv.push(keys, grads)
                kv.pull(keys, out=weights)
                return
            if kv is not None:
                kv.push(keys, grads)
                kv.pull(keys, out=grads)
            elif multi:
                with torch.no_grad():
                    for glist in grads:
                        for g in glist[1:]:
                            glist[0]._data.add_(g._data.to(
                                glist[0]._data.device))
            first = [g[0] for g in grads] if multi else grads
            w0 = [w[0] for w in weights] if multi else weights
            self._updater.update_batch(keys, first, w0)
            self._sync_replicas(names)

    # -- the fused batch step ----------------------------------------------
    def _fallback(self, code, message, detail=None):
        self._fused_fallback_reason = FusedFallback(code, message, detail)
        return False

    def _fused_batch_step(self, data_batch, eval_metric=None):
        """Forward, backward, optimizer update and metric update as one
        step (``executor.train_step_fn``), for any optimizer the updater
        takes. Over several contexts the executors run forward and
        backward together (``ReplicaSet``) and the gradients are summed
        on the first context; over a synchronous ``dist*`` store
        BatchNorm's statistics span the workers and the gradients are
        then summed over them in one bucketed all-reduce; the update
        runs once and the other contexts copy its weights. Returns False, with
        the reason in ``_fused_fallback_reason``, when the caller must
        run the phase-split path: ``MXNET_MODULE_FUSED_STEP=0`` (the A/B
        pin), a monitor, ``inputs_need_grad``, nothing to train,
        ``dist_async`` or a compressed store (``kvstore_dist`` for a dist
        store, ``kvstore_compression`` for an in-process one)."""
        if not get_env("MXNET_MODULE_FUSED_STEP", 1, int):
            return self._fallback("env_pin", "MXNET_MODULE_FUSED_STEP=0")
        if not (self.binded and self.params_initialized
                and self.optimizer_initialized):
            return self._fallback("not_initialised",
                                  "module not fully initialised")
        if self.inputs_need_grad:
            return self._fallback("inputs_need_grad", "inputs_need_grad")
        if any(ex._monitor_callback is not None for ex in self._execs):
            return self._fallback("monitor", "monitor installed")
        if self._exec._prog.node_ctx:
            return self._fallback("group2ctx", "group2ctx placement",
                                  "grouped programs run phase-split")
        kv = self._kvstore
        if kv is not None and not kv.fused_step_subsumable \
                and not kv.fused_dist_step:
            if kv.type.startswith("dist"):
                return self._fallback(
                    "kvstore_dist", "kvstore-mediated update",
                    "kvstore type %r keeps the explicit push (dist_async "
                    "or gradient compression)" % kv.type)
            return self._fallback(
                "kvstore_compression", "kvstore-mediated update",
                "gradient compression changes the pushed values")
        live = self._live_params()
        if not live:
            return self._fallback("no_trainable_params",
                                  "no trainable parameters")
        updater = self._active_updater()
        indices = [i for i, _ in live]
        names = [n for _, n in live]
        weights = [self._exec.arg_dict[n] for n in names]
        add_names = [n for n in names if self._grad_req[n] == "add"]
        spanning = kv is not None and kv.fused_dist_step \
            and kv._spans_workers()
        if spanning:
            # a peer dead before the step's collectives raises here
            self._dist_gate().arrive_and_wait()
        self._set_batch(data_batch)
        if self._layout is not None:
            # each member's step over its rows; gradients summed over dp
            # inside it, then every member updates its shards
            def member(j, ex):
                got = []
                self._run_step(ex, names, add_names, got.extend)
                return got
            per = self._members(member)
            self._updater.update_members(
                indices, per, [[ex.arg_dict[n] for n in names]
                               for ex in self._execs])
        elif len(self._execs) == 1 and not spanning:
            self._run_step(self._exec, names, add_names,
                           lambda gs: updater.update_batch(indices, gs,
                                                           weights))
        elif spanning:
            self._spanning_step(names, add_names, indices, weights, updater)
        else:
            per = self._replicas.step_grads(names, add_names)
            summed = per[0]
            for got in per[1:]:
                summed = [a + b.to(a.device) for a, b in zip(summed, got)]
            with torch.no_grad():
                updater.update_batch(indices, summed, weights)
            self._sync_replicas(names)
        if self._update_on_kvstore:
            # the store serves pulls and checkpoints from its copies:
            # keep them equal to the weights the step just wrote
            with torch.no_grad():
                store = kv._store
                for i, w in zip(indices, weights):
                    store[i]._data.copy_(w._data)
        if eval_metric is not None:
            if eval_metric.fused_in_step:
                labels = data_batch.label
                eval_metric.update(labels if isinstance(labels, (list, tuple))
                                   else [labels], self.get_outputs())
            else:
                self.update_metric(eval_metric, data_batch.label)
        self._fused_fallback_reason = None
        return True

    def _spanning_step(self, names, add_names, indices, weights, updater):
        """The fused step over the workers: BatchNorm over every worker's
        rows, the gradients summed over them in one bucketed collective,
        then the update. Time in the collectives is reported to the step
        gate as waiting (a rank blocked on a slow peer must not read as
        slow itself), and a death inside them is stamped with the gate's
        generation."""
        from ..heartbeat import DeadWorkerError
        from ..parallel import collectives
        t_wire = collectives.wire["seconds"]
        try:
            per = self._replicas.step_grads(names, add_names,
                                            over_workers=True)
            summed = per[0]
            for got in per[1:]:
                summed = [a + b.to(a.device) for a, b in zip(summed, got)]
            summed = self._fused_all_reduce(summed)
        except DeadWorkerError as e:
            if e.generation is None:
                e.generation = self._dist_gate().generation
            raise
        finally:
            self._dist_gate().note_wait(
                (collectives.wire["seconds"] - t_wire) * 1e3)
        with torch.no_grad():
            updater.update_batch(indices, summed, weights)
        self._sync_replicas(names)

    def _dist_gate(self):
        """The fused dist step's pre-collective gate (channel ``step``;
        the store's own collectives gate on ``kv``). Lazy; rebuilt after
        a re-mesh."""
        if self._step_gate is None:
            from .. import heartbeat
            kv = self._kvstore
            self._step_gate = heartbeat.CollectiveGate(
                kv.rank, kv.live_ranks, channel="step")
        return self._step_gate

    def _elastic_remesh(self, dead_ranks):
        """Adopt the surviving membership after a member loss: record the
        dead ranks, re-mesh the store, build the survivors' process group
        now (every survivor recovers in the same order) and drop the step
        gate. The last one standing trains on the local program. The
        caller (``fit``'s elastic path) then restores the checkpoint."""
        from .. import dist
        dist.mark_member_lost(dead_ranks)
        live = dist.live_ranks()
        kv = self._kvstore
        if kv is not None:
            kv._remesh(live)
        self._step_gate = None
        dist.live_group()
        telemetry.counter_inc("elastic.remesh")
        telemetry.record_event("elastic.remesh", dead=list(dead_ranks),
                               live=list(live))
        self.logger.warning(
            "elastic re-mesh: worker(s) %s dead, continuing on %s "
            "(%d live)", sorted(dead_ranks), list(live), len(live))

    def _run_step(self, ex, names, add_names, update_fn):
        """One executor's train step: forward and backward on its bound
        batch, ``update_fn`` on the gradients, aux, outputs and ``'add'``
        accumulators written back."""
        grad_dict = ex.grad_dict
        ex.outputs = []         # the last outputs die before new ones live
        step = ex._prog.train_step_fn(names, add_names, update_fn)
        record_dispatch("train_step")
        with telemetry.span("step"):
            outs, aux_up, grads_out = step(
                ex._raw_args(), ex._raw_aux(),
                {n: grad_dict[n]._data for n in add_names})
        ex._write_aux(aux_up)
        ex._set_outputs(outs)
        with torch.no_grad():       # the accumulators, already summed
            for n, g in grads_out.items():
                grad_dict[n]._data.copy_(g)

    def _fused_all_reduce(self, grads):
        """The fused step's wire: every gradient summed over the workers
        in one bucketed collective (``kv_push`` span, the
        ``kvstore.dist.*`` counters). Returns the sums."""
        from ..kvstore import bucketed_all_reduce
        with telemetry.span("kv_push"), torch.no_grad():
            reduced = bucketed_all_reduce(grads)
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        telemetry.counter_inc("kvstore.dist.fused_steps")
        telemetry.counter_inc("kvstore.dist.collectives")
        telemetry.counter_inc("kvstore.dist.wire_bytes", nbytes)
        telemetry.counter_inc("kvstore.dist.wire_bytes_raw", nbytes)
        self._kvstore.wire_bytes_last_push = nbytes
        self._kvstore.wire_bytes_last_push_raw = nbytes
        return reduced

    def get_outputs(self, merge_multi_context=True):
        """The outputs of the last forward: over several contexts
        concatenated along the batch on the first context (or, without
        ``merge_multi_context``, one list per output of each context's
        part). On a mesh the members' rows gathered over ``dp`` (a
        collective)."""
        if self._layout is not None:
            return self._gathered_rows(lambda ex: [o._data
                                                   for o in ex.outputs],
                                       merge_multi_context)
        return merge_outputs([ex.outputs for ex in self._execs],
                             merge_multi_context)

    def _gathered_rows(self, pick, merge):
        from ..ndarray.ndarray import NDArray
        layout, ctx = self._layout, self._context[0]
        got = self._members(lambda j, ex: [layout.gather_rows(t)
                                           for t in pick(ex)])[0]
        outs = [NDArray(t, ctx) for t in got]
        return outs if merge else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads: bind with "
                             "inputs_need_grad=True")
        if self._layout is not None:
            return self._gathered_rows(
                lambda ex: [ex.grad_dict[n]._data for n in self._data_names
                            if n in ex.grad_dict], merge_multi_context)
        return merge_outputs(
            [[ex.grad_dict[n] for n in self._data_names
              if n in ex.grad_dict] for ex in self._execs],
            merge_multi_context)

    def update_metric(self, eval_metric, labels):
        # the non-blocking per-batch accumulate; the blocking host fetch
        # records separately as "metric_fetch"
        with telemetry.span("metric_update"):
            eval_metric.update(labels if isinstance(labels, (list, tuple))
                               else [labels], self.get_outputs())

    def install_monitor(self, mon):
        """Tap the executor's op outputs into ``mon`` (parity:
        module.install_monitor); the fused step then phase-splits."""
        if not self.binded:
            raise MXNetError("install_monitor: bind first")
        # on a mesh the monitor taps the first member (its rows)
        for ex in self._execs[:1] if self._layout is not None \
                else self._execs:
            mon.install(ex)

    def finite_check(self):
        """The divergence sentinel's verdict (parity: module.finite_check):
        ``isfinite`` folded on the device over the last step's outputs,
        every gradient array and every parameter, then one host read."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("finite_check: bind and init_params first")
        leaves = []
        for ex in self._execs:
            leaves += [o._data for o in ex.outputs]
            leaves += [g._data for g in ex.grad_dict.values()
                       if g is not None]
        leaves += [self._exec.arg_dict[n]._data for n in self._param_names]
        if self._layout is not None:        # every member's shards
            leaves += [ex.arg_dict[n]._data for ex in self._execs[1:]
                       for n in self._param_names]
        leaves = [t for t in leaves if t.is_floating_point()]
        if not leaves:
            return True
        record_dispatch("finite_check")
        with telemetry.span("divergence_check"), torch.no_grad():
            dev = leaves[0].device
            ok = torch.stack([torch.isfinite(t).all().to(dev)
                              for t in leaves]).all()
            if self._layout is not None \
                    and self._mesh_spec.mesh.processes > 1:
                from ..parallel import collectives as C
                ok = C._all_reduce(ok.reshape(1).int(), None, "min")
            telemetry.record_host_sync("divergence_check")
            return bool(ok)

    # -- checkpoints -------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """(parity: module.save_checkpoint) the JAX package's files:
        ``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """(parity: Module.load) a Module whose params install at bind."""
        ctx = kwargs.get("context")
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if kwargs.get("partition_rules") is not None \
                or kwargs.get("mesh_axes"):
            ctx = cpu()          # the members take their shards from here
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=ctx)
        mod = Module(symbol, **kwargs)
        mod._arg_params = arg_params
        mod._aux_params = aux_params
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_optimizer_states(self, fname):
        """(parity: module.save_optimizer_states) the updater's pickled
        states (the store's under ``update_on_kvstore``), written
        atomically (temp file, fsync, rename)."""
        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states: init_optimizer first")
        from ..checkpoint import atomic_write
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        atomic_write(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Load states written by ``save_optimizer_states`` of either
        package."""
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states: init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())


class _MeshUpdater:
    """The optimizer of a mesh ``Module``: one ``FusedUpdater`` a local
    member over that member's shards of the weights, gradients and
    states, sharing the module's optimizer. A step's host bookkeeping
    (update counts, the scheduler's rate) runs once: every member starts
    from the same counts. ``get_states`` gathers the whole states (a
    collective) in the pickled form of both packages; ``set_states`` cuts
    each member's shards of them by the weight's placement."""

    def __init__(self, optimizer, module):
        self.optimizer = optimizer
        self._mod = module
        self.members = [opt.get_updater(optimizer) for _ in module._execs]

    @property
    def states(self):
        """The first local member's states (its shards)."""
        return self.members[0].states

    def update_members(self, indices, grads, weights):
        """One step: member ``j`` updates ``weights[j]`` by ``grads[j]``
        (the same parameter indices on every member)."""
        o = self.optimizer
        counts, num = dict(o._index_update_count), o.num_update
        for upd, gs, ws in zip(self.members, grads, weights):
            o._index_update_count, o.num_update = dict(counts), num
            upd.update_batch(indices, gs, ws)

    def get_states(self, dump_optimizer=False):
        from ..ndarray.ndarray import NDArray
        mod = self._mod
        layout, names = mod._layout, mod._param_names

        def whole(j, ex):
            upd, out = self.members[j], {}
            with torch.no_grad():
                for i in sorted(upd.states):
                    name = names[i]
                    upd._ensure_state(i, ex.arg_dict[name])   # loaded ones
                    out[i] = _map_state(upd.states[i], lambda a: NDArray(
                        layout.whole(name, a._data), a.context))
            return out
        host = opt.Updater(self.optimizer)
        host.states = mod._members(whole)[0]
        return host.get_states(dump_optimizer)

    def set_states(self, states):
        mod = self._mod
        layout, names, mesh = mod._layout, mod._param_names, \
            mod._mesh_spec.mesh
        for j, upd in enumerate(self.members):
            upd.set_states(states)
            coords = mesh.coords(j)
            upd.states = {i: _map_state(s, lambda a, n=names[i]: np.array(
                layout.own_at(n, torch.from_numpy(np.asarray(a)), coords)))
                for i, s in upd.states.items()}


def _map_state(state, fn):
    """``fn`` over the arrays of one optimizer state (None, an array, or a
    tuple of them)."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(x, fn) for x in state)
    return fn(state)


def _as_desc(d):
    from ..io import DataDesc
    if isinstance(d, DataDesc):
        return d
    return DataDesc(d[0], d[1])
