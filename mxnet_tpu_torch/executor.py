"""Graph evaluation, shape inference and the bound Executor.

Counterpart of ``mxnet_tpu/executor.py`` (``_GraphProgram``,
``eval_graph``, ``forward_fn``, ``fwd_bwd_fn``, ``train_step_fn``,
``infer_graph_attrs``, ``Executor`` with gradients, ``simple_bind``,
``record_dispatch`` and the program cards of ``_InstrumentedProgram``).
The JAX package traces the whole graph into one XLA program; here the
graph is evaluated op by op in topological order — PyTorch dispatches
each op asynchronously on the device, and what XLA fused is either left
to cuDNN/cuBLAS or a hand-written kernel. Gradients are
``torch.autograd`` over that evaluation; the JAX package's jitted,
buffer-donating entry points are eager functions here (one captured
CUDA graph per step is later work, ROADMAP).

Every entry point (``forward_fn``, ``fwd_bwd_fn``, ``train_step_fn``)
runs through ``_InstrumentedProgram``: the ``dispatch`` fault site, and
one PROGRAM CARD per entry point and abstract signature in
``telemetry.programs()`` with the JAX package's card schema, built at
the signature's first call. Nothing is compiled, so ``trace_ms`` and
``compile_ms`` stay None; ``flops`` counts what
``torch.utils.flop_counter.FlopCounterMode`` sees (aten matmuls and
convolutions at 2 FLOPs per multiply-add; elementwise work and kernels
launched through ``ctypes`` count 0).

Shape inference runs the same op functions on ``meta`` tensors (shape
and dtype only, no data, no device): the counterpart of
``jax.eval_shape``.
"""
from __future__ import annotations

import ast
import contextlib
import hashlib
import itertools
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import current_context
from .ops.common import take_rng
from .ops.tensor import creation_device
from . import telemetry
from . import faults

__all__ = ["Executor", "ReplicaSet", "infer_graph_attrs",
           "infer_graph_shapes", "record_dispatch", "make_card",
           "DeviceMemoryError"]


# ---------------------------------------------------------------------------
# Dispatch accounting
# ---------------------------------------------------------------------------
# One call per program execution (a serving batch, a training step, an
# executor forward), not per op. Every dispatch fans out through
# ``telemetry.dispatch_event`` — the counter registry plus every
# ``telemetry.on_dispatch(cb)`` subscriber. ``dispatch_hook`` is the
# single-slot shim (a callable taking one tag string) kept as in the JAX
# package; prefer the multi-subscriber registry.
dispatch_hook = None


def record_dispatch(kind):
    """Report one program execution to the telemetry dispatch registry
    (and the single-slot ``dispatch_hook`` shim)."""
    if dispatch_hook is not None:
        dispatch_hook(kind)
    telemetry.dispatch_event(kind)


# ---------------------------------------------------------------------------
# Instrumented entry points (program cards)
# ---------------------------------------------------------------------------

_PROG_SEQ = itertools.count(1)
_QUIET = threading.local()


class DeviceMemoryError(MXNetError):
    """A device allocation failure re-raised with the live buffer ledger
    and the failing program's memory card in its message (the JAX
    package's ``executor.DeviceMemoryError``). The original error rides
    as ``__cause__``: ``torch.OutOfMemoryError`` from the caching
    allocator, or a ``RuntimeError`` of cuBLAS or cuDNN whose text
    carries an OOM marker."""


_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "Out of memory", "out of memory", "OOM")


def _is_oom(exc):
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    s = str(exc)
    return isinstance(exc, RuntimeError) and any(m in s
                                                 for m in _OOM_MARKERS)


def _fmt_bytes(n):
    if n is None:
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return "%.1f%s" % (n, unit) if unit != "B" else "%dB" % n
        n /= 1024.0
    return "%d" % n


def _enriched_oom(exc, card):
    """The DeviceMemoryError for one dispatch-time OOM, in the JAX
    package's lines: the backend's message first, then the program's
    memory card, the ledger's per-context totals and top live buffers,
    and the card's allocator counters (``storage.Storage.device_stats``)
    where there is a card."""
    lines = ["device memory exhausted dispatching program %r: %s"
             % (card.get("id", "?"), exc)]
    lines.append(
        "program memory card: peak_bytes=%s argument_bytes=%s "
        "output_bytes=%s temp_bytes=%s generated_code_bytes=%s "
        "flops=%s bytes_accessed=%s" % (
            _fmt_bytes(card.get("peak_bytes")),
            _fmt_bytes(card.get("argument_bytes")),
            _fmt_bytes(card.get("output_bytes")),
            _fmt_bytes(card.get("temp_bytes")),
            _fmt_bytes(card.get("generated_code_bytes")),
            card.get("flops"), card.get("bytes_accessed")))
    led = telemetry.ledger()
    if led:
        lines.append("live device-buffer ledger:")
        for ctx, st in sorted(led.items()):
            lines.append("  %s: %d buffers alive / %s (peak %s)"
                         % (ctx, st["alive_count"],
                            _fmt_bytes(st["alive_bytes"]),
                            _fmt_bytes(st["peak_bytes"])))
    top = telemetry.ledger_top(8)
    if top:
        lines.append("top live buffers:")
        for b in top:
            lines.append("  %s %s %s %s [%s]"
                         % (_fmt_bytes(b["nbytes"]),
                            tuple(b["shape"] or ()), b["dtype"], b["ctx"],
                            b["kind"]))
    from .storage import Storage
    stats = Storage.device_stats()
    if stats:
        lines.append("device allocator stats: bytes_in_use=%s "
                     "peak_bytes_in_use=%s bytes_reserved=%s bytes_limit=%s"
                     % tuple(_fmt_bytes(stats[k]) for k in (
                         "bytes_in_use", "peak_bytes_in_use",
                         "bytes_reserved", "bytes_limit")))
    return DeviceMemoryError("\n".join(lines))


@contextlib.contextmanager
def quiet(on=True):
    """Within this scope (this thread) an instrumented entry point runs
    its function bare: no card, no dispatch count, no fault site. The
    members of a mesh run so where one member, or the engine around
    them, carries the instrumentation."""
    prev = getattr(_QUIET, "on", False)
    _QUIET.on = bool(on)
    try:
        yield
    finally:
        _QUIET.on = prev


def make_card(kind, entry, signature, flops=None, argument_bytes=None,
              output_bytes=None, peak_bytes=None):
    """One JSON-safe program card with the JAX package's schema
    (``executor.card_from_compiled``'s keys). The fields only an XLA
    compile can fill (bytes accessed, transcendentals, aliasing, temp
    arena, code size, trace and compile time) stay None."""
    return {
        "id": entry, "kind": kind, "signature": signature,
        "donated": [], "dispatches": 0,
        "flops": flops, "bytes_accessed": None, "transcendentals": None,
        "peak_bytes": peak_bytes, "argument_bytes": argument_bytes,
        "output_bytes": output_bytes, "alias_bytes": None,
        "temp_bytes": None, "generated_code_bytes": None,
        "trace_ms": None, "compile_ms": None, "source": "eager",
    }


def _leaves(tree, path=""):
    """(path, leaf) pairs of nested dicts/lists/tuples, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], "%s[%r]" % (path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, "%s[%d]" % (path, i))
    else:
        yield path, tree


def _leaf_key(leaf):
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return (tuple(leaf.shape), str(leaf.dtype))
    return type(leaf).__name__


def _dispatch_key(tree):
    """The abstract signature as a hashable key, cheap enough for every
    call (shapes and dtypes, no strings built; a Python scalar keys by its
    type): one key per card."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree.shape, tree.dtype
    if isinstance(tree, dict):
        return tuple((k, (v.shape, v.dtype) if type(v) is torch.Tensor
                      else _dispatch_key(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_dispatch_key(v) for v in tree)
    return type(tree)


def _nbytes(tree):
    total = 0
    for _, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


class _InstrumentedProgram:
    """One entry point with the JAX package's instrumentation contract:

    * one PROGRAM CARD per abstract signature (argument shapes and dtypes;
      a Python scalar keys by its type, as a traced scalar does), built at
      the signature's first call: ``flops`` from ``FlopCounterMode``
      around that call, ``argument_bytes``/``output_bytes`` from the
      tensors, ``peak_bytes`` from the allocator's peak around it (None
      off CUDA). The first call runs exactly as any other; only the
      counting wraps it;
    * ``program_dispatch`` bumps the card's count on every call;
    * the ``dispatch`` fault site fires before every call (``nan`` fills
      the call's outputs with NaN);
    * ``build(*args)`` runs the call and builds its card WITHOUT counting
      a dispatch or consulting the fault site — the warm-up path, so
      cards count the same dispatches as the JAX package's, whose
      warm-up compiles without executing.

    ``out_index`` picks the element of the result that holds the call's
    outputs (the ``nan`` payload); ``on_card`` is called with each new
    card.
    """

    __slots__ = ("kind", "entry", "argnames", "out_index", "on_card",
                 "_fn", "_cards")

    def __init__(self, kind, fn, argnames=(), out_index=0, on_card=None,
                 entry=None, cards=None):
        self.kind = kind
        self.entry = entry or "%s@p%d" % (kind, next(_PROG_SEQ))
        self.argnames = tuple(argnames)
        self.out_index = out_index
        self.on_card = on_card
        self._fn = fn
        self._cards = {} if cards is None else cards

    def _signature(self, args):
        """The card's named signature: [[path, shape, dtype, None], ...]
        (the JAX card's layout; no sharding) — built once per card."""
        sig = []
        for i, a in enumerate(args):
            head = self.argnames[i] if i < len(self.argnames) \
                else "[%d]" % i
            for path, leaf in _leaves(a, head):
                k = _leaf_key(leaf)
                if isinstance(k, tuple):
                    sig.append([path, list(k[0]), k[1], None])
                else:
                    sig.append([path, [], k, None])
        return sig

    def _run_carded(self, key, args):
        """The signature's first call: run it under the counters and
        register its card."""
        from torch.utils.flop_counter import FlopCounterMode
        sig = self._signature(args)
        dev = next((leaf.device for a in args for _, leaf in _leaves(a)
                    if isinstance(leaf, torch.Tensor)), None)
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        counter = FlopCounterMode(display=False)
        with counter:
            result = self._fn(*args)
        out = result[self.out_index] \
            if isinstance(result, (list, tuple)) else result
        card = make_card(
            self.kind, "%s/s%d" % (self.entry, len(self._cards)), sig,
            flops=float(counter.get_total_flops()),
            argument_bytes=_nbytes(args), output_bytes=_nbytes(out),
            peak_bytes=(torch.cuda.max_memory_allocated(dev) - base
                        + _nbytes(args)) if cuda else None)
        self._cards[key] = card
        telemetry.record_program(card)
        if self.on_card is not None:
            self.on_card(card)
        return result

    def _oom_guard(self, key, fn, *args):
        """``fn(*args)``, with a device allocation failure re-raised as
        ``DeviceMemoryError`` (its card: the signature's, or, on its first
        call, the id the card would have taken) after a postmortem."""
        try:
            return fn(*args)
        except RuntimeError as e:     # torch.OutOfMemoryError is one
            if isinstance(e, DeviceMemoryError) or not _is_oom(e):
                raise
            card = self._cards.get(key) or {
                "id": "%s/s%d" % (self.entry, len(self._cards))}
            err = _enriched_oom(e, card)
            # the ledger and card evidence dies with the process: dump the
            # flight window too (a no-op without a flight directory)
            from . import flight
            flight.postmortem("device_memory_error", exc=err,
                              extra={"program": card.get("id"),
                                     "kind": self.kind})
            raise err from e

    def build(self, *args):
        """Run one call and build its signature's card (when telemetry
        is on and the card is new) without counting a dispatch."""
        if getattr(_QUIET, "on", False):
            return self._fn(*args)
        key = _dispatch_key(args)
        if key not in self._cards and telemetry.enabled():
            return self._oom_guard(key, self._run_carded, key, args)
        return self._oom_guard(key, self._fn, *args)

    def __call__(self, *args):
        if getattr(_QUIET, "on", False):
            return self._fn(*args)
        key = _dispatch_key(args)
        card = self._cards.get(key)
        telemetry.program_dispatch(card)
        act = faults.fire("dispatch")
        if card is None and telemetry.enabled():
            result = self._oom_guard(key, self._run_carded, key, args)
            telemetry.program_dispatch(self._cards[key])
        else:
            result = self._oom_guard(key, self._fn, *args)
        if act == "nan":
            out = result[self.out_index] \
                if isinstance(result, (list, tuple)) else result
            faults.poison([t for _, t in _leaves(out)])
        return result


class _GraphProgram:
    """The evaluation order and entry points of one Symbol.

    With ``group2ctx`` (the reference's model parallelism by op group,
    AssignContext and the cross-device copy, graph_executor.cc:318-440):
    a node whose ``ctx_group`` (or ``__ctx_group__``) attribute names a
    group of the map runs on that group's Context, a variable without a
    group of its own lives on its first consumer's, and everything else
    on ``default_ctx``. An input crossing a group boundary is copied to
    the consumer's device with ``Tensor.to`` (differentiable: the
    gradient flows back to the producer's device). ``node_ctx`` maps
    node ids to Contexts (None without groups)."""

    def __init__(self, symbol, group2ctx=None, default_ctx=None):
        self.symbol = symbol
        # callable(output name, raw tensor) fed every op output of an
        # evaluation while set (the executor's monitor callback); one per
        # replica (or None) for the replicas' entry points (``ReplicaSet``)
        self.tap = None
        self.replica_taps = None
        # a mesh member's parameters (``parallel.spmd.MeshParams``): the
        # member holds shards, an op reads a sharded one gathered whole,
        # and gradients are summed over the data axis; None off a mesh
        self.layout = None
        self._entries = {}      # (kind, statics) -> (entry id, cards)
        self.nodes = symbol._topo_nodes()
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_entries = list(symbol._outputs)
        # the position of each node's last reader: its outputs are
        # dropped from the evaluation's environment after it (outputs of
        # the graph are kept), so a forward holds no more than eager code
        last = {}
        for pos, node in enumerate(self.nodes):
            for child, _ in node.inputs:
                last[id(child)] = pos
        for node, _ in self.output_entries:
            last[id(node)] = len(self.nodes)
        self._drop_after = [[] for _ in self.nodes]
        for node in self.nodes:
            pos = last.get(id(node))
            if pos is not None and pos < len(self.nodes):
                self._drop_after[pos].append(id(node))
        self.node_ctx = None
        self.default_ctx = default_ctx
        if group2ctx:
            self.node_ctx = {}
            for node in self.nodes:
                g = (node._extra_attrs.get("ctx_group")
                     or node._extra_attrs.get("__ctx_group__"))
                if g is not None and g in group2ctx:
                    self.node_ctx[id(node)] = group2ctx[g]
            for node in self.nodes:
                ctx = self.node_ctx.get(id(node)) if node.op is not None \
                    else None
                if ctx is None:
                    continue
                for child, _ in node.inputs:
                    if child.op is None and id(child) not in self.node_ctx:
                        self.node_ctx[id(child)] = ctx

    def var_contexts(self):
        """``{variable name: Context}`` of the grouped variables."""
        if not self.node_ctx:
            return {}
        return {n.name: self.node_ctx[id(n)] for n in self.nodes
                if n.op is None and id(n) in self.node_ctx}

    def output_context(self, i, default):
        """The Context output ``i`` lives on: its node's group's, else
        ``default``."""
        if not self.node_ctx:
            return default
        node, _ = self.output_entries[i]
        return self.node_ctx.get(id(node), default)

    def _apply_node(self, node, raw_in, train, aux_updates, device):
        params = dict(node.op.defaults)
        params.update(node.attrs)
        params.pop("num_args", None)
        params.pop("name", None)
        if node.op.takes_train:
            params["_train"] = bool(train)
        if node.op.nin == 0 and params.get("ctx") is None:
            params["ctx"] = device
        if node.op.takes_rng:
            params["_rng"] = take_rng(raw_in[0].device if raw_in
                                      else creation_device(params["ctx"]))
        outs = node.op.apply(raw_in, params)
        if train and node.op.stateful_update is not None:
            for in_idx, val in node.op.stateful_update(
                    raw_in, outs, params).items():
                child, _ = node.inputs[in_idx]
                if child.op is None and child.name in self.aux_names:
                    val = val.detach()
                    if self.layout is not None:
                        val = self.layout.own(child.name, val)
                    aux_updates[child.name] = val
        return outs

    def eval_graph(self, arg_dict, aux_dict, train=False):
        """Evaluate the graph on raw tensors. Returns (outputs,
        aux_updates): in training mode the new moving stats of every
        stateful op (BatchNorm), by aux name, detached. A creation op
        makes its tensor on the device of the arguments, and a random op
        draws from that device's generator (``ops/common.take_rng``), in
        the graph's topological order."""
        outs, aux_up = self.eval_replicas([arg_dict], [aux_dict], train,
                                          taps=[self.tap])
        return outs[0], aux_up[0]

    def eval_replicas(self, arg_dicts, aux_dicts, train=False,
                      over_workers=False, taps=None):
        """``eval_graph`` of several replicas (one argument and aux dict
        each, on their own devices) node by node together. In training
        mode a stateful op of several replicas, or with
        ``over_workers``, takes its batch statistics over every
        replica's rows and every worker's (``ops/nn.batch_stats_over``):
        what the JAX package's one program over a mesh computes. Returns
        (outputs, aux_updates), one of each per replica; ``taps`` holds
        one tap (or None) per replica. On a mesh member (``layout``) an
        op reads each sharded parameter gathered whole, and training-mode
        batch statistics span the data axis."""
        layout = self.layout
        with (layout.batch_stats() if layout is not None and train
              else contextlib.nullcontext()):
            return self._eval_replicas(arg_dicts, aux_dicts, train,
                                       over_workers, taps)

    def _eval_replicas(self, arg_dicts, aux_dicts, train, over_workers,
                       taps):
        from .ops.nn import batch_stats_over
        layout = self.layout
        n = len(arg_dicts)
        taps = taps or [None] * n
        envs = [{} for _ in range(n)]
        aux_ups = [{} for _ in range(n)]
        devices = [next((t.device for t in a.values()), None)
                   for a in arg_dicts]
        shared = train and (n > 1 or over_workers)
        grouped = self.node_ctx
        for pos, node in enumerate(self.nodes):
            if node.op is None:
                for env, args, aux in zip(envs, arg_dicts, aux_dicts):
                    if node.name in args:
                        env[id(node)] = (args[node.name],)
                    elif node.name in aux:
                        env[id(node)] = (aux[node.name],)
                    else:
                        raise MXNetError("unbound variable %r" % node.name)
                continue
            raws = [[env[id(c)][idx] for c, idx in node.inputs]
                    for env in envs]
            node_devices = devices
            if grouped:
                ctx = grouped.get(id(node), self.default_ctx)
                dev = ctx.torch_device() if ctx is not None else devices[0]
                # the cross-device copy at a group boundary
                raws = [[r.to(dev) if r.device != dev else r for r in rw]
                        for rw in raws]
                node_devices = [dev] * n
            if layout is not None:
                raws = [[layout.whole(c.name, r) if c.op is None else r
                         for (c, _), r in zip(node.inputs, rw)]
                        for rw in raws]
            with (batch_stats_over([r[0] for r in raws], over_workers)
                  if shared and node.op.stateful_update is not None
                  else contextlib.nullcontext()):
                for i, env in enumerate(envs):
                    env[id(node)] = self._apply_node(node, raws[i], train,
                                                     aux_ups[i],
                                                     node_devices[i])
            del raws
            for env, tap in zip(envs, taps):
                if tap is not None:
                    self._tap_outputs(node, env[id(node)], tap)
                for key in self._drop_after[pos]:
                    env.pop(key, None)
        return [[env[id(nd)][idx] for nd, idx in self.output_entries]
                for env in envs], aux_ups

    @staticmethod
    def _tap_outputs(node, outs, tap):
        """Each visible output of ``node`` to ``tap`` under the name
        ``get_internals().list_outputs()`` gives it, detached."""
        n = node.num_outputs()
        for i in range(n):
            name = node.name + "_output" if n == 1 \
                else "%s_output%d" % (node.name, i)
            tap(name, outs[i].detach())

    def graph_fingerprint(self):
        """JSON-safe fingerprint of this program's graph, computed as the
        JAX package computes it (the symbol's JSON hashed, plus the
        ambient layout default), so both packages fingerprint one symbol
        alike: the autotuner's corpus filter reads it."""
        fp = self.__dict__.get("_graph_fp")
        if fp is None:
            from . import layout
            fp = self._graph_fp = [
                hashlib.sha256(self.symbol.tojson().encode()).hexdigest(),
                layout.get_default_layout()]
        return fp

    def _instrumented(self, kind, statics, fn, argnames):
        """``fn`` behind one instrumented entry per (kind, statics): the
        entry id and its cards outlive the closure, so every call of
        ``forward_fn(train)`` shares one card per signature."""
        ent = self._entries.get((kind, statics))
        if ent is None:
            ent = self._entries[(kind, statics)] = (
                "%s@p%d" % (kind, next(_PROG_SEQ)), {})
        return _InstrumentedProgram(kind, fn, argnames=argnames,
                                    entry=ent[0], cards=ent[1])

    def forward_fn(self, train=False):
        """``fn(args, aux) -> (outputs, aux_updates)`` over raw tensors,
        run without autograd (an ``_InstrumentedProgram``)."""
        def fn(args, aux):
            with torch.no_grad():
                return self.eval_graph(args, aux, train)
        return self._instrumented("forward", (bool(train),), fn,
                                  ("args", "aux"))

    def forward_train_fn(self, grad_names):
        """``fn(args, aux) -> (outputs, leaves, aux_updates)``: the
        training forward that keeps its graph for a later backward (the
        executor's ``forward(is_train=True)``), instrumented like
        ``forward_fn``."""
        grad_names = tuple(grad_names)

        def fn(args, aux):
            return self._vjp_over_graph(grad_names, args, aux, True)
        return self._instrumented("forward", (True, grad_names), fn,
                                  ("args", "aux"))

    def _vjp_over_graph(self, grad_names, args, aux, train):
        """The one forward scaffold both ``fwd_bwd_fn`` and
        ``train_step_fn`` run: the graph evaluated with ``grad_names``'s
        tensors as fresh autograd leaves. Returns (outputs, leaves,
        aux_updates)."""
        outs, leaves, aux_up = self._vjp_over_replicas(
            grad_names, [args], [aux], train, taps=[self.tap])
        return outs[0], leaves[0], aux_up[0]

    def _vjp_over_replicas(self, grad_names, args_list, aux_list, train,
                           over_workers=False, taps=None):
        """``_vjp_over_graph`` of several replicas together
        (``eval_replicas``): one list entry per replica."""
        leaves = [{k: args[k].detach().requires_grad_(True)
                   for k in grad_names} for args in args_list]
        with torch.enable_grad():
            outs, aux_up = self.eval_replicas(
                [{**args, **lv} for args, lv in zip(args_list, leaves)],
                aux_list, train, over_workers, taps)
        return outs, leaves, aux_up

    def _reduced(self, grads):
        """A mesh member's gradients summed over the data axis (as they
        are off a mesh)."""
        return grads if self.layout is None \
            else self.layout.reduce_grads(grads)

    @staticmethod
    def _grads(outs, leaves, head_grads=None):
        """``{name: gradient}`` of the outputs (head gradients ones where
        not given) with respect to the leaves; a leaf the outputs do not
        reach gets zeros."""
        return _GraphProgram._replica_grads(
            [outs], [leaves], None if head_grads is None else [head_grads])[0]

    @staticmethod
    def _replica_grads(outs, leaves, head_grads=None):
        """``_grads`` of several replicas in one backward over their joint
        graph (their batch statistics tie them together): one dict per
        replica."""
        pairs = []
        for r, outs_r in enumerate(outs):
            hg = head_grads[r] if head_grads is not None else None
            pairs += [(o, hg[i].to(o.device)
                       if hg is not None and hg[i] is not None
                       else torch.ones_like(o))
                      for i, o in enumerate(outs_r) if o.requires_grad]
        keys = [(r, n) for r, lv in enumerate(leaves) for n in lv]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [leaves[r][n] for r, n in keys],
                                  [g for _, g in pairs],
                                  allow_unused=True) if pairs and keys \
            else [None] * len(keys)
        res = [{} for _ in leaves]
        for (r, n), g in zip(keys, got):
            res[r][n] = g if g is not None else torch.zeros_like(leaves[r][n])
        return res

    def replicas_fn(self, kind, grad_names, n, over_workers):
        """Training-mode entry points of ``n`` replicas run together
        (``ReplicaSet``), instrumented like the others. ``kind``
        ``"forward"``: ``fn(args_list, aux_list) -> (outputs, leaves,
        aux_updates)`` keeping the joint graph; ``"fwd_bwd"`` (and
        ``"train_step"``, the fused step's card): ``fn(args_list,
        aux_list, head_grads) -> (outputs, grads, aux_updates)``, outputs
        detached. One list entry per replica."""
        grad_names = tuple(grad_names)

        def forward(args_list, aux_list):
            return self._vjp_over_replicas(grad_names, args_list, aux_list,
                                           True, over_workers,
                                           self.replica_taps)

        def fwd_bwd(args_list, aux_list, head_grads=None):
            outs, leaves, aux_up = self._vjp_over_replicas(
                grad_names, args_list, aux_list, True, over_workers,
                self.replica_taps)
            grads = self._replica_grads(outs, leaves, head_grads)
            return [[o.detach() for o in o_r] for o_r in outs], grads, aux_up
        fn, names = (forward, ("args", "aux")) if kind == "forward" \
            else (fwd_bwd, ("args", "aux", "head_grads"))     # or train_step
        return self._instrumented(
            kind, ("replicas", n, bool(over_workers), grad_names), fn, names)

    def fwd_bwd_fn(self, train, grad_names):
        """``fn(args, aux, head_grads) -> (outputs, grads, aux_updates)``:
        forward and backward in one call (parity: ``fwd_bwd_fn``);
        outputs detached, gradients by argument name."""
        grad_names = tuple(grad_names)

        def fn(args, aux, head_grads=None):
            outs, leaves, aux_up = self._vjp_over_graph(grad_names, args,
                                                        aux, train)
            grads = self._reduced(self._grads(outs, leaves, head_grads))
            return [o.detach() for o in outs], grads, aux_up
        return self._instrumented("fwd_bwd", (bool(train), grad_names), fn,
                                  ("args", "aux", "head_grads"))

    def train_step_fn(self, update_names, add_names, update_fn):
        """The whole training step (parity: ``train_step_fn``):
        ``step(args, aux, add_grads) -> (outputs, aux_updates,
        grads_out)`` runs forward and backward in training mode, casts each
        gradient to its parameter's dtype, adds the running accumulator of
        a ``grad_req='add'`` parameter, then hands the gradients, in
        ``update_names`` order, to ``update_fn`` (the optimizer, which
        updates the weights in place). Only the ``'add'`` accumulators come
        back (``grads_out``); a ``'write'`` gradient lives and dies inside
        the step."""
        update_names = tuple(update_names)
        add_names = frozenset(add_names)

        def step(args, aux, add_grads):
            outs, leaves, aux_up = self._vjp_over_graph(update_names, args,
                                                        aux, True)
            grads = self._reduced(self._grads(outs, leaves))
            outs = [o.detach() for o in outs]
            del leaves
            gs, grads_out = [], {}
            for k in update_names:
                g = grads.pop(k).to(args[k].dtype)
                if k in add_names:
                    g = add_grads[k] + g
                    grads_out[k] = g
                gs.append(g)
            update_fn(gs)
            return outs, aux_up, grads_out
        return self._instrumented(
            "train_step", (update_names, tuple(sorted(add_names))), step,
            ("args", "aux", "add_grads"))


# ---------------------------------------------------------------------------
# Shape inference over the graph
# ---------------------------------------------------------------------------

def infer_graph_attrs(symbol, known_shapes, known_types=None, partial=False,
                      default_dtype=torch.float32):
    """Joint shape+dtype inference (parity: the reference's InferShape and
    InferType passes). Unknown learnable-input shapes come from the op
    hooks (``ops/shape_infer.py``), dtypes from the op's first floating
    input or its ``param_dtype_infer`` hook, and output shapes from
    running the op on ``meta`` tensors. Returns (arg_shapes, out_shapes,
    aux_shapes, arg_types, out_types, aux_types)."""
    from .ops.common import torch_dtype
    nodes = symbol._topo_nodes()
    var_shape = dict(known_shapes)
    var_type = {k: torch_dtype(v) for k, v in (known_types or {}).items()
                if v is not None}
    shapes, types = {}, {}

    for node in nodes:
        if node.op is None:
            shp = var_shape.get(node.name)
            if shp is None and "__shape__" in node._extra_attrs:
                shp = tuple(ast.literal_eval(node._extra_attrs["__shape__"]))
                var_shape[node.name] = shp
            dt = var_type.get(node.name)
            if dt is None and "__dtype__" in node._extra_attrs:
                dt = var_type[node.name] = torch_dtype(
                    node._extra_attrs["__dtype__"])
            shapes[id(node)] = (shp,)
            types[id(node)] = (dt,)
            continue
        in_shapes = [shapes[id(c)][idx] for c, idx in node.inputs]
        in_types = [types[id(c)][idx] for c, idx in node.inputs]
        params = dict(node.op.defaults)
        params.update(node.attrs)
        params.pop("num_args", None)
        if node.op.param_shape_infer is not None and in_shapes[0] is not None:
            for i, shp in node.op.param_shape_infer(in_shapes, params).items():
                if i < len(node.inputs) and in_shapes[i] is None:
                    child, _ = node.inputs[i]
                    if child.op is None:
                        var_shape[child.name] = tuple(shp)
                        shapes[id(child)] = (tuple(shp),)
                        in_shapes[i] = tuple(shp)
        dtype_fills = {}
        if node.op.param_dtype_infer is not None:
            dtype_fills = node.op.param_dtype_infer(in_types, params)
        anchor = next((t for t in in_types
                       if t is not None and t.is_floating_point),
                      default_dtype)
        for i in range(len(in_types)):
            if in_types[i] is None:
                dt = dtype_fills.get(i, anchor)
                child, _ = node.inputs[i]
                if child.op is None:
                    var_type[child.name] = dt
                    types[id(child)] = (dt,)
                in_types[i] = dt
        n_out = node.num_outputs()
        if any(s is None for s in in_shapes):
            if partial:
                shapes[id(node)] = (None,) * n_out
                types[id(node)] = (anchor,) * n_out
                continue
            missing = [node.inputs[i][0].name
                       for i, s in enumerate(in_shapes) if s is None]
            raise MXNetError("infer_shape: cannot infer %r (missing inputs %s)"
                             % (node.name, missing))
        if node.op.takes_train:
            params["_train"] = False
        if node.op.takes_rng:
            params["_rng"] = None
        if node.op.nin == 0 and params.get("ctx") is None:
            params["ctx"] = torch.device("meta")
        metas = [torch.empty(s, dtype=t, device="meta")
                 for s, t in zip(in_shapes, in_types)]
        try:
            outs = node.op.apply(metas, params)
        except Exception as e:
            if partial:
                shapes[id(node)] = (None,) * n_out
                types[id(node)] = (None,) * n_out
                continue
            raise MXNetError("infer_shape failed at %s(%s): %s"
                             % (node.op.name, node.name, e))
        shapes[id(node)] = tuple(tuple(o.shape) for o in outs)
        types[id(node)] = tuple(o.dtype for o in outs)

    def pick(table, n, idx):
        v = table.get(id(n))
        return None if v is None or idx >= len(v) else v[idx]

    return ([var_shape.get(n) for n in symbol.list_arguments()],
            [pick(shapes, n, i) for n, i in symbol._outputs],
            [var_shape.get(n) for n in symbol.list_auxiliary_states()],
            [var_type.get(n) for n in symbol.list_arguments()],
            [pick(types, n, i) for n, i in symbol._outputs],
            [var_type.get(n) for n in symbol.list_auxiliary_states()])


def infer_graph_shapes(symbol, known_shapes, partial=False):
    """Shape-only view of infer_graph_attrs."""
    res = infer_graph_attrs(symbol, known_shapes, partial=partial)
    return res[0], res[1], res[2]


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

_GRAD_REQS = ("null", "write", "add")


class Executor:
    """A bound graph (parity: python/mxnet/executor.py): forward in
    inference or training mode, backward, forward_backward, gradient
    arrays under ``grad_req`` write/add/null, and the moving-stat
    writeback of training-mode forwards."""

    def __init__(self, symbol, ctx, arg_arrays, aux_arrays, program=None,
                 grad_arrays=None, grad_req="null", group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self._device = self._ctx.torch_device()
        self._prog = program or _GraphProgram(
            symbol, group2ctx=group2ctx,
            default_ctx=self._ctx if group2ctx else None)
        self._arg_names = self._prog.arg_names
        self._aux_names = self._prog.aux_names
        if grad_arrays is None:
            grad_arrays = [None] * len(self._arg_names)
        # a grouped variable lives on its group's Context (checked as a
        # Context: cpu(0) and cpu(1) are two groups on one host), every
        # other array on the executor's device
        placed = self._prog.var_contexts()
        for name, arr in list(zip(self._arg_names, arg_arrays)) + \
                list(zip(self._aux_names, aux_arrays)) + \
                list(zip(self._arg_names, grad_arrays)):
            if arr is None:
                continue
            want = placed.get(name)
            if want is not None:
                if arr.context != want \
                        or arr._data.device != want.torch_device():
                    raise MXNetError(
                        "bind: array %r lives on %s but its ctx_group maps "
                        "to %s; allocate it on the group's context"
                        % (name, arr.context, want))
            elif arr._data.device != self._device:
                raise MXNetError("bind: array %r lives on %s, the executor "
                                 "on %s" % (name, arr.context, self._ctx))
        self.arg_arrays = list(arg_arrays)
        self.aux_arrays = list(aux_arrays)
        self.grad_arrays = list(grad_arrays)
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = {n: grad_req.get(n, "null") for n in self._arg_names}
        for n, req in self._grad_req.items():
            if req not in _GRAD_REQS:
                raise MXNetError("grad_req %r for %r (use write, add or "
                                 "null)" % (req, n))
            # no gradient array: no gradient (upstream's MXExecutorBindEX
            # turns the request into kNullOp)
            if self.grad_dict.get(n) is None:
                self._grad_req[n] = "null"
        self.outputs = []
        self._pending = None    # (outputs, leaves) of a training forward
        self._monitor_callback = None

    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     group2ctx=None):
        """Allocate zero arrays for every argument, gradient and aux state
        from the inferred shapes and dtypes (parity: ``simple_bind``);
        a gradient takes its argument's dtype. With ``group2ctx`` each
        grouped variable's arrays are allocated on its group's Context."""
        from .ndarray import zeros
        ctx = ctx or current_context()
        prog = _GraphProgram(symbol, group2ctx=group2ctx,
                             default_ctx=ctx if group2ctx else None)
        placed = prog.var_contexts()
        (arg_shapes, _, aux_shapes, arg_types, _, aux_types) = \
            infer_graph_attrs(symbol, shape_kwargs, known_types=type_dict)
        arg_names = symbol.list_arguments()
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(arg_names, grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in arg_names}
        arg_arrays = [zeros(s, ctx=placed.get(n, ctx), dtype=t)
                      for n, s, t in zip(arg_names, arg_shapes, arg_types)]
        grad_arrays = [zeros(s, ctx=placed.get(n, ctx), dtype=t)
                       if reqs.get(n, "null") != "null" else None
                       for n, s, t in zip(arg_names, arg_shapes, arg_types)]
        aux_arrays = [zeros(s, ctx=placed.get(n, ctx), dtype=t)
                      for n, s, t in zip(symbol.list_auxiliary_states(),
                                         aux_shapes, aux_types)]
        return Executor(symbol, ctx, arg_arrays, aux_arrays, program=prog,
                        grad_arrays=grad_arrays, grad_req=reqs)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states,
              shared_exec=None, group2ctx=None):
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        program = None
        if shared_exec is not None and shared_exec._symbol is symbol \
                and not group2ctx:
            program = shared_exec._prog

        def _as_list(spec, names, what):
            if spec is None:
                return [None] * len(names)
            if isinstance(spec, dict):
                return [spec.get(n) for n in names]
            if len(spec) != len(names):
                raise MXNetError("%s length mismatch: %d vs %d"
                                 % (what, len(spec), len(names)))
            return list(spec)

        arg_arrays = _as_list(args, arg_names, "args")
        missing = [n for n, a in zip(arg_names, arg_arrays) if a is None]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        aux_arrays = _as_list(aux_states, aux_names, "aux_states")
        missing = [n for n, a in zip(aux_names, aux_arrays) if a is None]
        if missing:
            raise MXNetError("bind: missing aux states %s" % missing)
        grad_arrays = _as_list(args_grad, arg_names, "args_grad")
        if grad_req is None:
            grad_req = "null"
        if isinstance(grad_req, str) and grad_req != "null":
            grad_req = {n: (grad_req if g is not None else "null")
                        for n, g in zip(arg_names, grad_arrays)}
        return Executor(symbol, ctx, arg_arrays, aux_arrays, program=program,
                        grad_arrays=grad_arrays, grad_req=grad_req,
                        group2ctx=group2ctx)

    def _raw_args(self):
        return {n: a._data for n, a in zip(self._arg_names, self.arg_arrays)}

    def _raw_aux(self):
        return {n: a._data for n, a in zip(self._aux_names, self.aux_arrays)}

    def _grad_names(self):
        return tuple(n for n in self._arg_names
                     if self._grad_req[n] != "null")

    def _feed(self, kwargs):
        """Install keyword-fed inputs into bound storage (a ``feed``
        span; numpy feeds count toward the h2d transfer register)."""
        if not kwargs:
            return
        with telemetry.span("feed"):
            for name, value in kwargs.items():
                if name not in self._arg_names:
                    raise MXNetError("forward: unknown input %r" % name)
                if isinstance(value, np.ndarray):
                    telemetry.record_transfer(value.nbytes)
                self.arg_dict[name][:] = value

    def _set_outputs(self, outs):
        from .ndarray.ndarray import NDArray
        self.outputs = [NDArray(o.detach(),
                                self._prog.output_context(i, self._ctx))
                        for i, o in enumerate(outs)]

    def forward(self, is_train=False, **kwargs):
        """Run forward (parity: executor.py forward); kwargs feed inputs.
        In training mode BatchNorm takes batch statistics and its moving
        stats are written back, and the graph is kept for ``backward``."""
        self._feed(kwargs)
        self._pending = None
        self.outputs = []       # the last outputs die before new ones live
        record_dispatch("forward")
        with self._monitored(), telemetry.span("step"):
            if not is_train:
                outs, _ = self._prog.forward_fn()(self._raw_args(),
                                                  self._raw_aux())
            else:
                outs, leaves, aux_up = self._prog.forward_train_fn(
                    self._grad_names())(self._raw_args(), self._raw_aux())
        if is_train:
            self._write_aux(aux_up)
            if leaves:
                self._pending = (outs, leaves)
        self._set_outputs(outs)
        return self.outputs

    def set_monitor_callback(self, callback, monitor_all=False):
        """Feed ``callback(name, NDArray)`` every op output of each
        forward (and of the forward a ``forward_backward`` runs), as
        ``get_internals()`` names them (parity:
        Executor.set_monitor_callback; ``monitor_all`` also feeds the
        arguments and aux states)."""
        self._monitor_callback = callback
        self._monitor_all = bool(monitor_all)

    def _monitored(self):
        """A context in which the program taps its op outputs into the
        monitor callback (nothing without one)."""
        cb = self._monitor_callback
        if cb is None:
            return contextlib.nullcontext()
        from .ndarray.ndarray import NDArray
        prog, ctx = self._prog, self._ctx

        @contextlib.contextmanager
        def tapping():
            prog.tap = lambda name, t: cb(name, NDArray(t, ctx))
            try:
                yield
            finally:
                prog.tap = None
            if self._monitor_all:
                for name, arr in list(self.arg_dict.items()) + \
                        list(self.aux_dict.items()):
                    cb(name, arr)
        return tapping()

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs into the gradient arrays (parity:
        executor.py backward): from the graph of the last
        ``forward(is_train=True)``, else through a forward-backward pass
        that does not touch ``outputs`` (the JAX package's recompute)."""
        hg = self._head_grads(out_grads)
        if self._pending is not None:
            outs, leaves = self._pending
            self._pending = None
            self._write_grads(self._prog._reduced(
                _GraphProgram._grads(outs, leaves, hg)))
            return
        self._run_fwd_bwd(hg, is_train, update_outputs=False)

    def forward_backward(self, out_grads=None, is_train=True, **kwargs):
        """Forward and backward in one pass (the Module path)."""
        self._feed(kwargs)
        self._pending = None
        self.outputs = []
        self._run_fwd_bwd(self._head_grads(out_grads), is_train,
                          update_outputs=True)
        return self.outputs

    def _head_grads(self, out_grads):
        from .ndarray.ndarray import NDArray
        if out_grads is None:
            return None
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        return [g._data if isinstance(g, NDArray) else g for g in out_grads]

    def _run_fwd_bwd(self, head_grads, is_train, update_outputs):
        grad_names = self._grad_names()
        if not grad_names:
            if update_outputs:
                self.forward(is_train=is_train)
            return
        record_dispatch("fwd_bwd")
        with (self._monitored() if update_outputs
              else contextlib.nullcontext()), telemetry.span("step"):
            outs, grads, aux_up = self._prog.fwd_bwd_fn(
                is_train, grad_names)(self._raw_args(), self._raw_aux(),
                                      head_grads)
        self._write_aux(aux_up)
        if update_outputs:
            self._set_outputs(outs)
        self._write_grads(grads)

    def _write_grads(self, grads):
        gdict = self.grad_dict
        with torch.no_grad():
            for n, g in grads.items():
                garr = gdict.get(n)
                if garr is None:
                    continue
                g = g.to(garr._data.dtype)
                if self._grad_req[n] == "add":
                    garr._data.add_(g)
                else:
                    garr._data.copy_(g)

    def _write_aux(self, aux_up):
        d = self.aux_dict
        with torch.no_grad():
            for name, val in aux_up.items():
                if name in d:
                    d[name]._data.copy_(val)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """(parity: executor.py copy_params_from)"""
        for src, dst, what in ((arg_params or {}, self.arg_dict, "argument"),
                               (aux_params or {}, self.aux_dict,
                                "aux state")):
            for name, arr in src.items():
                if name in dst:
                    dst[name][:] = arr
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %r" % (what, name))


class ReplicaSet:
    """Executors of one symbol, one per Context, each bound to its slice
    of the batch, run as one data-parallel program: the counterpart of
    the JAX package's one program sharded over a ``dp`` mesh. A training
    forward evaluates every replica node by node together
    (``_GraphProgram.eval_replicas``), so BatchNorm takes its statistics
    over all their rows (and, with ``over_workers``, over every worker's:
    the fused step over a synchronous ``dist*`` store), and one backward
    runs over the joint graph. One executor alone, and every inference
    forward, runs as an executor does by itself."""

    def __init__(self, execs):
        self.execs = list(execs)
        self._pending = None    # (outputs, leaves) of a joint forward

    @contextlib.contextmanager
    def _tapping(self):
        """Each executor's monitor taps, one per replica."""
        prog = self.execs[0]._prog
        with contextlib.ExitStack() as stack:
            for ex in self.execs:
                stack.enter_context(ex._monitored())
            prog.replica_taps = [ex._prog.tap for ex in self.execs]
            try:
                yield
            finally:
                prog.replica_taps = None

    def _run(self, kind, grad_names, over_workers=False, *head_grads):
        """One call of the replicas' ``kind`` entry point on the bound
        arrays."""
        execs = self.execs
        record_dispatch(kind)
        with self._tapping(), telemetry.span("step"):
            return execs[0]._prog.replicas_fn(
                kind, grad_names, len(execs), over_workers)(
                [ex._raw_args() for ex in execs],
                [ex._raw_aux() for ex in execs], *head_grads)

    def _fresh(self, outs, aux_up):
        """A new step's outputs and moving stats into the executors."""
        for ex, o, a in zip(self.execs, outs, aux_up):
            ex._pending = None
            ex._write_aux(a)
            ex._set_outputs(o)

    def forward(self, is_train=False):
        """Forward of every executor on the inputs installed in it."""
        self._pending = None
        if len(self.execs) == 1 or not is_train:
            for ex in self.execs:
                ex.forward(is_train=is_train)
            return
        self._drop_outputs()
        outs, leaves, aux_up = self._run("forward",
                                         self.execs[0]._grad_names())
        self._fresh(outs, aux_up)
        if leaves[0]:
            self._pending = (outs, leaves)

    def backward(self, out_grads=None):
        """Gradients into every executor's arrays; ``out_grads`` holds one
        list of head gradients per replica (or is None)."""
        if len(self.execs) == 1:
            self.execs[0].backward(
                out_grads=None if out_grads is None else out_grads[0])
            return
        hg = None if out_grads is None else \
            [ex._head_grads(g) for ex, g in zip(self.execs, out_grads)]
        if self._pending is not None:
            outs, leaves = self._pending
            self._pending = None
            for ex, g in zip(self.execs,
                             _GraphProgram._replica_grads(outs, leaves, hg)):
                ex._write_grads(g)
            return
        # no joint forward to differentiate: recompute one, outputs kept
        _, grads, aux_up = self._run("fwd_bwd", self.execs[0]._grad_names(),
                                     False, hg)
        for ex, g, a in zip(self.execs, grads, aux_up):
            ex._write_aux(a)
            ex._write_grads(g)

    def _drop_outputs(self):
        for ex in self.execs:
            ex.outputs = []     # the last outputs die before new ones live

    def forward_backward(self):
        """Forward and backward in one pass (the Module path)."""
        self._pending = None
        if len(self.execs) == 1:
            self.execs[0].forward_backward()
            return
        self._drop_outputs()
        outs, grads, aux_up = self._run("fwd_bwd",
                                        self.execs[0]._grad_names())
        self._fresh(outs, aux_up)
        for ex, g in zip(self.execs, grads):
            ex._write_grads(g)

    def step_grads(self, names, add_names, over_workers=False):
        """The fused step's forward and backward: per replica, the
        gradients of ``names`` in the parameters' dtypes (a ``grad_req=
        'add'`` parameter's accumulator added and written back), with
        the outputs and moving stats written."""
        self._pending = None
        self._drop_outputs()
        outs, grads, aux_up = self._run("train_step", tuple(names),
                                        over_workers)
        self._fresh(outs, aux_up)
        per = []
        with torch.no_grad():
            for ex, g in zip(self.execs, grads):
                gs = []
                for k in names:
                    t = g.pop(k).to(ex.arg_dict[k]._data.dtype)
                    if k in add_names:
                        acc = ex.grad_dict[k]._data
                        t = acc + t
                        acc.copy_(t)
                    gs.append(t)
                per.append(gs)
        return per
