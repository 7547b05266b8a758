"""Gluon Blocks.

Counterpart of ``mxnet_tpu/gluon/block.py`` (Block, HybridBlock,
export). A Block is a ``torch.nn.Module`` whose children register as
submodules; its parameters are Gluon ``Parameter``s named by the block
prefixes (``resnetv10_stage1_conv0_weight``, ...) exactly as in the
JAX package. ``HybridBlock`` runs ``hybrid_forward`` eagerly with
``F = ndarray``; called on a Symbol it captures the graph with
``F = symbol``, which is what ``export`` writes and what ``hybridize``
traces: a hybridized block runs through a ``_CachedOp``, one symbol per
(input shapes, dtypes, train) evaluated by the executor's
``_GraphProgram``; ``SymbolBlock`` runs a given Symbol the same way.
``make_pure_fn`` turns an initialised block into a
pure function of its parameter tensors for ``torch.autograd`` (the raw
training step of ``bench.py``).
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import imperative as _imp
from ..base import MXNetError
from ..name import NameManager
from ..ops import common as _common
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "make_pure_fn"]


class _BlockScope:
    """Name scoping (parity: block._BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current.get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block(torch.nn.Module):
    """(parity: gluon.Block)"""

    def __init__(self, prefix=None, params=None):
        torch.nn.Module.__init__(self)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  (%s): %s" % (key, _indent(repr(block), 2))
                           for key, block in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            if "_children" in self.__dict__:
                self._children[name] = value
        elif isinstance(value, Parameter):
            if "_reg_params" in self.__dict__:
                self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """(parity: Block.collect_params) this block's and its children's
        parameters; ``select`` is a regular expression the names must
        match (from their start)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self._children[name] = block
        self.add_module(name, block)

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """Initialise every parameter (deferred ones at their first
        forward). ``init`` is the default initializer (Uniform(0.07))."""
        self.collect_params().initialize(init, ctx=ctx,
                                         force_reinit=force_reinit)

    def save_params(self, filename):
        """Write the parameters, names without this block's prefix, in
        ``nd.save``'s format (either package loads them)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    save_parameters = save_params

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, restore_prefix=self.prefix)

    load_parameters = load_params

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def apply(self, fn):
        """``fn`` on every child (recursively), then on this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """(parity: gluon.HybridBlock)"""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Run this block through a ``_CachedOp`` from its next call (and
        its children, when called on their own)."""
        self._active = active
        self._cached_op = None
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def export(self, path):
        """Write ``path-symbol.json`` + ``path-0000.params`` (arg:/aux:
        prefixed) in the checkpoint format. The graph is captured by
        running the block on a Symbol input; parameters must be
        initialised (run one forward first)."""
        from .. import symbol as sym_mod
        from ..ndarray import save as nd_save
        out = self(sym_mod.Variable("data"))
        if isinstance(out, (list, tuple)):
            out = sym_mod.Group(list(out))
        out.save("%s-symbol.json" % path)
        aux_names = set(out.list_auxiliary_states())
        blob = {}
        for name, param in self.collect_params().items():
            prefix = "aux:" if name in aux_names else "arg:"
            blob[prefix + name] = param.data()
        nd_save("%s-0000.params" % path, blob)

    def __call__(self, *args):
        from ..symbol import Symbol
        if args and isinstance(args[0], Symbol):
            return self._forward_symbol(*args)
        if self._active:
            if self._cached_op is None:
                self._cached_op = _CachedOp(self)
            return self._cached_op(*args)
        return self._forward_eager(*args)

    def _forward_symbol(self, x, *args):
        from .. import symbol as F
        params = {name: F.Variable(p.name)
                  for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def _forward_eager(self, x, *args):
        params = {}
        try:
            for name, p in self._reg_params.items():
                params[name] = p.data()
        except DeferredInitializationError:
            self._infer_param_shapes(x, *args)
            for name, p in self._reg_params.items():
                params[name] = p.data()
        from .. import ndarray as F
        return self.hybrid_forward(F, x, *args, **params)

    def _infer_param_shapes(self, *args):
        self._shape_hook(*args)
        for p in self._reg_params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def _shape_hook(self, *args):
        raise DeferredInitializationError(
            "Block %r has deferred parameters and no shape hook; specify "
            "in_units/in_channels" % self.name)

    def forward(self, x, *args):
        return self.__call__(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def make_pure_fn(block, train=False):
    """A pure function of an initialised HybridBlock's parameters
    (parity: ``gluon.block.make_pure_fn``).

    Returns ``(fn, raw_params, names)``: ``fn(raw_params, raw_inputs,
    rng=None) -> (outputs, aux_updates)`` runs the block eagerly on the
    given parameter tensors (in ``collect_params`` order) and input
    tensors, in train mode when ``train``, under the caller's
    ``torch`` grad mode, so ``torch.autograd`` differentiates it.
    ``aux_updates`` maps a parameter's index to its new value (BatchNorm
    moving stats of a training call), detached; the block's own
    parameters are left as they were. ``rng`` is the ``torch.Generator``
    every random op of the call draws from (Dropout, the RNN op's
    inter-layer dropout); None: the global generator of the device.

    The JAX function keys its aux map by the raw array's id and so
    returns it empty; this one keys by the parameter's NDArray.
    """
    params = list(block.collect_params().values())
    names = [p.name for p in params]

    def fn(raw_params, raw_inputs, rng=None):
        from ..ndarray.ndarray import NDArray
        nds = [p.data() for p in params]
        idx = {id(nd): i for i, nd in enumerate(nds)}
        originals = [nd._data for nd in nds]
        collector = []
        st = _common.state()
        old = st.aux_collector
        try:
            st.aux_collector = collector
            with autograd.pause(train_mode=train), _common.rng_scope(rng):
                for nd, r in zip(nds, raw_params):
                    nd._data = r
                out = block._forward_eager(*[NDArray(r)
                                             for r in raw_inputs])
        finally:
            st.aux_collector = old
            for nd, orig in zip(nds, originals):
                nd._data = orig
        outs = out if isinstance(out, (list, tuple)) else [out]
        aux = {idx[id(t)]: v for t, v in collector if id(t) in idx}
        return tuple(o._data for o in outs), aux

    return fn, [p.data()._data for p in params], names


class _CachedOp:
    """A hybridized block's executor (parity: the JAX package's
    ``_CachedOp``, upstream ``CachedOp``): ``hybrid_forward`` traced once
    per (input shapes, dtypes, train) into a symbol, run by
    ``executor._GraphProgram`` on the parameters' tensors. Under
    ``autograd.record`` the graph evaluation is recorded like one op (its
    operators build ``torch.autograd``'s graph from the parameters'
    aliases); in training mode the BatchNorm moving stats the program
    returns are written back. Random ops draw from the global generator
    of the device in the graph's order, which is the eager order. A
    block with deferred shapes runs eagerly once first, as in the JAX
    package. No CUDA graph is captured here."""

    def __init__(self, block):
        self.block = block
        self._cache = {}

    def _params(self, inputs):
        params = list(self.block.collect_params().values())
        try:
            for p in params:
                p.data()
        except DeferredInitializationError:
            with autograd.pause():
                self.block._forward_eager(*inputs)
        return params

    def _build(self, n_inputs):
        from .. import symbol as sym
        from ..executor import _GraphProgram
        names = ["data"] if n_inputs == 1 else \
            ["data%d" % i for i in range(n_inputs)]
        out = self.block._forward_symbol(*[sym.Variable(n) for n in names])
        single = not isinstance(out, (list, tuple))
        if not single:
            out = sym.Group(list(out))
        return _GraphProgram(out), names, single

    def __call__(self, *inputs):
        from ..ndarray.ndarray import NDArray
        params = self._params(inputs)
        train = autograd.is_training()
        key = (tuple((x.shape, x._data.dtype) for x in inputs), train)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = self._build(len(inputs))
        prog, names, single = entry
        by_name = dict(zip(names, inputs))
        by_name.update((p.name, p.data()) for p in params)
        results = _run_program(prog, by_name, train, self.block.name)
        return results[0] if single else results


def _run_program(prog, by_name, train, owner):
    """Evaluate ``prog`` on the NDArrays ``by_name`` (its arguments and
    aux states), recorded like one op under ``autograd.record``; the
    moving stats of a training call are written back. Returns the
    outputs as NDArrays on the first argument's context."""
    from ..ndarray.ndarray import NDArray
    missing = [n for n in prog.arg_names + prog.aux_names
               if n not in by_name]
    if missing:
        raise MXNetError("%s has no value for %s" % (owner, missing))
    record = _imp.should_record(list(by_name.values()))
    raw = dict(zip(by_name, _imp.read_inputs(list(by_name.values()),
                                             record)))
    args = {n: raw[n] for n in prog.arg_names}
    aux = {n: raw[n] for n in prog.aux_names}
    if record:
        with torch.enable_grad():
            outs, aux_up = prog.eval_graph(args, aux, train)
    else:
        outs, aux_up = prog.eval_graph(args, aux, train)
    _imp.write_aux([(by_name[n], v) for n, v in aux_up.items()])
    ctx = next(iter(by_name.values())).context if by_name else None
    results = []
    for o in outs:
        nd = NDArray(o, ctx)
        nd._tape = record
        results.append(nd)
    return results


class SymbolBlock(HybridBlock):
    """A Symbol as a Block (parity: mxnet_tpu/gluon/block.py:499-554,
    gluon.SymbolBlock), to run a Module-trained graph in Gluon code: each
    argument that is not an input becomes a parameter named as in the
    symbol (prefix ""), an aux state one without gradient. Parameter
    shapes defer to the first call, inferred from the inputs'
    (``infer_shape_partial``). Hybridized or not, a call evaluates the
    stored graph through ``executor._GraphProgram``, recorded under
    ``autograd.record``."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from ..symbol import Symbol, Group
        from ..executor import _GraphProgram
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._out_symbol = outputs
        self._in_names = [i.name if isinstance(i, Symbol) else i
                          for i in inputs]
        aux_names = set(outputs.list_auxiliary_states())
        for name in outputs.list_arguments() + sorted(aux_names):
            if name not in self._in_names:
                self._params.get(name, allow_deferred_init=True,
                                 grad_req="null" if name in aux_names
                                 else "write")
        self._prog = _GraphProgram(outputs)
        self._single = len(outputs.list_outputs()) == 1

    def __call__(self, *args):
        from ..symbol import Symbol
        if args and isinstance(args[0], Symbol):
            raise MXNetError("SymbolBlock: call it on NDArrays; its graph "
                             "is the stored symbol")
        if len(args) != len(self._in_names):
            raise MXNetError("SymbolBlock takes %d inputs (%s), got %d"
                             % (len(self._in_names), self._in_names,
                                len(args)))
        params = self._params._params
        if any(p.shape is None or 0 in p.shape or p._deferred_init
               is not None for p in params.values()):
            self._infer_shapes(args)
        by_name = dict(zip(self._in_names, args))
        by_name.update((n, p.data()) for n, p in params.items())
        results = _run_program(self._prog, by_name, autograd.is_training(),
                               "SymbolBlock")
        return results[0] if self._single else results

    def _infer_shapes(self, args):
        """Parameter shapes from the inputs' (deferred initialisation)."""
        sym = self._out_symbol
        arg_shapes, _, aux_shapes = sym.infer_shape_partial(
            **{n: a.shape for n, a in zip(self._in_names, args)})
        params = self._params._params
        for names, shapes in ((sym.list_arguments(), arg_shapes),
                              (sym.list_auxiliary_states(), aux_shapes)):
            for n, shape in zip(names, shapes):
                p = params.get(n)
                if p is not None and shape is not None:
                    p._update_shape(shape)

    def hybrid_forward(self, F, *args, **kwargs):
        raise MXNetError("SymbolBlock uses its stored symbol")


def _indent(s, num_spaces):
    lines = s.split("\n")
    if len(lines) == 1:
        return s
    first = lines.pop(0)
    return first + "\n" + "\n".join(" " * num_spaces + line
                                      for line in lines)
