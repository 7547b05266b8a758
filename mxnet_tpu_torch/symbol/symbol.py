"""Symbol — declarative graph construction.

Counterpart of ``mxnet_tpu/symbol/symbol.py``: a Symbol is a light
Python DAG of op nodes, serialized in the reference's JSON node-list
format (``nodes``/``arg_nodes``/``heads``), so the port loads graphs the
JAX package exported and writes graphs it loads. Binding evaluates the
graph op by op (see ``executor.py``).
"""
from __future__ import annotations

import ast
import json

import numpy as np

from ..base import MXNetError
from ..name import NameManager
from ..attribute import AttrScope
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _SymNode:
    """One graph node: an op application or a variable (op=None)."""

    __slots__ = ("op", "name", "attrs", "inputs", "_extra_attrs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op
        self.name = name
        self.attrs = dict(attrs)        # op params (strings/values)
        self.inputs = list(inputs)      # list of (node, out_index)
        self._extra_attrs = {}          # user attrs (__shape__, lr_mult…)

    def num_outputs(self):
        if self.op is None:
            return 1
        if self.op.nout == -1:          # SliceChannel: from its params
            return int(self.attrs.get("num_outputs", 1))
        params = dict(self.op.defaults)
        params.update(self.attrs)
        return self.op.n_visible(params) or self.op.nout


class Symbol:
    """An immutable handle on a list of node outputs."""

    def __init__(self, outputs):
        self._outputs = list(outputs)

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(n.name for n, _ in self._outputs)

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %r not found in %s"
                                 % (index, names))
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    # -- graph traversal ---------------------------------------------------
    def _topo_nodes(self):
        """All nodes in topological order (iterative post-order)."""
        order, seen = [], set()
        visit = [(n, False) for n, _ in reversed(self._outputs)]
        while visit:
            node, done = visit.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            visit.append((node, True))
            for child, _ in reversed(node.inputs):
                if id(child) not in seen:
                    visit.append((child, False))
        return order

    def _aux_var_ids(self):
        """Variables used only in aux positions (BatchNorm moving stats)."""
        aux, non_aux = set(), set()
        for node in self._topo_nodes():
            if node.op is None:
                continue
            aux_idx = set(node.op.aux_inputs)
            for i, (child, _) in enumerate(node.inputs):
                if child.op is None:
                    (aux if i in aux_idx else non_aux).add(id(child))
        return aux - non_aux

    def list_arguments(self):
        aux_ids = self._aux_var_ids()
        return [n.name for n in self._topo_nodes()
                if n.op is None and id(n) not in aux_ids]

    def list_auxiliary_states(self):
        aux_ids = self._aux_var_ids()
        return [n.name for n in self._topo_nodes()
                if n.op is None and id(n) in aux_ids]

    def list_outputs(self):
        outs = []
        for node, idx in self._outputs:
            if node.op is None:
                outs.append(node.name)
            elif node.num_outputs() == 1:
                outs.append(node.name + "_output")
            else:
                outs.append("%s_output%d" % (node.name, idx))
        return outs

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    def get_internals(self):
        """Every node's outputs in topological order, so that
        ``get_internals()["flatten_output"]`` picks one by name (parity:
        Symbol.get_internals)."""
        return Symbol([(node, i) for node in self._topo_nodes()
                       for i in range(node.num_outputs())])

    def get_children(self):
        """The inputs of this symbol's outputs, or None for a variable
        (parity: Symbol.get_children)."""
        inputs = [inp for node, _ in self._outputs for inp in node.inputs]
        return Symbol(inputs) if inputs else None

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        """One user attribute of the (first) output's node, or None."""
        return self._outputs[0][0]._extra_attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0]._extra_attrs.update(kwargs)

    def list_attr(self, recursive=False):
        """The user attributes of this node (parity: Symbol.list_attr;
        ``attr_dict`` gives every node's)."""
        if recursive:
            raise MXNetError("list_attr(recursive=True) was removed in the "
                             "reference too; use attr_dict() instead")
        return {k: str(v) for k, v in self._outputs[0][0]._extra_attrs.items()}

    def list_inputs(self):
        """Arguments, then auxiliary states (parity: Symbol.list_inputs)."""
        return self.list_arguments() + self.list_auxiliary_states()

    def debug_str(self):
        """The graph node by node, in the JAX package's text form."""
        lines = []
        for node in self._topo_nodes():
            if node.op is None:
                lines.append("Variable:%s" % node.name)
            else:
                ins = ", ".join(n.name for n, _ in node.inputs)
                attrs = "".join(", %s=%r" % kv
                                for kv in sorted(node.attrs.items()))
                lines.append("Op:%s, Name=%s\n  Inputs: %s%s"
                             % (node.op.name, node.name, ins, attrs))
        return "\n".join(lines) + "\n"

    def gradient(self, wrt):
        """(parity: Symbol.gradient) not implemented upstream either."""
        raise MXNetError("symbol.gradient is not implemented (the "
                         "reference raises too); use executor backward "
                         "or autograd")

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes (None where
        unknown; torch's bfloat16 as itself, numpy has none), from the
        given input types and the variables' ``__dtype__`` (parity:
        Symbol.infer_type)."""
        from ..executor import infer_graph_attrs
        known = {}
        for name, dt in zip(self.list_arguments(), args):
            if dt is not None:
                known[name] = dt
        known.update({k: v for k, v in kwargs.items() if v is not None})
        res = infer_graph_attrs(self, {}, known_types=known, partial=True)
        return tuple([_np_dtype(t) for t in ts] for ts in res[3:])

    def eval(self, ctx=None, **kwargs):
        """Bind the given arrays and run forward (parity: Symbol.eval)."""
        return self.bind(ctx=ctx, args=kwargs).forward()

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes); raises when a shape
        cannot be inferred."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As ``infer_shape``, with None for what cannot be inferred."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        from ..executor import infer_graph_shapes
        known = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        return infer_graph_shapes(self, known, partial=partial)

    # -- serialization -----------------------------------------------------
    def tojson(self):
        """Reference-compatible JSON node list (parity: nnvm SaveJSON)."""
        nodes = self._topo_nodes()
        node_id = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.op is None else n.op.name,
                "name": n.name,
                "inputs": [[node_id[id(c)], idx, 0] for c, idx in n.inputs],
            }
            attrs = {k: str(v) for k, v in n.attrs.items()}
            attrs.update(n._extra_attrs)
            if attrs:
                entry["attrs"] = attrs
            out_nodes.append(entry)
        graph = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op is None],
            "node_row_ptr": list(range(len(nodes) + 1)),
            "heads": [[node_id[id(n)], idx, 0] for n, idx in self._outputs],
            "attrs": {"mxnet_version": ["int", 1200]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding -----------------------------------------------------------
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="null",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind given arrays (and gradient arrays, where ``grad_req`` is
        not null) to an Executor. With ``group2ctx`` (``{group:
        Context}``) each grouped array must already live on its group's
        Context."""
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states, shared_exec=shared_exec,
                              group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **shapes):
        """Bind freshly allocated zero arrays of the inferred shapes and
        dtypes (parity: ``Symbol.simple_bind``); ``grad_req`` is one
        string or a per-argument dict/list. ``group2ctx`` (``{group:
        Context}``) places the nodes of each ``ctx_group`` on its
        Context."""
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict or {},
                                     {k: tuple(v) for k, v in shapes.items()},
                                     group2ctx=group2ctx)

    def attr_dict(self):
        """{node name: its user attributes} for every node that has some
        (parity: ``Symbol.attr_dict``; ``__lr_mult__``, ``__shape__``...)."""
        return {n.name: dict(n._extra_attrs) for n in self._topo_nodes()
                if n._extra_attrs}

    # -- operators (parity: the reference Symbol's) -------------------------
    def _binary(self, other, op_name, scalar_op):
        if isinstance(other, Symbol):
            return _create(op_name, [self, other], {})
        if isinstance(other, (int, float)):
            return _create(scalar_op, [self], {"scalar": other})
        raise TypeError("unsupported operand %r" % (other,))

    def _rscalar(self, other, scalar_op):
        if isinstance(other, (int, float)):
            return _create(scalar_op, [self], {"scalar": other})
        raise TypeError("unsupported operand %r" % (other,))

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._rscalar(other, "_rminus_scalar")

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._rscalar(other, "_rdiv_scalar")

    __div__ = __truediv__

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _create("negative", [self], {})

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    # convenience mirrors of NDArray methods
    def reshape(self, shape, **kw):
        return _create("Reshape", [self], {"shape": shape, **kw})

    def sum(self, **kw):
        return _create("sum", [self], kw)

    def mean(self, **kw):
        return _create("mean", [self], kw)

    def flatten(self):
        return _create("Flatten", [self], {})

    def transpose(self, axes=()):
        return _create("transpose", [self], {"axes": axes})

    def slice_axis(self, axis, begin, end):
        return _create("slice_axis", [self], {"axis": axis, "begin": begin,
                                              "end": end})

    def astype(self, dtype):
        return _create("Cast", [self], {"dtype": dtype})


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """Create a symbolic variable (parity: mx.sym.Variable): ``lr_mult``,
    ``wd_mult`` and ``init`` (a name or an Initializer) become the
    ``__lr_mult__``/``__wd_mult__``/``__init__`` attributes, ``dtype`` the
    numpy name in ``__dtype__``."""
    node = _SymNode(None, name, {}, [])
    extra = dict(AttrScope.current.get(attr))
    if shape is not None:
        extra["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        extra["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        extra["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        extra["__dtype__"] = _dtype_name(dtype)
    if init is not None:
        extra["__init__"] = init if isinstance(init, str) else init.dumps()
    node._extra_attrs = extra
    return Symbol([(node, 0)])


var = Variable


def _dtype_name(dtype):
    """The numpy name of a dtype (``'float32'``; ``'bfloat16'`` too)."""
    import torch
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _np_dtype(t):
    if t is None:
        return None
    name = str(t).replace("torch.", "")
    return t if name == "bfloat16" else np.dtype(name)


def _not_for_symbol(name):
    def method(self, *args, **kwargs):
        raise MXNetError("operation %s is not supported for Symbol "
                         "(parity: symbol.py NotImplementedForSymbol)"
                         % name)
    method.__name__ = name
    return method


for _name in ["wait_to_read", "asnumpy", "asscalar", "copy",
              "as_in_context", "detach", "backward"]:
    setattr(Symbol, _name, _not_for_symbol(_name))
del _name


def Group(symbols):
    """Group symbols into one multi-output symbol (parity: mx.sym.Group)."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def _create(op_name, input_syms, kwargs, name=None):
    """Create an op node (used by the generated sym.* functions)."""
    op = _registry.get_op(op_name)
    kwargs = dict(kwargs)
    name = name or kwargs.pop("name", None)
    attr = AttrScope.current.get(kwargs.pop("attr", None))
    kwargs.pop("out", None)
    inputs = []
    for s in input_syms:
        if len(s._outputs) != 1:
            if op.nin == -1:
                inputs.extend(s._outputs)
                continue
            raise MXNetError("op %s expects single-output inputs" % op_name)
        inputs.append(s._outputs[0])
    name = NameManager.current.get(name, op.name.lower().lstrip("_"))
    # auto-create variables for missing learnable inputs (e.g. weight/bias
    # when calling sym.Convolution(data, kernel=..) without weight=)
    if op.nin not in (-1, 0) and len(inputs) < op.nin:
        no_bias = kwargs.get("no_bias", op.defaults.get("no_bias", False))
        for ai in range(len(inputs), op.nin):
            arg_name = op.arg_names[ai]
            if no_bias and arg_name == "bias":
                continue
            if op.name == "RNN" and arg_name == "state_cell" and \
                    kwargs.get("mode", "lstm") != "lstm":
                continue        # upstream lists state_cell for LSTM only
            if op.name == "LeakyReLU" and kwargs.get(
                    "act_type", op.defaults.get("act_type")) != "prelu":
                continue        # only prelu learns its slopes
            if op.name in ("SequenceLast", "SequenceMask",
                           "SequenceReverse") \
                    and not kwargs.get("use_sequence_length", False):
                continue
            inputs.append(Variable("%s_%s" % (name, arg_name))._outputs[0])
    node = _SymNode(op, name, kwargs, inputs)
    if attr:
        node._extra_attrs.update(attr)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def load_json(json_str):
    """Load a symbol from reference-format JSON (modern ``attrs``,
    0.9-era ``attr`` or pre-0.9 ``param``). Attributes an op does not
    take migrate to ``__k__`` extra attrs, as the reference's legacy
    upgrade pass does."""
    graph = json.loads(json_str)
    nodes = []
    for entry in graph["nodes"]:
        attrs = entry.get("attrs") or entry.get("attr") or \
            entry.get("param") or {}
        extra = {k: v for k, v in attrs.items() if k.startswith("__")}
        params = {k: _parse_attr(v) for k, v in attrs.items()
                  if not k.startswith("__")}
        if entry["op"] == "null":
            node = _SymNode(None, entry["name"], {}, [])
            extra.update({"__%s__" % k: str(v) for k, v in params.items()})
        else:
            op = _registry.get_op(entry["op"])
            accepted = op.accepted_params()
            unknown = [] if accepted is None else \
                [k for k in params if k not in accepted]
            for k in unknown:
                extra["__%s__" % k] = str(params.pop(k))
            inputs = [(nodes[i], idx) for i, idx, *_ in entry["inputs"]]
            node = _SymNode(op, entry["name"], params, inputs)
        node._extra_attrs = extra
        nodes.append(node)
    heads = graph.get("heads", [[len(nodes) - 1, 0, 0]])
    return Symbol([(nodes[i], idx) for i, idx, *_ in heads])


def _parse_attr(v):
    if not isinstance(v, str):
        return v
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load(fname):
    with open(fname, "r") as f:
        return load_json(f.read())
