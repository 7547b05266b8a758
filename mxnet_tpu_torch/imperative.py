"""Imperative runtime: eager op invocation and the autograd tape.

Counterpart of ``mxnet_tpu/imperative.py`` (``invoke``, the recording
state, ``mark_variables`` and ``backward``). PyTorch's CUDA ops are
already asynchronous and stream-ordered, so "invoke" is a function call
on the registered op. The tape is ``torch.autograd``'s graph:

* ``mark_variables`` (``attach_grad``, a gluon ``Parameter``) makes an
  NDArray a *leaf*: it gets a gradient buffer and a ``grad_req``. Its
  own tensor never requires grad, so in-place writes to it (optimizer
  updates, ``a[:] = x``) stay legal and an op outside ``record`` builds
  no graph. A recorded op reads the leaf through its *alias*, a detached
  view of the same storage that requires grad, made once per tensor.
* ``invoke`` decides per op: it records when ``is_recording()``, the op
  is differentiable and an input is a leaf or carries the tape (the
  output of a recorded op); it then runs under ``torch.enable_grad()``
  and marks its outputs as carrying the tape. Otherwise it reads tape
  tensors detached and runs under the caller's grad mode, which is what
  ``gluon.block.make_pure_fn`` and the executor's training entry points
  differentiate through.
* ``backward`` takes ``torch.autograd.grad`` over every live leaf alias
  and writes (``grad_req='write'``), adds (``'add'``) or skips
  (``'null'``) into each leaf's gradient buffer. Without
  ``retain_graph`` the graph is freed and the heads leave the tape: a
  second backward raises.
"""
from __future__ import annotations

import weakref

import torch

from .base import MXNetError
from .ops import common as _common

__all__ = ["invoke", "is_recording", "is_training", "set_recording",
           "set_training", "backward", "mark_variables", "get_symbol"]

# id -> leaf (NDArray) that may hold an alias; a backward differentiates
# with respect to every live one (keyed by id: NDArray's == is the
# elementwise op)
_LEAVES = weakref.WeakValueDictionary()


def is_recording():
    return _common.state().recording


def is_training():
    return _common.state().train_mode


def set_recording(flag):
    prev = _common.state().recording
    _common.state().recording = bool(flag)
    return prev


def set_training(flag):
    prev = _common.state().train_mode
    _common.state().train_mode = bool(flag)
    return prev


# ---------------------------------------------------------------------------
# Leaves and tape tensors
# ---------------------------------------------------------------------------

def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers (parity: ``autograd.mark_variables``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("invalid grad_req %r" % (req,))
        var._grad = grad
        var._grad_req = req
        var._tape = False
        var._alias = None
        _LEAVES[id(var)] = var


def on_tape(x):
    """True for a leaf or the output of a recorded op."""
    return x._tape or x._grad_req is not None


def tape_tensor(x):
    """The tensor a recorded op reads for NDArray ``x``: its own for a
    tape output, its alias for a leaf."""
    if x._tape:
        return x._data
    alias = x._alias
    if alias is None or alias[0] is not x._data:
        alias = (x._data, x._data.detach().requires_grad_(True))
        x._alias = alias
    return alias[1]


def plain_tensor(x):
    """The tensor an unrecorded op reads: a tape output detached (it
    must not grow the recorded graph), anything else as it is."""
    return x._data.detach() if x._tape else x._data


def read_inputs(inputs, record):
    """Raw tensors for ``inputs`` (NDArrays or anything else)."""
    from .ndarray.ndarray import NDArray
    out = []
    for x in inputs:
        if not isinstance(x, NDArray):
            out.append(x)
        elif record and on_tape(x):
            out.append(tape_tensor(x))
        else:
            out.append(plain_tensor(x))
    return out


def should_record(nds, no_grad=False):
    return (is_recording() and not no_grad
            and any(x is not None and on_tape(x) for x in nds))


def write_aux(pairs):
    """Write stateful aux updates ``[(NDArray, tensor)]`` (BatchNorm
    moving stats) in place, detached, or hand them to the active
    collector (``make_pure_fn``)."""
    collector = _common.state().aux_collector
    for nd, val in pairs:
        val = val.detach()
        if collector is not None:
            collector.append((nd, val))
        else:
            with torch.no_grad():
                nd._data.copy_(val)


# ---------------------------------------------------------------------------
# Invoke
# ---------------------------------------------------------------------------

class TapeNode:
    """What ``autograd.get_symbol`` needs of one recorded op: the op, its
    params and, per input, where its value came from: ``(TapeNode,
    output index)``, ``(leaf NDArray, 0)``, ``(None, 0)`` for a recorded
    value without this record (a hybridized block's output), or None
    for a constant. The values themselves live in torch's graph."""

    __slots__ = ("op", "params", "parents")

    def __init__(self, op, params, nds):
        self.op = op
        self.params = {k: v for k, v in params.items()
                       if k not in ("_train", "_rng")}
        self.parents = [None if x is None else
                        x._tape if isinstance(x._tape, tuple) else
                        (None, 0) if x._tape else
                        (x, 0) if x._grad_req is not None else None
                        for x in nds]


def invoke(op, inputs, kwargs, out=None):
    """Run one op eagerly on NDArrays (parity: ``imperative.invoke``);
    returns a single NDArray or a list of its visible outputs (or
    ``out``, written).

    Train-mode ops get ``_train=is_training()``, random ops the
    generator of their device (``_rng``, ``ops/common.take_rng``). A
    training-mode call of a stateful op (BatchNorm) updates its aux
    inputs (``write_aux``); an update op (``op.mutate``) writes its
    outputs back into the inputs it names and returns the first."""
    from .ndarray.ndarray import NDArray
    params = dict(op.defaults)
    params.update(kwargs)
    params.pop("name", None)
    if op.nin != 0:
        params.pop("ctx", None)
    if op.takes_train:
        params["_train"] = is_training()
    nds = [x if isinstance(x, NDArray) else None for x in inputs]
    ctx = next((x.context for x in nds if x is not None), None)
    record = should_record(nds, op.no_grad)
    # storage-aware dispatch before any input's dense view is read: a
    # sparse input asks the sparse table first, then takes the logged
    # dense fallback below (a recorded op always runs dense)
    if not record and out is None and any(
            x is not None and x.stype != "default" for x in nds):
        from .ndarray import sparse as _sparse
        res = _sparse.dispatch_ex(op.name, inputs, params)
        if res is not NotImplemented:
            return res
        from .config import storage_fallback_log
        storage_fallback_log("%s(%s)" % (op.name, ", ".join(
            x.stype if x is not None else "default" for x in nds)))
    if op.takes_rng:
        params["_rng"] = _common.take_rng(_rng_device(nds, params))
    raw = read_inputs(inputs, record)
    if record:
        with torch.enable_grad():
            outs = op.apply(raw, params)
    else:
        outs = op.apply(raw, params)
    if op.stateful_update is not None:
        write_aux([(nds[idx], val) for idx, val in
                   op.stateful_update(raw, outs, params).items()
                   if nds[idx] is not None])
    if op.mutate:
        with torch.no_grad():
            for j, idx in enumerate(op.mutate):
                if j < len(outs) and nds[idx] is not None:
                    nds[idx]._data.copy_(outs[j])
        primary = nds[op.mutate[0]]
        if out is not None and out is not primary:
            with torch.no_grad():
                out._data.copy_(outs[0])
            return out
        return primary
    n_visible = min(op.n_visible(params) or len(outs), len(outs))
    node = TapeNode(op, params, nds) if record else None
    results = []
    for i, o in enumerate(outs[:n_visible]):
        nd = NDArray(o, ctx)
        nd._tape = (node, i) if record else False
        results.append(nd)
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, r in zip(targets, results):
            t._assign(r)
        return out
    return results[0] if len(results) == 1 else results


def _rng_device(nds, params):
    """The device a random op draws on: its first NDArray input's, else
    its ``ctx`` (a creation op; default the current context)."""
    from .ops.tensor import creation_device
    for x in nds:
        if x is not None:
            return x._data.device
    return creation_device(params.get("ctx"))


# ---------------------------------------------------------------------------
# Backward over the tape
# ---------------------------------------------------------------------------

def head_grad(y, g):
    from .ndarray.ndarray import NDArray
    if g is None:
        return torch.ones_like(y._data)
    if isinstance(g, NDArray):
        return g._data.to(y._data.dtype)
    return torch.as_tensor(g, dtype=y._data.dtype, device=y._data.device)


def head_pairs(outputs, head_grads):
    if head_grads is None:
        head_grads = [None] * len(outputs)
    if not any(y._tape for y in outputs):
        raise MXNetError("backward: outputs are not in a recorded graph "
                         "(use autograd.record())")
    # a recorded head that needs no grad (BlockGrad) contributes zeros
    return [(y, head_grad(y, g)) for y, g in zip(outputs, head_grads)
            if y._tape and y._data.requires_grad]


def autograd_grad(heads, hgs, wrt, retain_graph, create_graph=False):
    """``torch.autograd.grad`` with torch's "backward through the graph
    a second time" as an MXNetError. No head needing grad: no
    gradient."""
    if not heads:
        return [None] * len(wrt)
    try:
        return torch.autograd.grad(heads, wrt, hgs, retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError("backward: the graph was freed by an earlier "
                             "backward (pass retain_graph=True to run "
                             "backward twice)") from e
        raise


def free_heads(outputs):
    """The heads of a backward without ``retain_graph`` leave the tape."""
    for y in outputs:
        y._tape = False


def backward(outputs, head_grads=None, retain_graph=False, train_mode=True):
    """Reverse mode over the recorded ops (parity:
    ``Imperative::Backward``): the gradients of ``outputs`` (head
    gradients ones where not given) written into the leaves' buffers."""
    pairs = head_pairs(outputs, head_grads)
    leaves = [v for v in list(_LEAVES.values())
              if v._alias is not None and v._grad is not None
              and v._grad_req in ("write", "add")]
    if leaves and pairs:
        grads = autograd_grad([y._data for y, _ in pairs],
                              [g for _, g in pairs],
                              [v._alias[1] for v in leaves],
                              retain_graph=bool(retain_graph))
    else:
        grads = []
    if not retain_graph:
        free_heads(y for y, _ in pairs)
    with torch.no_grad():
        for v, g in zip(leaves, grads):
            if g is None:
                continue
            dst = v._grad._data
            if v._grad_req == "add":
                dst.add_(g.to(dst.dtype))
            else:
                dst.copy_(g)


def get_symbol(x):
    """The Symbol of the recorded ops that computed ``x`` (parity:
    mxnet_tpu/imperative.py:338-380, autograd.get_symbol): a leaf becomes
    ``var<i>``, a constant input ``const<i>``, an op ``<op name><i>``,
    numbered in the order a depth-first walk from ``x`` meets them, as
    the JAX package names them."""
    from .ndarray.ndarray import NDArray
    from .symbol.symbol import Symbol, _SymNode
    if not isinstance(x, NDArray) or not isinstance(x._tape, tuple):
        raise MXNetError("get_symbol: array is not part of a recorded "
                         "graph (use autograd.record())")
    cache, counters = {}, {}

    def name_for(base):
        i = counters.get(base, 0)
        counters[base] = i + 1
        return "%s%d" % (base, i)

    def conv(node):
        got = cache.get(id(node))
        if got is not None:
            return got
        if isinstance(node, NDArray):
            sn = _SymNode(None, name_for("var"), {}, [])
        elif node is None:
            raise MXNetError("get_symbol: a recorded value has no symbol "
                             "information (a hybridized block's output)")
        else:
            inputs = [(_SymNode(None, name_for("const"), {}, []), 0)
                      if p is None else (conv(p[0]), p[1])
                      for p in node.parents]
            sn = _SymNode(node.op, name_for(node.op.name.lower()),
                          node.params, inputs)
        cache[id(node)] = sn
        return sn

    node, i = x._tape
    return Symbol([(conv(node), i)])
