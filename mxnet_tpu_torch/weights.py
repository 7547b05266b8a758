"""Carrying weights across from the JAX package.

Parameter names and logical layouts are identical in both packages (an
NHWC conv weight is OHWI in both), so carrying a model across is a
checked copy:

* :func:`params_from_numpy` turns a blob of numpy arrays — the
  ``arg:``/``aux:`` dict of an exported ``.params`` file, or
  ``{name: p.data().asnumpy()}`` of a Gluon block — into the port's
  ``arg:``/``aux:`` dict of NDArrays, ready for ``Predictor`` and
  ``InferenceEngine``;
* :func:`load_into_block` sets the same blob, or a JAX Gluon net's
  ``collect_params()``, on a port Gluon block by parameter name (a
  ``SymbolBlock``'s parameters take the symbol's argument names, so a
  Module's ``arg_params``/``aux_params`` fill it);
* :func:`tree_from_numpy` copies a plain ``{name: array}`` dict (the
  parameters of a pure ``apply_fn``, as ``parallel.SPMDTrainer`` takes
  them) onto a device as tensors;
* :func:`load_into_module` sets a JAX ``Module``'s ``arg_params`` /
  ``aux_params`` and optimizer states (as numpy: the unpickled
  ``Updater.get_states()``) on a bound port ``Module``, and
  :func:`module_to_numpy` reads the port's back out in the same form;
  both take a ``BucketingModule`` too (its current bucket's module and
  the updater every bucket shares) and a ``SequentialModule`` (stage by
  stage, optimizer states as one entry per stage). Optimizer states of
  every optimizer load as the JAX package pickles them (RMSProp centered
  has three per parameter, Ftrl and AdaDelta a pair, DCASGD its momentum
  or None beside the previous weight). (A ``gluon.Trainer``'s
  ``save_states`` file loads in either package's ``load_states`` as it
  is.) A Gluon RNN layer's per-layer parameters carry by name like any
  block's, and so do the convolutional cells' of ``gluon.contrib.rnn``
  (``i2h_weight``/``h2h_weight``/``i2h_bias``/``h2h_bias``, OI+spatial,
  or O+spatial+I under a channels-last ``conv_layout``), a ``Module`` of
  ``mx.rnn``'s conv cells (the same four names under the cell's prefix)
  and a tied word LM (one ``embedding0_weight`` for the embedding and the
  decoder, as the JAX model has);
* :func:`fused_rnn_from_numpy` gives a ``rnn.FusedRNNCell``'s packed
  ``parameters`` vector from the JAX cell's packed vector or from its
  ``unpack_weights`` arrays, checked against the cell's layout.

:func:`params_from_numpy` and :func:`tree_from_numpy` also take a sparse
value: a JAX ``RowSparseNDArray``/``CSRNDArray`` (read through its
``data``, ``indices``, ``indptr`` and ``shape``), or the pair
``((data, indices), shape)`` / ``((data, indices, indptr), shape)`` of
numpy arrays; it becomes the port's ``RowSparseNDArray``/``CSRNDArray``
on the given Context (:func:`sparse_from_numpy`).

They raise ``MXNetError`` on a missing or extra name, a shape mismatch,
or a value that is not an array.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import cpu, current_context
from .ndarray.ndarray import NDArray, array
from .ops.common import torch_dtype

__all__ = ["params_from_numpy", "load_into_block", "tree_from_numpy",
           "load_into_module", "module_to_numpy", "fused_rnn_from_numpy",
           "sparse_from_numpy"]

_AUX_SUFFIXES = ("running_mean", "running_var", "moving_mean", "moving_var")


def _split(blob):
    """{name: array} with arg:/aux: prefixes resolved; unprefixed names
    are auxiliary when they are BN running statistics."""
    out = {}
    for k, v in blob.items():
        if k.startswith(("arg:", "aux:")):
            kind, name = k[:3], k[4:]
        else:
            kind, name = ("aux" if k.endswith(_AUX_SUFFIXES) else "arg"), k
        if name in out:
            raise MXNetError("weights: %r appears twice in the blob" % name)
        out[name] = (kind, v if _sparse_parts(v) else np.asarray(v))
    return out


def _sparse_parts(v):
    """``(arrays, shape)`` of a sparse value (see the module docstring),
    else None."""
    stype = getattr(v, "stype", None)
    if stype in ("row_sparse", "csr"):
        names = ("data", "indices") + (("indptr",) if stype == "csr"
                                       else ())
        return tuple(_np(getattr(v, n)) for n in names), tuple(v.shape)
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], tuple) \
            and len(v[0]) in (2, 3):
        return tuple(np.asarray(a) for a in v[0]), tuple(v[1])
    return None


def sparse_from_numpy(value, ctx=None, dtype=None):
    """The port's ``RowSparseNDArray`` (from ``(data, indices)``) or
    ``CSRNDArray`` (from ``(data, indices, indptr)``) on ``ctx`` (default:
    the current context, ``gpu(0)``) from a sparse value of the JAX
    package or its numpy arrays (module docstring)."""
    from .ndarray import sparse as _sp
    parts = _sparse_parts(value)
    if parts is None:
        raise MXNetError("weights: %s is not a sparse value"
                         % type(value).__name__)
    arrays, shape = parts
    if len(arrays) == 2:
        return _sp.row_sparse_array(arrays, shape=shape, ctx=ctx,
                                    dtype=dtype)
    return _sp.csr_matrix(arrays, shape=shape, ctx=ctx, dtype=dtype)


def _shape_of(a):
    parts = _sparse_parts(a)
    return parts[1] if parts else tuple(a.shape)


def _check_names(have, want, what):
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise MXNetError("weights: %s — missing %s, extra %s"
                         % (what, missing, extra))


def params_from_numpy(blob, ctx=None, dtype=None, symbol=None,
                      input_shapes=None):
    """The port's ``arg:``/``aux:`` NDArray dict from numpy arrays.

    ctx : Context (default: the current one, ``gpu(0)``)
    dtype : optional cast for every array
    symbol : optional Symbol to hold the names against (every argument
        that is not an input or a ``*_label``, every auxiliary state)
    input_shapes : optional {input: shape}; with ``symbol``, every
        parameter's shape is held against the inferred one
    """
    items = _split(blob)
    if symbol is not None:
        inputs = set(input_shapes or ("data",))
        want_arg = [n for n in symbol.list_arguments()
                    if n not in inputs and not n.endswith("_label")]
        want_aux = symbol.list_auxiliary_states()
        _check_names([n for n, (k, _) in items.items() if k == "arg"],
                     want_arg, "arguments")
        _check_names([n for n, (k, _) in items.items() if k == "aux"],
                     want_aux, "auxiliary states")
        if input_shapes:
            arg_s, _, aux_s = symbol.infer_shape_partial(**input_shapes)
            shapes = dict(zip(symbol.list_arguments(), arg_s))
            shapes.update(zip(want_aux, aux_s))
            for n, (_, a) in items.items():
                if shapes.get(n) is not None and _shape_of(a) != shapes[n]:
                    raise MXNetError("weights: %r has shape %s, the graph "
                                     "needs %s" % (n, _shape_of(a),
                                                   shapes[n]))
    return {"%s:%s" % (k, n): sparse_from_numpy(a, ctx=ctx, dtype=dtype)
            if _sparse_parts(a) else array(a, ctx=ctx, dtype=dtype)
            for n, (k, a) in items.items()}


def load_into_block(block, blob, ctx=None):
    """Set every parameter of a port Gluon ``block`` from ``blob`` (same
    forms as :func:`params_from_numpy`, or the ``collect_params()`` of a
    Gluon net of either package), by full parameter name."""
    if not isinstance(blob, dict):
        blob = {k: _np(p.data()) for k, p in blob.items()}
    items = _split(blob)
    params = block.collect_params()
    _check_names(list(items), list(params.keys()), "block parameters")
    for name, p in params.items():
        a = items[name][1]
        if p.shape is not None and (len(p.shape) != a.ndim or any(
                s and s != t for s, t in zip(p.shape, a.shape))):
            raise MXNetError("weights: %r has shape %s, the block needs %s"
                             % (name, a.shape, p.shape))
        p.set_data(array(a, ctx=ctx))


def tree_from_numpy(params, ctx=None, dtype=None):
    """``{name: tensor}`` on ``ctx`` (default: the current context,
    ``gpu(0)``) from a plain dict of numpy arrays, tensors or NDArrays;
    always a copy. float64 becomes float32 (MXNet convention) unless
    ``dtype`` casts every array. A sparse value becomes the port's
    sparse NDArray (:func:`sparse_from_numpy`)."""
    if not isinstance(params, dict):
        raise MXNetError("tree_from_numpy: expected a dict of arrays, got %s"
                         % type(params).__name__)
    dev = (ctx or current_context()).torch_device()
    dt = torch_dtype(dtype)
    out = {}
    for name, a in params.items():
        if _sparse_parts(a):
            out[name] = sparse_from_numpy(a, ctx=ctx, dtype=dtype)
            continue
        if isinstance(a, NDArray):
            t = a._data
        elif isinstance(a, torch.Tensor):
            t = a
        elif isinstance(a, np.ndarray) and a.dtype.kind in "biuf":
            t = torch.from_numpy(np.ascontiguousarray(a))
        else:
            raise MXNetError("tree_from_numpy: %r is %s, not a numeric array"
                             % (name, type(a).__name__))
        to = dt or (torch.float32 if t.dtype == torch.float64 else t.dtype)
        out[name] = t.detach().to(dev, to, copy=True)
    return out


def _np(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return np.asarray(a)


def load_into_module(mod, arg_params, aux_params, opt_states=None,
                     update_counts=None):
    """Set a bound port ``Module``'s parameters, aux states and (when
    given, after ``init_optimizer``) optimizer states from numpy.

    arg_params / aux_params : ``{name: array}`` (numpy or NDArrays of
        either package's ``get_params()``, converted with ``asnumpy``);
        every parameter and aux state of the module must be there, with
        its bound shape.
    opt_states : ``{param index: array, tuple of arrays or None}`` — the
        unpickled ``Updater.get_states()`` of the JAX package (a
        multi-precision entry is ``(momentum, fp32 master)``).
    update_counts : ``{param index: updates so far}`` — the JAX
        optimizer's ``_index_update_count``, which the pickled states do
        not hold and Adam's bias correction reads.

    Every array is whole (a JAX mesh ``Module``'s ``get_params`` and
    states are); a port module on a mesh cuts its members' shards.
    """
    if not mod.binded:
        raise MXNetError("load_into_module: bind the module first")
    stages = _stages(mod)
    if stages is not None:
        # a SequentialModule: each stage takes its own names; its
        # optimizer states and counts come as one entry per stage
        for i, stage in enumerate(stages):
            names = set(stage._param_names)
            auxn = set(stage._aux_names)
            load_into_module(
                stage, {k: v for k, v in arg_params.items() if k in names},
                {k: v for k, v in aux_params.items() if k in auxn},
                None if opt_states is None else opt_states[i],
                None if update_counts is None else update_counts[i])
        return
    bucketing = getattr(mod, "_curr_module", None)
    if bucketing is not None:
        mod = bucketing
    args = {k: _np(v) for k, v in arg_params.items()}
    auxs = {k: _np(v) for k, v in aux_params.items()}
    _check_names(list(args), mod._param_names, "module parameters")
    _check_names(list(auxs), mod._aux_names, "module aux states")
    bound = mod._whole_shapes()       # whole shapes, on a mesh too
    for table in (args, auxs):
        for name, a in table.items():
            if tuple(a.shape) != tuple(bound[name]):
                raise MXNetError("weights: %r has shape %s, the module "
                                 "needs %s" % (name, a.shape,
                                               tuple(bound[name])))
    mod.set_params(args, auxs)
    if opt_states is not None:
        if not mod.optimizer_initialized:
            raise MXNetError("load_into_module: opt_states need "
                             "init_optimizer first")
        import pickle
        mod._active_updater().set_states(pickle.dumps(
            {int(k): v for k, v in opt_states.items()}))
    if update_counts is not None:
        if not mod.optimizer_initialized:
            raise MXNetError("load_into_module: update_counts need "
                             "init_optimizer first")
        opt = mod._optimizer
        opt._index_update_count = {int(k): int(v)
                                   for k, v in update_counts.items()}
        opt.num_update = max([opt.num_update]
                             + list(opt._index_update_count.values()))


def _stages(mod):
    """The parameter-bearing stages of a ``SequentialModule`` (its
    ``Module``s, in order), or None for any other module."""
    from .module.sequential_module import SequentialModule
    if not isinstance(mod, SequentialModule):
        return None
    return [m for m in mod._modules if hasattr(m, "_param_names")]


def module_to_numpy(mod):
    """``(arg_params, aux_params, opt_states)`` of a port ``Module`` as
    numpy, in :func:`load_into_module`'s form (``opt_states`` None before
    ``init_optimizer``; for a ``SequentialModule`` a list, one entry per
    stage with parameters)."""
    import pickle
    stages = _stages(mod)
    if stages is not None:
        parts = [module_to_numpy(m) for m in stages]
        arg_p, aux_p = {}, {}
        for a, x, _ in parts:
            arg_p.update(a)
            aux_p.update(x)
        return arg_p, aux_p, [st for _, _, st in parts]
    arg_p, aux_p = mod.get_params()
    mod = getattr(mod, "_curr_module", None) or mod
    states = None
    if mod.optimizer_initialized:
        states = pickle.loads(mod._active_updater().get_states())
    return ({k: v.asnumpy() for k, v in arg_p.items()},
            {k: v.asnumpy() for k, v in aux_p.items()}, states)


def fused_rnn_from_numpy(cell, blob, ctx=None):
    """``{"<prefix>parameters": NDArray}`` for a port ``rnn.FusedRNNCell``
    from numpy: either that one packed vector (the JAX cell's argument of
    the same name) or the per-layer, per-gate arrays of the JAX cell's
    ``unpack_weights``. The vector's size must fit the cell's layout."""
    name = "%sparameters" % cell._prefix
    items = {k: _np(v) for k, v in blob.items()}
    if name in items:
        if len(items) != 1:
            raise MXNetError("weights: %r and unpacked arrays %s given "
                             "together" % (name, sorted(set(items) - {name})))
        flat = items[name].ravel()
        cell._infer_input_size(flat.size)
    else:
        probe = "%sl0_i2h%s_weight" % (cell._prefix, cell._gate_names[0])
        if probe not in items:
            raise MXNetError("weights: no %r among the fused RNN arrays"
                             % probe)
        layout, _ = cell._blob_layout(items[probe].shape[1])
        _check_names(list(items), [n for n, _, _ in layout],
                     "fused RNN arrays")
        flat = cell.pack_weights({k: array(v, ctx=cpu())
                                  for k, v in items.items()})[name].asnumpy()
    return {name: array(flat.astype(np.float32), ctx=ctx)}
