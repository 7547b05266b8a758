"""Python side of the general C API (``kernels/csrc/c_api.cc``).

Counterpart of ``mxnet_tpu/c_api_impl.py`` (parity: the reference's
src/c_api/{c_api.cc,c_api_ndarray.cc,c_api_symbolic.cc,c_api_executor.cc}
— the 159-function MXNET_DLL ABI, include/mxnet/c_api.h). The port's C
library embeds CPython (the same design as ``c_predict``: one stack, one
ABI) and calls the helpers here; handles on the C side are owned
PyObject* of the framework objects themselves, so every language binding
drives the exact PyTorch/CUDA path Python users do.

All pointer arguments arrive as integer addresses; ctypes does the raw
memory traffic so the C side stays a thin marshalling layer. ``dev_type``
follows the reference: 1 the host, 2 the CUDA card, 3 pinned host memory;
the caller's ``dev_type`` says where work runs (there is no
``MXNET_TPU_FORCE_CPU``). Where the ABI carries no device
(``MXNDArrayLoad``, ``MXNDArrayLoadFromRawBytes`` of the JAX package's
blobs) the port's default context, ``gpu(0)``, holds, as it does for the
Python entry points. ``MXNDArrayGetData`` hands out the tensor's live
``data_ptr()``, a device pointer for an array on the card, as the
reference does.
"""
from __future__ import annotations

import ctypes
import os
import struct
import weakref

import numpy as np
import torch

import mxnet_tpu_torch as mx
from .base import MXNetError
from .context import Context, cpu
from .ndarray.ndarray import NDArray
from .ops.common import numpy_dtype
from .ops.registry import get_op, list_ops

# reference dtype codes (include/mxnet/base.h TypeFlag)
_DTYPE_BY_CODE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_CODE_BY_DTYPE = {np.dtype(v): k for k, v in _DTYPE_BY_CODE.items()}

_GRAD_REQ_BY_CODE = {0: "null", 1: "write", 2: "write", 3: "add"}

# module-level python functions that are nnvm ops in the reference
_ND_LEVEL_OPS = frozenset({"cast_storage"})


def _ctx(dev_type, dev_id):
    """The Context of a reference dev_type: 1 cpu, 2 gpu, 3 cpu_pinned."""
    if int(dev_type) not in Context.devtype2str:
        raise MXNetError("dev_type %r: the C API takes 1 (cpu), 2 (gpu) or "
                         "3 (cpu_pinned)" % (dev_type,))
    return Context(Context.devtype2str[int(dev_type)], int(dev_id))


def _dtype_code(dtype):
    try:
        return _CODE_BY_DTYPE[np.dtype(dtype)]
    except (TypeError, KeyError):
        raise MXNetError("dtype %s has no reference type code" % (dtype,))


# -- NDArray ----------------------------------------------------------------

def ndarray_create(shape, dev_type, dev_id, delay_alloc, dtype_code):
    dt = _DTYPE_BY_CODE[int(dtype_code)]
    return mx.nd.zeros(tuple(int(s) for s in shape),
                       ctx=_ctx(dev_type, dev_id), dtype=dt)


def ndarray_sync_copy_from(nd, ptr, size):
    n = int(size)
    buf = (ctypes.c_char * (n * nd.dtype.itemsize)).from_address(int(ptr))
    arr = np.frombuffer(buf, dtype=nd.dtype, count=n).reshape(nd.shape)
    nd[:] = arr.copy()


def ndarray_sync_copy_to(nd, ptr, size):
    src = np.ascontiguousarray(nd.asnumpy())
    n = int(size)
    if n != src.size:
        raise MXNetError("copy size %d != ndarray size %d" % (n, src.size))
    ctypes.memmove(int(ptr), src.ctypes.data, n * src.dtype.itemsize)


def ndarray_shape(nd):
    return [int(s) for s in nd.shape]


def ndarray_dtype(nd):
    return _dtype_code(nd.dtype)


def ndarray_wait(nd):
    nd.wait_to_read()


def wait_all():
    mx.nd.waitall()


def ndarray_save(fname, nds, keys):
    if keys:
        mx.nd.save(fname, dict(zip(keys, nds)))
    else:
        mx.nd.save(fname, list(nds))


def ndarray_load(fname):
    data = mx.nd.load(fname)     # onto the default context, as in Python
    if isinstance(data, dict):
        keys = list(data.keys())
        return [data[k] for k in keys], keys
    return list(data), []


# -- operators --------------------------------------------------------------

def op_names():
    return list_ops()


def op_exists(name):
    """Handle-creation validation (the reference's NNGetOpHandle errors
    on unknown names rather than letting arbitrary attributes be
    invoked). Besides registry ops, a small set of python-implemented
    ops live as mx.nd module functions (cast_storage & friends — nnvm
    ops in the reference); they are invokable too, but dunder/private
    names never are."""
    if name in list_ops():
        return True
    # ops the reference registers in nnvm but we implement as module-
    # level python (sparse storage conversion) — an explicit list, NOT a
    # blanket getattr: handing out handles for arbitrary nd attributes
    # (save, array, NDArray...) would defeat this validation
    return name in _ND_LEVEL_OPS


def imperative_invoke(op_name, inputs, keys, vals, outputs):
    """(parity: MXImperativeInvoke / c_api_ndarray.cc). ``outputs`` is
    either None (op allocates) or a list of existing NDArrays to write
    into — the reference's in-place output contract."""
    if not op_exists(op_name):
        raise MXNetError("operator %r is not registered" % op_name)
    fn = getattr(mx.nd, op_name, None)
    params = {k: _parse_val(v) for k, v in zip(keys, vals)}
    if fn is not None:
        res = fn(*inputs, **params)
    else:
        from .imperative import invoke
        res = invoke(get_op(op_name), list(inputs), params)
    if not isinstance(res, (list, tuple)):
        res = [res]
    if outputs:
        if len(outputs) != len(res):
            raise MXNetError(
                "%s produces %d outputs but %d output handles were given"
                % (op_name, len(res), len(outputs)))
        for dst, src in zip(outputs, res):
            if src is not dst:  # mutating ops already wrote in place
                src.copyto(dst)
        return list(outputs)
    return list(res)


def _parse_val(v):
    """Parse a C-string param value the way the reference's dmlc parameter
    parser does (kwargs always arrive as strings over the C ABI)."""
    import ast
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


# -- symbols ----------------------------------------------------------------

def symbol_from_json(json_str):
    return mx.sym.load_json(json_str)


def symbol_from_file(path):
    return mx.sym.load(path)


def symbol_arguments(sym):
    return _sym(sym).list_arguments()


def symbol_outputs(sym):
    return _sym(sym).list_outputs()


def symbol_aux(sym):
    return _sym(sym).list_auxiliary_states()


def symbol_infer_shape(sym, names, shapes):
    known = dict(zip(names, [tuple(s) for s in shapes]))
    arg_shapes, out_shapes, aux_shapes = _sym(sym).infer_shape(**known)
    def clean(lst):
        return [list(s) if s is not None else [] for s in lst]
    complete = all(s is not None for s in arg_shapes + out_shapes + aux_shapes)
    return clean(arg_shapes), clean(out_shapes), clean(aux_shapes), complete


# -- executor ---------------------------------------------------------------

def executor_bind(sym, dev_type, dev_id, arg_nds, grad_nds, req_codes,
                  aux_nds):
    reqs = [_GRAD_REQ_BY_CODE[int(c)] for c in req_codes]
    grads = list(grad_nds)  # NULL C handles already arrive as None
    return _sym(sym).bind(ctx=_ctx(dev_type, dev_id), args=list(arg_nds),
                    args_grad=grads, grad_req=reqs,
                    aux_states=list(aux_nds) if aux_nds else None)


def executor_forward(ex, is_train):
    ex.forward(is_train=bool(is_train))


def executor_backward(ex, head_grads):
    ex.backward(out_grads=list(head_grads) if head_grads else None)


def executor_outputs(ex):
    return list(ex.outputs)


# ===========================================================================
# Round-4 tranche: the rest of the high-traffic ABI (parity:
# include/mxnet/c_api.h:359-1269 — runtime, NDArray extras, full MXSymbol
# attr/compose surface, MXExecutorSimpleBind, MXDataIter*, MXKVStore*,
# MXRecordIO*, MXAutograd*, CachedOp).
# ===========================================================================

# reference include/mxnet/ndarray.h:60-63 storage-type codes
_STYPE_CODE = {"default": 0, "row_sparse": 1, "csr": 2}
_DEV_CODE = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}


# -- runtime ----------------------------------------------------------------

def version():
    # reference MXNET_VERSION for 0.12.1 (MAJOR*10000 + MINOR*100 + PATCH)
    return 1201


def random_seed(seed):
    mx.random.seed(int(seed))


def notify_shutdown():
    mx.nd.waitall()


def set_num_omp_threads(n):
    os.environ["OMP_NUM_THREADS"] = str(int(n))


def engine_set_bulk_size(size):
    from . import engine
    return int(engine.set_bulk_size(int(size)))


def profiler_set_config(mode, filename):
    mx.profiler.set_config(profile_all=bool(mode), filename=filename)


def profiler_set_state(state):
    mx.profiler.set_state("run" if int(state) else "stop")


def profiler_dump():
    mx.profiler.dump()


# -- NDArray extras ---------------------------------------------------------

def ndarray_create_none():
    """Placeholder handle later filled by copy/load (reference
    MXNDArrayCreateNone): an empty host array that holds no bytes; a
    copy into it takes the source's context."""
    return mx.nd.zeros((0,), ctx=cpu())


def ndarray_slice(nd, begin, end):
    return nd[int(begin):int(end)]  # write-through view, like the reference


def ndarray_at(nd, idx):
    return nd[int(idx)]


def ndarray_reshape(nd, dims):
    return nd.reshape(tuple(int(d) for d in dims))


def ndarray_get_context(nd):
    ctx = nd.context
    return _DEV_CODE[ctx.device_type], int(ctx.device_id)


def ndarray_storage_type(nd):
    return _STYPE_CODE.get(getattr(nd, "stype", "default"), 0)


def ndarray_get_grad(nd):
    return nd.grad  # None -> NULL handle on the C side


def ndarray_detach(nd):
    return nd.detach()


# the fresh-grad flags by id of the array (an NDArray has __slots__);
# an entry goes with its array
_FRESH_GRAD = {}


def ndarray_set_grad_state(nd, state):
    key = id(nd)
    if key not in _FRESH_GRAD:
        weakref.finalize(nd, _FRESH_GRAD.pop, key, None)
    _FRESH_GRAD[key] = bool(state)


def ndarray_get_grad_state(nd):
    return 1 if _FRESH_GRAD.get(id(nd), False) else 0


def _copy_into(dst, t, ctx):
    """Copy tensor ``t`` into ``dst``: in place when the shape, dtype and
    device agree, else ``dst`` takes a copy of ``t`` (and its context)."""
    with torch.no_grad():
        if dst._data.shape == t.shape and dst._data.dtype == t.dtype \
                and dst._data.device == t.device:
            dst._data.copy_(t)
        else:
            dst._data = t.detach().clone()
            dst._ctx = ctx


def ndarray_sync_copy_from_ndarray(dst, src, i):
    """i < 0 copies the data array; i >= 0 copies src.aux_data(i) — the
    reference contract (c_api.h MXNDArraySyncCopyFromNDArray), where aux
    arrays are csr [indptr, indices] / row_sparse [indices]."""
    i = int(i)
    if i < 0:
        _copy_into(dst, src._data, src.context)
        return
    from .ndarray import sparse as _sp
    if isinstance(src, _sp.CSRNDArray):
        aux = [src._csr_indptr, src._csr_indices]
    elif isinstance(src, _sp.RowSparseNDArray):
        aux = [src._rsp_indices]
    else:
        raise MXNetError(
            "aux_data(%d) requested on dense NDArray (aux arrays exist "
            "only for sparse storage)" % i)
    if i >= len(aux):
        raise MXNetError("aux_data index %d out of range (%d aux arrays)"
                         % (i, len(aux)))
    _copy_into(dst, aux[i], src.context)


_RAW_JAX = b"MXTPRAW2"      # the JAX package's blob: no context
_RAW = b"MXTTRAW1"          # the port's: the JAX layout plus the context


def ndarray_save_raw_bytes(nd):
    """Self-describing single-array blob that records its context, as the
    reference's ``NDArray::Save`` does (its raw format is its own binary
    layout, mirrored in role, not in bytes). Plain struct-packed header +
    raw data — NO pickle: this is the model-blob entry point and must not
    give untrusted bytes a code-execution surface."""
    _dtype_code(nd.dtype)       # a type the reference has
    arr = np.ascontiguousarray(nd.asnumpy())
    dt = str(arr.dtype).encode()
    ctx = nd.context
    return (struct.pack("<8sBi", _RAW, ctx.device_typeid, ctx.device_id)
            + struct.pack("<B", len(dt)) + dt
            + struct.pack("<B", arr.ndim)
            + struct.pack("<%dq" % arr.ndim, *arr.shape)
            + arr.tobytes())


def ndarray_load_from_raw_bytes(raw):
    """Load a blob of :func:`ndarray_save_raw_bytes` onto its recorded
    context, or one of the JAX package's onto the default context."""
    raw = bytes(raw)
    if raw[:8] == _RAW:
        dev_type, dev_id = struct.unpack_from("<Bi", raw, 8)
        ctx, off = _ctx(dev_type, dev_id), 8 + struct.calcsize("<Bi")
    elif raw[:8] == _RAW_JAX:
        ctx, off = None, 8
    else:
        raise MXNetError("not a raw NDArray blob")
    (dtlen,) = struct.unpack_from("<B", raw, off)
    off += 1
    dt = raw[off:off + dtlen].decode("ascii")
    off += dtlen
    (ndim,) = struct.unpack_from("<B", raw, off)
    off += 1
    shape = struct.unpack_from("<%dq" % ndim, raw, off)
    off += 8 * ndim
    data = np.frombuffer(raw, dtype=np.dtype(dt), offset=off)
    return mx.nd.array(data.reshape(shape).copy(), ctx=ctx,
                       dtype=np.dtype(dt))


# -- symbol: atomic creation + compose --------------------------------------

class _AtomicSymbol:
    """An op symbol created but not yet composed with inputs (the
    reference's nnvm node with params only; MXSymbolCompose supplies
    inputs in place)."""

    def __init__(self, op_name, params):
        self.op_name = op_name
        self.params = params
        self.composed = None


def _sym(s):
    """Unwrap a SymbolHandle: composed atomic symbols delegate to their
    composition result."""
    if isinstance(s, _AtomicSymbol):
        if s.composed is None:
            raise MXNetError(
                "atomic symbol %r has not been composed with inputs yet "
                "(call MXSymbolCompose first)" % s.op_name)
        return s.composed
    return s


def symbol_create_atomic(op_name, keys, vals):
    if not op_exists(op_name):
        raise MXNetError("operator %r is not registered" % op_name)
    return _AtomicSymbol(op_name,
                         {k: _parse_val(v) for k, v in zip(keys, vals)})


def symbol_compose(s, name, keys, args):
    """In-place composition (parity: MXSymbolCompose). ``args`` are
    Symbol handles; ``keys`` may be empty for positional composition."""
    args = [_sym(a) for a in args]
    if isinstance(s, _AtomicSymbol):
        fn = getattr(mx.sym, s.op_name, None)
        params = dict(s.params)
        if name:
            params["name"] = name
        if fn is None:
            raise MXNetError("no symbol constructor for %r" % s.op_name)
        if keys:
            s.composed = fn(**dict(zip(keys, args)), **params)
        else:
            s.composed = fn(*args, **params)
        return
    target = _sym(s)
    if keys:
        composed = target(name=name, **dict(zip(keys, args)))
    else:
        composed = target(*args, name=name)
    target._outputs[:] = composed._outputs


def symbol_create_variable(name):
    return mx.sym.Variable(name)


def symbol_create_group(symbols):
    return mx.sym.Group([_sym(s) for s in symbols])


def symbol_save_to_file(s, fname):
    _sym(s).save(fname)


def symbol_to_json(s):
    return _sym(s).tojson()


def symbol_copy(s):
    import copy
    return copy.deepcopy(_sym(s))


def symbol_print(s):
    return _sym(s).debug_str()


def symbol_get_name(s):
    n = _sym(s).name
    return (n if n is not None else "", n is not None)


def symbol_get_attr(s, key):
    v = _sym(s).attr(key)
    return (v if v is not None else "", v is not None)


def symbol_set_attr(s, key, value):
    if isinstance(s, _AtomicSymbol) and s.composed is None:
        s.params["__%s__" % key if not key.startswith("__") else key] = value
        return
    _sym(s)._set_attr(**{key: value})


def symbol_list_attr(s):
    """Flat [key, value, ...] pairs, recursive form uses the
    'nodename$key' convention the reference uses (c_api_symbolic.cc)."""
    out = []
    for node_name, attrs in _sym(s).attr_dict().items():
        for k, v in attrs.items():
            out.append("%s$%s" % (node_name, k))
            out.append(str(v))
    return out


def symbol_list_attr_shallow(s):
    sym = _sym(s)
    out = []
    node = sym._outputs[0][0]
    for k, v in node._extra_attrs.items():
        out.append(k)
        out.append(str(v))
    return out


def symbol_get_internals(s):
    return _sym(s).get_internals()


def symbol_get_children(s):
    return _sym(s).get_children()  # may be None -> NULL handle


def symbol_get_output(s, index):
    return _sym(s)[int(index)]


def symbol_infer_shape_partial(s, names, shapes):
    known = {n: tuple(sh) for n, sh in zip(names, shapes)}
    arg_s, out_s, aux_s = _sym(s).infer_shape_partial(**known)

    def clean(lst):
        return [list(x) if x is not None else [] for x in (lst or [])]
    complete = bool(arg_s) and all(
        x is not None for x in arg_s + out_s + aux_s)
    return clean(arg_s), clean(out_s), clean(aux_s), complete


def symbol_infer_type(s, names, type_codes):
    known = {n: _DTYPE_BY_CODE[int(c)] for n, c in zip(names, type_codes)
             if int(c) != -1}
    arg_t, out_t, aux_t = _sym(s).infer_type(**known)

    def codes(lst):
        return [_CODE_BY_DTYPE[np.dtype(t)] if t is not None else -1
                for t in (lst or [])]
    complete = bool(arg_t) and all(
        t is not None for t in arg_t + out_t + aux_t)
    return codes(arg_t), codes(out_t), codes(aux_t), complete


def op_info(name):
    """(name, description, arg_names, arg_types, arg_descs,
    key_var_num_args) from the registry (parity:
    MXSymbolGetAtomicSymbolInfo reading nnvm op attrs)."""
    op = get_op(name)
    doc = (op.fn.__doc__ or "").strip()
    arg_names = list(op.arg_names)
    arg_types = ["NDArray-or-Symbol"] * len(arg_names)
    extra = sorted(k for k in op.defaults if k not in arg_names)
    for k in extra:
        arg_names.append(k)
        arg_types.append("string, optional")
    key_var = "num_args" if "num_args" in op.defaults else ""
    return (name, doc, arg_names, arg_types, [""] * len(arg_names), key_var)


# -- executor extras --------------------------------------------------------

def executor_simple_bind(s, dev_type, dev_id, g2c_keys, g2c_dev_types,
                         g2c_dev_ids, req_names, req_types, shape_names,
                         shapes, dtype_names, dtype_codes, stype_names,
                         stype_codes):
    """(parity: MXExecutorSimpleBind, c_api_executor.cc:169). Returns
    (executor, in_args, arg_grads, aux_states). Shared-buffer reuse is
    accepted and ignored at the C layer (PyTorch's caching allocator owns
    allocation; reuse is an allocator hint in the reference)."""
    sym = _sym(s)
    # reference calling conventions (c_api_executor.cc): names+types is
    # the dict form; names==NULL with ONE type is the global string; a
    # bare list (no names) applies in list_arguments() order
    if req_names:
        grad_req = dict(zip(req_names, req_types))
    elif len(req_types) == 1:
        grad_req = req_types[0]
    elif req_types:
        grad_req = list(req_types)
    else:
        grad_req = "write"
    type_dict = {n: _DTYPE_BY_CODE[int(c)]
                 for n, c in zip(dtype_names, dtype_codes)}
    group2ctx = {k: _ctx(t, i)
                 for k, t, i in zip(g2c_keys, g2c_dev_types, g2c_dev_ids)}
    kwargs = {n: tuple(int(x) for x in sh)
              for n, sh in zip(shape_names, shapes)}
    ex = sym.simple_bind(ctx=_ctx(dev_type, dev_id), grad_req=grad_req,
                         type_dict=type_dict or None,
                         group2ctx=group2ctx or None, **kwargs)
    return (ex, list(ex.arg_arrays),
            [g for g in ex.grad_arrays], list(ex.aux_arrays))


def executor_print(ex):
    outs = ", ".join("%s %s" % (o.shape, o.dtype) for o in ex.outputs)
    return "Executor(outputs=[%s])" % outs


# -- CachedOp ---------------------------------------------------------------

class _CCachedOp:
    """Imperative invocation of a symbol graph with executor reuse
    (parity: reference CachedOp, imperative/cached_op.cc — bind once per
    input signature, then re-run)."""

    def __init__(self, s):
        self.sym = _sym(s)
        self.arg_names = self.sym.list_arguments()
        self.aux_names = self.sym.list_auxiliary_states()
        self._cache = {}

    def __call__(self, inputs):
        n_args = len(self.arg_names)
        if len(inputs) != n_args + len(self.aux_names):
            raise MXNetError(
                "CachedOp expects %d inputs (%d args + %d aux), got %d"
                % (n_args + len(self.aux_names), n_args,
                   len(self.aux_names), len(inputs)))
        args = inputs[:n_args]
        aux = inputs[n_args:]
        sig = tuple((tuple(a.shape), str(a.dtype), str(a.context))
                    for a in inputs)
        ex = self._cache.get(sig)
        if ex is None:
            # bind PRIVATE copies: the executor keeps its bound arrays,
            # and later cache-hit writes must never mutate caller inputs
            ex = self.sym.bind(ctx=args[0].context if args
                               else mx.current_context(),
                               args=[a.copy() for a in args],
                               args_grad=None, grad_req="null",
                               aux_states=[a.copy() for a in aux]
                               if aux else None)
            self._cache[sig] = ex
        else:
            with torch.no_grad():
                for dst, src in zip(ex.arg_arrays + ex.aux_arrays,
                                    args + aux):
                    dst._data.copy_(src._data)
        return list(ex.forward(is_train=False))


def cached_op_create(s):
    return _CCachedOp(s)


def cached_op_invoke(cop, inputs):
    return cop(list(inputs))


# -- autograd ---------------------------------------------------------------

def autograd_set_recording(flag):
    from . import imperative
    return 1 if imperative.set_recording(bool(flag)) else 0


def autograd_set_training(flag):
    from . import imperative
    return 1 if imperative.set_training(bool(flag)) else 0


def autograd_is_recording():
    from . import imperative
    return 1 if imperative.is_recording() else 0


def autograd_is_training():
    from . import imperative
    return 1 if imperative.is_training() else 0


def autograd_mark_variables(variables, req_codes, grads):
    from . import autograd
    reqs = [_GRAD_REQ_BY_CODE[int(c)] for c in req_codes]
    autograd.mark_variables(list(variables), list(grads), reqs)


def autograd_backward(outputs, ograds, retain_graph, is_train):
    from . import autograd
    heads = [o for o in ograds] if ograds else None
    autograd.backward(list(outputs), head_grads=heads,
                      retain_graph=bool(retain_graph),
                      train_mode=bool(is_train))


def autograd_backward_ex(outputs, ograds, variables, retain_graph,
                         create_graph, is_train):
    """(parity: MXAutogradBackwardEx). With ``variables``, returns their
    grads + stype codes instead of writing into attached buffers."""
    from . import autograd
    heads = list(ograds) if ograds else None
    if not variables:
        autograd.backward(list(outputs), head_grads=heads,
                          retain_graph=bool(retain_graph),
                          train_mode=bool(is_train))
        return [], []
    grads = autograd.grad(list(outputs), list(variables), head_grads=heads,
                          retain_graph=bool(retain_graph),
                          create_graph=bool(create_graph),
                          train_mode=bool(is_train))
    return list(grads), [ndarray_storage_type(g) for g in grads]


def autograd_get_symbol(nd):
    from . import autograd
    return autograd.get_symbol(nd)


# -- data iterators ---------------------------------------------------------

def _iter_registry():
    return {
        "MNISTIter": mx.io.MNISTIter,
        "CSVIter": mx.io.CSVIter,
        "LibSVMIter": mx.io.LibSVMIter,
        "ImageRecordIter": mx.io.ImageRecordIter,
    }


def list_data_iters():
    return sorted(_iter_registry())


def data_iter_info(name):
    cls = _iter_registry()[name]
    import inspect
    doc = (cls.__doc__ or "").strip()
    try:
        params = [p for p in inspect.signature(cls).parameters
                  if p not in ("args", "kwargs")]
    except (ValueError, TypeError):
        params = []
    return (name, doc, params, ["string"] * len(params),
            [""] * len(params))


class _CDataIter:
    """Iterator handle: owns the python iterator + the current batch."""

    def __init__(self, it):
        self.it = it
        self.batch = None

    def next(self):
        try:
            self.batch = self.it.next()
            return 1
        except StopIteration:
            self.batch = None
            return 0


def data_iter_create(name, keys, vals):
    cls = _iter_registry()[name]
    params = {k: _parse_val(v) for k, v in zip(keys, vals)}
    return _CDataIter(cls(**params))


def data_iter_next(h):
    return h.next()


def data_iter_before_first(h):
    h.it.reset()
    h.batch = None


def data_iter_get_data(h):
    if h.batch is None:
        raise MXNetError("no current batch (call MXDataIterNext first)")
    return h.batch.data[0]


def data_iter_get_label(h):
    if h.batch is None:
        raise MXNetError("no current batch (call MXDataIterNext first)")
    return h.batch.label[0]


def data_iter_get_pad(h):
    if h.batch is None:
        raise MXNetError("no current batch (call MXDataIterNext first)")
    return int(h.batch.pad or 0)


def data_iter_get_index(h):
    if h.batch is None:
        raise MXNetError("no current batch (call MXDataIterNext first)")
    idx = getattr(h.batch, "index", None)
    return [int(i) for i in idx] if idx is not None else []


# -- kvstore ----------------------------------------------------------------

def init_ps_env(keys, vals):
    for k, v in zip(keys, vals):
        os.environ[str(k)] = str(v)


def kvstore_create(type_str):
    return mx.kv.create(type_str or "local")


def kvstore_init(kv, keys, vals):
    kv.init(list(keys), list(vals))


def kvstore_push(kv, keys, vals, priority):
    kv.push(list(keys), list(vals), priority=int(priority))


def kvstore_pull(kv, keys, vals, priority):
    kv.pull(list(keys), out=list(vals), priority=int(priority))


def kvstore_pull_row_sparse(kv, keys, vals, row_ids, priority):
    kv.row_sparse_pull(list(keys), out=list(vals), priority=int(priority),
                       row_ids=list(row_ids))


def kvstore_set_gradient_compression(kv, keys, vals):
    kv.set_gradient_compression(
        {k: _parse_val(v) for k, v in zip(keys, vals)})


def kvstore_set_updater(kv, fn_addr, handle_addr, str_fn_addr=0):
    """Install a C callback updater (parity: MXKVStoreSetUpdater/Ex).
    typedef void (MXKVStoreUpdater)(int key, NDArrayHandle recv,
    NDArrayHandle local, void* handle); the Ex form adds
    MXKVStoreStrUpdater(const char* key, ...) for string keys. Handles
    passed to the callback are NEW references (the callback frees them
    with MXNDArrayFree, the reference's ownership contract)."""
    cb = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p)(int(fn_addr))         if fn_addr else None
    str_cb = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                              ctypes.c_void_p,
                              ctypes.c_void_p)(int(str_fn_addr))         if str_fn_addr else None

    def updater(key, recv, local):
        handle = handle_addr if handle_addr else None
        is_int_key = isinstance(key, int)
        if is_int_key and cb is None or not is_int_key and str_cb is None:
            raise MXNetError(
                "no C updater registered for %s keys (use "
                "MXKVStoreSetUpdaterEx to install both forms)"
                % ("int" if is_int_key else "string"))
        ctypes.pythonapi.Py_IncRef(ctypes.py_object(recv))
        ctypes.pythonapi.Py_IncRef(ctypes.py_object(local))
        if is_int_key:
            cb(int(key), id(recv), id(local), handle)
        else:
            str_cb(str(key).encode(), id(recv), id(local), handle)

    kv._set_updater(updater)


def kvstore_get_type(kv):
    return kv.type


def kvstore_get_rank(kv):
    return int(kv.rank)


def kvstore_get_group_size(kv):
    return int(kv.num_workers)


def kvstore_barrier(kv):
    kv.barrier()


def kvstore_send_command(kv, cmd_id, cmd_body):
    kv.send_command_to_servers(int(cmd_id), cmd_body)


def kvstore_num_dead_node(kv, node_id, timeout_sec):
    return int(kv.num_dead_node(int(node_id), timeout=int(timeout_sec)))


def kvstore_run_server(kv, controller_addr, handle_addr):
    """SPMD has no server processes (kvstore_server.py role-absorber);
    accept the controller callback for ABI parity and return — the
    reference blocks here running the request loop."""
    return None


# -- recordio ---------------------------------------------------------------

def recordio_writer_create(uri):
    from . import recordio
    return recordio.MXRecordIO(uri, "w")


def recordio_reader_create(uri):
    from . import recordio
    return recordio.MXRecordIO(uri, "r")


def recordio_close(h):
    h.close()


def recordio_write_record(h, ptr, size):
    h.write(ctypes.string_at(int(ptr), int(size)))


def recordio_read_record(h):
    return h.read()  # None at EOF -> NULL buf


def recordio_tell(h):
    return int(h.tell())


def recordio_seek(h, pos):
    h.seek(int(pos))


# ===========================================================================
# Final tranche: sparse NDArray ABI, legacy MXFunc*, BindX, monitor
# callback, RTC, shared-mem transport (c_api.h rows not yet covered).
# ===========================================================================

def ndarray_create_sparse(stype_code, shape, dev_type, dev_id, dtype_code,
                          aux_type_codes):
    """(parity: MXNDArrayCreateSparseEx) — aux types are fixed by the
    storage format here (int32/int64 indices), accepted for ABI parity."""
    from .ndarray import sparse as _sp
    stypes = {1: "row_sparse", 2: "csr"}
    if int(stype_code) not in stypes:
        raise MXNetError("unknown sparse storage type %d" % stype_code)
    dt = _DTYPE_BY_CODE[int(dtype_code)]
    return _sp.zeros(stypes[int(stype_code)],
                     tuple(int(s) for s in shape),
                     ctx=_ctx(dev_type, dev_id), dtype=dt)


def _aux_arrays(nd):
    from .ndarray import sparse as _sp
    if isinstance(nd, _sp.CSRNDArray):
        return [nd._csr_indptr, nd._csr_indices]
    if isinstance(nd, _sp.RowSparseNDArray):
        return [nd._rsp_indices]
    raise MXNetError("dense NDArray has no aux arrays")


def ndarray_get_aux_type(nd, i):
    aux = _aux_arrays(nd)[int(i)]
    return _CODE_BY_DTYPE[np.dtype(numpy_dtype(aux.dtype))]


def ndarray_get_aux_ndarray(nd, i):
    return NDArray(_aux_arrays(nd)[int(i)], nd.context)


def ndarray_get_data_ndarray(nd):
    from .ndarray import sparse as _sp
    if isinstance(nd, _sp.CSRNDArray):
        return NDArray(nd._csr_data, nd.context)
    if isinstance(nd, _sp.RowSparseNDArray):
        return NDArray(nd._rsp_data, nd.context)
    return NDArray(nd._data, nd.context)


def ndarray_sync_check_format(nd, full_check):
    """(parity: MXNDArraySyncCheckFormat / common/utils.h CheckFormat):
    validate sparse structural invariants, raising on violation."""
    from .ndarray import sparse as _sp
    if isinstance(nd, _sp.CSRNDArray):
        indptr = nd._csr_indptr.cpu().numpy()
        indices = nd._csr_indices.cpu().numpy()
        if indptr[0] != 0 or indptr[-1] != len(indices):
            raise MXNetError("csr indptr endpoints invalid")
        if (np.diff(indptr) < 0).any():
            raise MXNetError("csr indptr must be non-decreasing")
        if bool(int(full_check)) and indices.size:
            if indices.min() < 0 or indices.max() >= nd.shape[1]:
                raise MXNetError("csr column index out of range")
    elif isinstance(nd, _sp.RowSparseNDArray):
        idx = nd._rsp_indices.cpu().numpy()
        if (np.diff(idx) <= 0).any() if idx.size > 1 else False:
            raise MXNetError("row_sparse indices must be strictly "
                             "increasing")
        if bool(int(full_check)) and idx.size:
            if idx.min() < 0 or idx.max() >= nd.shape[0]:
                raise MXNetError("row_sparse row index out of range")


def ndarray_get_data_ptr(nd):
    """(parity: MXNDArrayGetData) — the address of the array's first
    element: the live ``data_ptr()`` of its tensor, a device pointer for
    an array on the card, as the reference hands out."""
    t = nd._data
    if not t.is_contiguous():
        raise MXNetError("MXNDArrayGetData: the array is a non-contiguous "
                         "view; copy it first")
    return int(t.data_ptr())


# -- legacy function API (MXListFunctions/MXFuncInvoke) ---------------------
# The reference's "functions" ARE the imperative ops under the legacy
# calling convention (c_api.cc RegisterAPIFunction): scalar params come
# separately from array in/outs.

def func_info(name):
    op = get_op(name)
    doc = (op.fn.__doc__ or "").strip()
    scalars = sorted(k for k in op.defaults if k not in op.arg_names)
    return (name, doc, scalars, ["string"] * len(scalars),
            [""] * len(scalars), "")


def func_describe(name):
    """(num_use_vars, num_scalars, num_mutate_vars, type_mask)."""
    op = get_op(name)
    n_mutate = len(op.mutate) if op.mutate else 0
    n_use = max(int(op.nin) - n_mutate, 0)
    scalars = [k for k in op.defaults if k not in op.arg_names]
    # type_mask: kNDArrayArgBeforeScalar (=1) matches our ordering
    return (n_use, len(scalars), n_mutate, 1)


def func_invoke(name, use_vars, scalars, mutate_vars, extra_keys=None,
                extra_vals=None):
    """(parity: MXFuncInvoke(Ex)) — legacy convention: the op's input
    slots at its registered mutate positions take mutate_vars, the rest
    take use_vars in order; outputs write into mutate_vars. The Ex form
    adds string params (extra_keys/extra_vals) that OVERRIDE the
    positional scalar slots."""
    op = get_op(name)
    mut_positions = set(op.mutate or ())
    scalar_names = sorted(k for k in op.defaults if k not in op.arg_names)
    params = {k: _parse_val(str(v))
              for k, v in zip(scalar_names, scalars)}
    for k, v in zip(extra_keys or (), extra_vals or ()):
        params[k] = _parse_val(v)
    inputs, ui, mi = [], 0, 0
    for pos in range(len(use_vars) + len(mutate_vars)):
        if pos in mut_positions and mi < len(mutate_vars):
            inputs.append(mutate_vars[mi])
            mi += 1
        else:
            inputs.append(use_vars[ui])
            ui += 1
    return imperative_invoke(name, inputs, list(params.keys()),
                             [str(v) for v in params.values()],
                             list(mutate_vars) if mutate_vars else None)


# -- executor extras --------------------------------------------------------

def executor_bind_x(sym, dev_type, dev_id, g2c_keys, g2c_dev_types,
                    g2c_dev_ids, arg_nds, grad_nds, req_codes, aux_nds):
    """(parity: MXExecutorBindX/BindEX — Bind + a group2ctx device map)."""
    reqs = [_GRAD_REQ_BY_CODE[int(c)] for c in req_codes]
    group2ctx = {k: _ctx(t, i)
                 for k, t, i in zip(g2c_keys, g2c_dev_types, g2c_dev_ids)}
    return _sym(sym).bind(ctx=_ctx(dev_type, dev_id), args=list(arg_nds),
                          args_grad=list(grad_nds), grad_req=reqs,
                          aux_states=list(aux_nds) if aux_nds else None,
                          group2ctx=group2ctx or None)


def executor_set_monitor_callback(ex, fn_addr, handle_addr, monitor_all):
    """C monitor callback: void cb(const char* name, NDArrayHandle arr,
    void* handle). The handle passed in is a NEW reference (C side frees
    with MXNDArrayFree, reference ownership contract)."""
    cb = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                          ctypes.c_void_p)(int(fn_addr))

    def monitor(name, arr):
        ctypes.pythonapi.Py_IncRef(ctypes.py_object(arr))
        cb(str(name).encode(), id(arr),
           handle_addr if handle_addr else None)

    ex.set_monitor_callback(monitor, monitor_all=bool(monitor_all))


# -- RTC (parity: mx.rtc over MXRtc*; NVRTC-compiled CUDA C) --------------

_RTC_TYPE_NAMES = {0: "float", 1: "double", 2: "half", 3: "uint8_t",
                   4: "int32_t", 5: "int8_t", 6: "int64_t"}

_CTYPES_BY_CODE = {0: ctypes.c_float, 1: ctypes.c_double,
                   2: ctypes.c_uint16, 3: ctypes.c_uint8,
                   4: ctypes.c_int32, 5: ctypes.c_int8, 6: ctypes.c_int64}


def rtc_module_create(source, options, exports):
    from . import rtc
    return rtc.CudaModule(source, options=tuple(options),
                          exports=tuple(exports))


def rtc_kernel_create(mod, name, is_ndarray, is_const, dtype_codes):
    # get_kernel's parser wants "(const) type (*) (name)"
    sig = ", ".join(
        ("const %s*" % _RTC_TYPE_NAMES[int(t)] if (nd and c) else
         "%s*" % _RTC_TYPE_NAMES[int(t)] if nd else
         _RTC_TYPE_NAMES[int(t)])
        for nd, c, t in zip(is_ndarray, is_const, dtype_codes))
    return mod.get_kernel(name, sig), [bool(x) for x in is_ndarray], \
        [int(t) for t in dtype_codes]


def rtc_kernel_call(kernel_tuple, dev_id, arg_addrs, gx, gy, gz, bx, by,
                    bz, shared_mem):
    """args arrive as raw addresses: NDArray args are PyObject*,
    scalars are pointers to the value (the reference's void** call
    convention); a ``half`` scalar is read as its 16 bits."""
    kernel, is_ndarray, dtype_codes = kernel_tuple
    args = []
    for addr, nd, code in zip(arg_addrs, is_ndarray, dtype_codes):
        if nd:
            args.append(ctypes.cast(int(addr), ctypes.py_object).value)
        else:
            v = _CTYPES_BY_CODE[int(code)].from_address(int(addr)).value
            args.append(np.uint16(v).view(np.float16) if int(code) == 2
                        else v)
    kernel.launch(args, mx.gpu(int(dev_id)), (int(gx), int(gy), int(gz)),
                  (int(bx), int(by), int(bz)), int(shared_mem))


def legacy_rtc_source(name, input_names, output_names, inputs, outputs,
                      body):
    """The kernel the reference's ``MXRtcCreate`` compiles
    (src/common/mxrtc.cc ``MXRtc::decorate``): an ``extern "C"`` kernel
    named ``name`` over ``const float*`` inputs and ``float*`` outputs,
    with each array's ``<name>_ndim`` and ``<name>_dims[]`` as constants
    before the user's ``body``."""
    params = ["const float* %s" % n for n in input_names] + \
        ["float* %s" % n for n in output_names]
    src = "\nextern \"C\" __global__ void %s(%s) {\n" % (
        name, ",".join(params))
    for n, a in list(zip(input_names, inputs)) + list(zip(output_names,
                                                          outputs)):
        src += "const int %s_ndim = %d;\n" % (n, len(a.shape))
        src += "const int %s_dims[] = {%s};\n" % (
            n, ",".join(str(int(d)) for d in a.shape))
    return src + body + "\n}\n"


class _LegacyRtc:
    """(parity: the old MXRtcCreate/Push API — fixed input/output lists
    bound at create). Create compiles the reference's wrapper
    (:func:`legacy_rtc_source`) with NVRTC; push launches it on the
    arrays' card with the grid and block given. The arrays are float32,
    contiguous and on one card; the JAX package ran a Python function
    here instead."""

    def __init__(self, name, input_names, output_names, inputs, outputs,
                 source):
        from . import rtc
        self.name = name
        self.source = legacy_rtc_source(name, input_names, output_names,
                                        inputs, outputs, source)
        self.kernel = rtc.CudaModule(self.source).get_kernel(
            name, ", ".join(["const float* %s" % n for n in input_names]
                            + ["float* %s" % n for n in output_names]))

    def push(self, inputs, outputs, grid, block):
        arrays = list(inputs) + list(outputs)
        if not arrays:
            raise MXNetError("MXRtcPush: no arrays to launch %s on"
                             % self.name)
        self.kernel.launch(arrays, arrays[0].context, grid, block)


def rtc_create(name, input_names, output_names, inputs, outputs, source):
    return _LegacyRtc(name, input_names, output_names, inputs, outputs,
                      source)


def rtc_push(handle, inputs, outputs, gx, gy, gz, bx, by, bz):
    handle.push(list(inputs), list(outputs), (int(gx), int(gy), int(gz)),
                (int(bx), int(by), int(bz)))


# -- shared-memory transport ------------------------------------------------

_SHM_COUNTER = [0]


def _shm_path(pid, seg_id):
    return "/dev/shm/mxtpu_torch_%d_%d" % (int(pid), int(seg_id))


def ndarray_get_shared_mem_handle(nd):
    """(parity: MXNDArrayGetSharedMemHandle) — POSIX shm segment named
    /mxtpu_torch_<pid>_<id>; returns (pid, id). One-shot transport: the
    consumer's ndarray_create_from_shared_mem COPIES and UNLINKS the
    segment (the array's own storage is a tensor of PyTorch's allocator,
    so unlike the reference the segment cannot back it — without the
    unlink every push would leak a tmpfs file). Ids come from a
    process-local counter, never object identity (id() values are reused
    after GC)."""
    arr = np.ascontiguousarray(nd.asnumpy())
    pid = os.getpid()
    _SHM_COUNTER[0] += 1
    seg_id = _SHM_COUNTER[0]
    with open(_shm_path(pid, seg_id), "wb") as f:
        f.write(arr.tobytes())
    return pid, seg_id


def ndarray_create_from_shared_mem(shared_pid, shared_id, shape,
                                   dtype_code):
    """The segment's array in host memory, where the reference's
    shared-memory arrays live (``Context::CPUShared``)."""
    dt = _DTYPE_BY_CODE[int(dtype_code)]
    path = _shm_path(shared_pid, shared_id)
    with open(path, "rb") as f:
        raw = f.read()
    os.unlink(path)  # one-shot transport, see get_shared_mem_handle
    arr = np.frombuffer(raw, dtype=dt).reshape(
        tuple(int(s) for s in shape))
    return mx.nd.array(arr.copy(), ctx=cpu(), dtype=dt)
