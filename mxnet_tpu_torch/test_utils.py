"""Testing fixtures: the numeric-check engine.

Counterpart of ``mxnet_tpu/test_utils.py`` (parity: reference
``python/mxnet/test_utils.py``): forward against numpy
(``check_symbolic_forward``), backward against given gradients or
finite differences (``check_symbolic_backward``,
``check_numeric_gradient``), and one graph on several contexts
(``check_consistency``: ``gpu(0)`` against ``cpu()`` here, where the JAX
package compares its device with ``cpu()``). Arrays are made on
``default_context()`` unless a ``ctx`` is given; with no default set,
that is the current context, which is ``gpu(0)`` (set
``set_default_context(mx.cpu())`` where there is no card).
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .context import Context, cpu, current_context
from .ndarray.ndarray import NDArray, array as nd_array, zeros as nd_zeros
from . import ndarray as nd

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "rand_ndarray", "rand_shape_2d", "rand_shape_3d",
           "random_arrays", "check_numeric_gradient", "check_symbolic_forward",
           "check_symbolic_backward", "check_consistency", "simple_forward"]

_default_ctx = [None]


def default_context():
    return _default_ctx[0] or current_context()


def set_default_context(ctx):
    _default_ctx[0] = ctx


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    return np.allclose(_as_np(a), _as_np(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    """(parity: test_utils.assert_almost_equal:467)"""
    a, b = _as_np(a), _as_np(b)
    if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
        idx = np.unravel_index(np.argmax(np.abs(a - b)), a.shape) if a.shape \
            else ()
        raise AssertionError(
            "%s and %s differ: max abs err %g at %s (rtol=%g atol=%g)"
            % (names[0], names[1], float(np.max(np.abs(a - b))), idx, rtol,
               atol))


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_ndarray(shape, stype="default", density=None, dtype=np.float32,
                 ctx=None):
    """(parity: test_utils.rand_ndarray:336 — dense or sparse w/ density)"""
    ctx = ctx or default_context()
    if stype == "default":
        return nd_array(np.random.uniform(-1, 1, shape).astype(dtype),
                        ctx=ctx)
    density = 0.5 if density is None else density
    dense = np.random.uniform(-1, 1, shape).astype(dtype)
    mask = np.random.uniform(0, 1, shape) < density
    dense = dense * mask
    from .ndarray import sparse as sp
    if stype == "row_sparse":
        return sp.cast_storage(nd_array(dense, ctx=ctx), "row_sparse")
    if stype == "csr":
        return sp.cast_storage(nd_array(dense, ctx=ctx), "csr")
    raise MXNetError("unknown stype %r" % stype)


def random_arrays(*shapes):
    arrays = [np.random.randn(*s).astype(np.float32) for s in shapes]
    return arrays if len(arrays) > 1 else arrays[0]


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    ctx = ctx or default_context()
    ex = sym.bind(ctx=ctx, args={k: nd_array(v, ctx=ctx)
                                 for k, v in inputs.items()})
    outs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    return outs if len(outs) > 1 else outs[0]


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """Finite differences vs symbolic backward
    (parity: test_utils.check_numeric_gradient:789). Like the reference,
    the random projection is part of the graph (sum(out * proj) wrapped in
    MakeLoss) so loss-style ops with fixed backward semantics are handled
    uniformly."""
    from . import symbol as _sym
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    location = {k: np.asarray(v, np.float64).astype(np.float32)
                for k, v in location.items()}
    if grad_nodes is None:
        grad_nodes = arg_names

    if len(sym.list_outputs()) > 1:
        raise MXNetError("check_numeric_gradient expects single output")
    proj = _sym.Variable("__random_proj")
    loss = _sym.MakeLoss(_sym.sum(sym * proj))

    # shapes: forward once to get output shape for the projection
    probe = sym.bind(ctx=ctx, args={k: nd_array(v, ctx=ctx)
                                    for k, v in location.items()},
                     aux_states={k: nd_array(v, ctx=ctx) for k, v in
                                 (aux_states or {}).items()} or None)
    out_shape = probe.forward()[0].shape
    head = np.random.normal(0, 1, out_shape).astype(np.float32)
    location = dict(location)
    location["__random_proj"] = head

    args = {k: nd_array(v, ctx=ctx) for k, v in location.items()}
    grads = {k: nd_zeros(v.shape, ctx=ctx) for k, v in location.items()
             if k in grad_nodes}
    ex = loss.bind(ctx=ctx, args=args, args_grad=grads,
                   aux_states={k: nd_array(v, ctx=ctx) for k, v in
                               (aux_states or {}).items()} or None)
    ex.forward(is_train=True)
    ex.backward()
    sym_grads = {k: grads[k].asnumpy() for k in grads}

    def f(loc):
        ex2 = loss.bind(ctx=ctx, args={k: nd_array(v, ctx=ctx)
                                       for k, v in loc.items()},
                        aux_states={k: nd_array(v, ctx=ctx) for k, v in
                                    (aux_states or {}).items()} or None)
        o = ex2.forward(is_train=use_forward_train)[0].asnumpy()
        return float(np.sum(o))

    for name in grad_nodes:
        base = location[name]
        num_grad = np.zeros_like(base)
        flat = base.reshape(-1)
        ng_flat = num_grad.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps
            fp = f(location)
            flat[i] = orig - numeric_eps
            fm = f(location)
            flat[i] = orig
            ng_flat[i] = (fp - fm) / (2 * numeric_eps)
        assert_almost_equal(num_grad, sym_grads[name], rtol=rtol,
                            atol=atol if atol is not None else 1e-4,
                            names=("numeric_%s" % name, "symbolic_%s" % name))


def check_symbolic_forward(sym, location, expected, rtol=1e-5, atol=1e-20,
                           aux_states=None, ctx=None):
    """(parity: test_utils.check_symbolic_forward:921)"""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    args = {k: nd_array(v, ctx=ctx) for k, v in location.items()}
    ex = sym.bind(ctx=ctx, args=args,
                  aux_states={k: nd_array(v, ctx=ctx) for k, v in
                              (aux_states or {}).items()} or None)
    outputs = [o.asnumpy() for o in ex.forward()]
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out, exp, rtol=rtol, atol=atol)
    return outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=1e-20, aux_states=None, grad_req="write",
                            ctx=None):
    """(parity: test_utils.check_symbolic_backward)"""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(arg_names, expected))
    args = {k: nd_array(v, ctx=ctx) for k, v in location.items()}
    grads = {k: nd_zeros(np.asarray(v).shape, ctx=ctx)
             for k, v in location.items()}
    ex = sym.bind(ctx=ctx, args=args, args_grad=grads, grad_req=grad_req)
    ex.forward(is_train=True)
    ex.backward(out_grads=[nd_array(g, ctx=ctx) for g in out_grads])
    for name, exp in expected.items():
        assert_almost_equal(grads[name].asnumpy(), exp, rtol=rtol, atol=atol,
                            names=("grad_%s" % name, "expected_%s" % name))
    return {k: v.asnumpy() for k, v in grads.items()}


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, rtol=1e-3, atol=1e-4):
    """Run the same graph on several contexts and compare the outputs and
    gradients of each with the first's: the cross-backend oracle (parity:
    test_utils.check_consistency, which compares gpu with cpu; so does
    ``[mx.gpu(0), mx.cpu()]`` here). Each entry of ``ctx_list`` is a
    Context or a dict of ``ctx`` and the input shapes. The default
    tolerance is the reference's fp32 cross-backend one, 1e-3 relative
    (python/mxnet/test_utils.py:1267 ``tol[np.float32]``), with the JAX
    package's 1e-4 absolute."""
    if len(ctx_list) < 2:
        raise MXNetError("need at least two contexts")
    results = []
    np.random.seed(0)
    arg_shapes = None
    for spec in ctx_list:
        ctx = spec["ctx"] if isinstance(spec, dict) else spec
        shapes = {k: v for k, v in spec.items() if k != "ctx"} \
            if isinstance(spec, dict) else {}
        ex = sym.simple_bind(ctx=ctx, grad_req=grad_req, **shapes)
        if arg_shapes is None:
            arg_shapes = {k: a.shape for k, a in ex.arg_dict.items()}
            arg_params = arg_params or {
                k: np.random.normal(0, scale, s).astype(np.float32)
                for k, s in arg_shapes.items()}
        for k, v in arg_params.items():
            ex.arg_dict[k][:] = v
        outs = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward()
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
                 if g is not None}
        results.append((outs, grads))
    ref_outs, ref_grads = results[0]
    for outs, grads in results[1:]:
        for o, r in zip(outs, ref_outs):
            assert_almost_equal(o, r, rtol=rtol, atol=atol)
        for k in ref_grads:
            assert_almost_equal(grads[k], ref_grads[k], rtol=rtol, atol=atol)
    return results


# -- remaining reference test_utils surface (test_utils.py parity) ----------

def default_dtype():
    """(parity: test_utils.default_dtype)"""
    return np.float32


def get_atol(atol=None):
    """(parity: test_utils.get_atol)"""
    return 1e-20 if atol is None else atol


def get_rtol(rtol=None):
    """(parity: test_utils.get_rtol)"""
    return 1e-5 if rtol is None else rtol


def random_sample(population, k):
    """Sample k without replacement (parity: test_utils.random_sample)."""
    import random as _random
    population_copy = population[:]
    _random.shuffle(population_copy)
    return population_copy[0:k]


def shuffle_csr_column_indices(csr):
    """Shuffle indices within each row (parity: the reference helper —
    exercises unsorted-column-index handling)."""
    import random as _random
    row_count = len(csr.indptr) - 1
    col_indices = csr.indices.asnumpy().copy()
    for i in range(row_count):
        start = int(csr.indptr[i].asnumpy()) \
            if hasattr(csr.indptr[i], "asnumpy") else int(csr.indptr[i])
        end = int(csr.indptr[i + 1].asnumpy()) \
            if hasattr(csr.indptr[i + 1], "asnumpy") else int(csr.indptr[i + 1])
        sublist = col_indices[start:end].tolist()
        _random.shuffle(sublist)
        col_indices[start:end] = sublist
    from .ndarray import sparse as _sp
    return _sp.csr_matrix((csr.data.asnumpy(), col_indices,
                           csr.indptr.asnumpy()), shape=csr.shape,
                          ctx=csr.context)


def assign_each(the_input, function):
    """Apply function elementwise via numpy (parity: assign_each)."""
    out = np.vectorize(function)(_as_np(the_input)) \
        if function is not None else _as_np(the_input).copy()
    return np.asarray(out)


def assign_each2(input1, input2, function):
    """(parity: assign_each2)"""
    if function is None:
        return _as_np(input1).copy()
    return np.asarray(np.vectorize(function)(_as_np(input1),
                                             _as_np(input2)))


def rand_sparse_ndarray(shape, stype, density=None, dtype=np.float32,
                        **kwargs):
    """Random sparse NDArray + its dense view (parity:
    test_utils.rand_sparse_ndarray)."""
    arr = rand_ndarray(shape, stype=stype, density=density, dtype=dtype)
    dense = arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)
    return arr, dense


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=np.float32, modifier_func=None,
                        shuffle_csr_indices=False, density=0.5):
    """(parity: test_utils.create_sparse_array)"""
    from .ndarray import sparse as _sp
    dense = np.zeros(shape, dtype=dtype)
    if data_init is not None:
        dense[:] = data_init
    else:
        mask = np.random.uniform(size=shape) < density
        dense = (np.random.uniform(size=shape) * mask).astype(dtype)
    if rsp_indices is not None and stype == "row_sparse":
        keep = np.zeros(shape[0], bool)
        keep[np.asarray(rsp_indices, np.int64)] = True
        dense[~keep] = 0
    if modifier_func is not None:
        dense = np.vectorize(modifier_func)(dense).astype(dtype)
    ctx = default_context()
    if stype == "row_sparse":
        return _sp.row_sparse_array(dense, ctx=ctx)
    if stype == "csr":
        return _sp.csr_matrix(dense, ctx=ctx)
    from .ndarray import array as _arr
    return _arr(dense, ctx=ctx)


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=np.float32,
                           modifier_func=None, shuffle_csr_indices=False):
    """create_sparse_array allowing zero density (parity:
    test_utils.create_sparse_array_zd)."""
    if density == 0:
        shape = (max(shape[0], 1),) + tuple(shape[1:])
    return create_sparse_array(shape, stype, data_init=data_init,
                               rsp_indices=rsp_indices, dtype=dtype,
                               modifier_func=modifier_func,
                               density=density)


def rand_shape_nd(num_dim, dim=10):
    """(parity: test_utils.rand_shape_nd)"""
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """Reference-style reduce with axis/keepdims normalisation (parity:
    test_utils.np_reduce)."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def find_max_violation(a, b, rtol=None, atol=None):
    """Index/value of the worst |a-b| violation (parity:
    test_utils.find_max_violation)."""
    rtol = get_rtol(rtol)
    atol = get_atol(atol)
    a, b = _as_np(a), _as_np(b)
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff / (tol + 1e-20)
    loc = np.unravel_index(np.argmax(violation), violation.shape)
    return loc, float(violation[loc])


def same(a, b):
    """(parity: test_utils.same) exact array equality."""
    return np.array_equal(_as_np(a), _as_np(b))


def almost_equal_ignore_nan(a, b, rtol=None, atol=None):
    """(parity: test_utils.almost_equal_ignore_nan)"""
    a, b = _as_np(a).copy(), _as_np(b).copy()
    nan_mask = np.logical_or(np.isnan(a), np.isnan(b))
    a[nan_mask] = 0
    b[nan_mask] = 0
    return almost_equal(a, b, get_rtol(rtol), get_atol(atol))


def assert_almost_equal_ignore_nan(a, b, rtol=None, atol=None,
                                   names=("a", "b")):
    """(parity: test_utils.assert_almost_equal_ignore_nan)"""
    a, b = _as_np(a).copy(), _as_np(b).copy()
    nan_mask = np.logical_or(np.isnan(a), np.isnan(b))
    a[nan_mask] = 0
    b[nan_mask] = 0
    assert_almost_equal(a, b, get_rtol(rtol), get_atol(atol), names=names)


def assert_exception(f, exception_type, *args, **kwargs):
    """(parity: test_utils.assert_exception)"""
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("%s did not raise %s" % (f, exception_type))


def retry(n):
    """Decorator: retry a flaky (random) test n times (parity:
    test_utils.retry)."""
    assert n > 0

    def decorate(f):
        import functools

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return f(*args, **kwargs)
                except AssertionError as e:
                    if i == n - 1:
                        raise e
        return wrapper
    return decorate


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Finite-difference gradients of an executor's scalar-summed output
    (parity: test_utils.numeric_grad — the engine under
    check_numeric_gradient)."""
    approx_grads = {}
    for name, arr in location.items():
        base = np.asarray(arr, np.float64).copy()
        grad = np.zeros_like(base)
        flat = base.ravel()
        gflat = grad.ravel()
        for i in range(flat.size):
            old = flat[i]
            flat[i] = old + eps / 2
            executor.arg_dict[name][:] = base.reshape(arr.shape) \
                .astype(np.float32)
            f_plus = sum(float(o.asnumpy().sum())
                         for o in executor.forward(
                             is_train=use_forward_train))
            flat[i] = old - eps / 2
            executor.arg_dict[name][:] = base.reshape(arr.shape) \
                .astype(np.float32)
            f_minus = sum(float(o.asnumpy().sum())
                          for o in executor.forward(
                              is_train=use_forward_train))
            gflat[i] = (f_plus - f_minus) / eps
            flat[i] = old
        executor.arg_dict[name][:] = base.reshape(arr.shape) \
            .astype(np.float32)
        approx_grads[name] = grad
    return approx_grads


def check_speed(sym, location=None, ctx=None, N=20, grad_req=None,
                typ="whole", **kwargs):
    """Time forward(+backward) of a symbol (parity:
    test_utils.check_speed)."""
    import time as _time
    ctx = ctx or default_context()
    if grad_req is None:
        grad_req = "write"
    if location is None:
        location = {name: np.random.normal(size=shape, scale=1.0)
                    for name, shape in
                    zip(sym.list_arguments(),
                        sym.infer_shape(**kwargs)[0])}
    exe = sym.simple_bind(grad_req=grad_req, ctx=ctx,
                          **{k: v.shape for k, v in location.items()})
    for name, value in location.items():
        exe.arg_dict[name][:] = value
    exe.forward(is_train=True)       # materialise output shapes
    out_grads = [nd_array(np.random.normal(size=o.shape), ctx=ctx)
                 for o in exe.outputs]

    if typ == "whole":
        exe.forward(is_train=True)
        exe.backward(out_grads=out_grads)
        [o.asnumpy() for o in exe.outputs]
        tic = _time.time()
        for _ in range(N):
            exe.forward(is_train=True)
            exe.backward(out_grads=out_grads)
        [o.asnumpy() for o in exe.outputs]
        return (_time.time() - tic) / N
    if typ == "forward":
        exe.forward(is_train=False)
        [o.asnumpy() for o in exe.outputs]
        tic = _time.time()
        for _ in range(N):
            exe.forward(is_train=False)
        [o.asnumpy() for o in exe.outputs]
        return (_time.time() - tic) / N
    raise ValueError("typ must be 'whole' or 'forward'")


def list_gpus():
    """Indices of the visible CUDA devices (parity: test_utils.list_gpus)."""
    import torch
    return list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []


def download(url, fname=None, dirname=None, overwrite=False):
    """Download a file (parity: test_utils.download). Only ``file://`` URIs
    and existing local paths resolve: nothing is fetched over a network,
    as in the JAX package."""
    import os as _os
    import shutil as _shutil
    fname = fname or url.split("/")[-1]
    if dirname is not None:
        _os.makedirs(dirname, exist_ok=True)
        fname = _os.path.join(dirname, fname)
    if _os.path.exists(fname) and not overwrite:
        return fname
    if url.startswith("file://"):
        _shutil.copyfile(url[7:], fname)
        return fname
    if _os.path.exists(url):
        _shutil.copyfile(url, fname)
        return fname
    raise IOError("download: no network egress; provide a local path "
                  "(got %r)" % url)


def get_mnist(path=None):
    """MNIST as numpy dict (parity: test_utils.get_mnist). Reads the idx
    files from ``path`` (or MXTPU_MNIST_PATH); generates a deterministic
    synthetic stand-in when absent so tests stay hermetic."""
    import os as _os
    path = path or _os.environ.get("MXTPU_MNIST_PATH")
    if path and _os.path.exists(_os.path.join(path,
                                              "train-images-idx3-ubyte")):
        from .io import _read_idx_images, _read_idx_labels
        tr_i = _read_idx_images(_os.path.join(
            path, "train-images-idx3-ubyte")) / 255.0
        tr_l = _read_idx_labels(_os.path.join(
            path, "train-labels-idx1-ubyte"))
        te_i = _read_idx_images(_os.path.join(
            path, "t10k-images-idx3-ubyte")) / 255.0
        te_l = _read_idx_labels(_os.path.join(
            path, "t10k-labels-idx1-ubyte"))
    else:
        rs = np.random.RandomState(42)
        tr_i = rs.uniform(size=(512, 28, 28)).astype(np.float32)
        tr_l = rs.randint(0, 10, 512).astype(np.float32)
        te_i = rs.uniform(size=(128, 28, 28)).astype(np.float32)
        te_l = rs.randint(0, 10, 128).astype(np.float32)
    return {"train_data": tr_i.reshape(-1, 1, 28, 28),
            "train_label": tr_l,
            "test_data": te_i.reshape(-1, 1, 28, 28),
            "test_label": te_l}


def get_bz2_data(data_dir, data_name, url, data_origin_name):
    """(parity: test_utils.get_bz2_data) zero-egress: decompress a local
    .bz2 only."""
    import bz2 as _bz2
    import os as _os
    path = _os.path.join(data_dir, data_name)
    origin = _os.path.join(data_dir, data_origin_name)
    if not _os.path.exists(path):
        if not _os.path.exists(origin):
            raise IOError("get_bz2_data: no egress; place %s locally"
                          % data_origin_name)
        with _bz2.BZ2File(origin) as f, open(path, "wb") as out:
            out.write(f.read())
    return path


def set_env_var(key, val, default_val=""):
    """Set env var, returning its previous value (parity:
    test_utils.set_env_var)."""
    import os as _os
    prev_val = _os.environ.get(key, default_val)
    _os.environ[key] = val
    return prev_val


def same_array(array1, array2):
    """True when two NDArrays share storage (parity:
    test_utils.same_array — mutate-and-compare probe)."""
    array1[:] = array1.asnumpy() + 1
    if not same(array1.asnumpy(), array2.asnumpy()):
        array1[:] = array1.asnumpy() - 1
        return False
    array1[:] = array1.asnumpy() - 1
    return same(array1.asnumpy(), array2.asnumpy())


class discard_stderr:
    """Context manager silencing stderr (parity:
    test_utils.discard_stderr)."""

    def __enter__(self):
        import os as _os
        import sys as _sys
        self.stderr_fileno = _sys.stderr.fileno()
        self.old_stderr = _os.dup(self.stderr_fileno)
        self.bin_log_file = open(_os.devnull, "wb")
        _os.dup2(self.bin_log_file.fileno(), self.stderr_fileno)
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        import os as _os
        _os.dup2(self.old_stderr, self.stderr_fileno)
        self.bin_log_file.close()
        _os.close(self.old_stderr)
