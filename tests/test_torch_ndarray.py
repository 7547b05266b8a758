"""``mx.nd`` of the PyTorch port against the JAX package's: every ported
operator (elementwise, reduce, tensor, softmax) and NDArray's methods,
operators and indexing.

Each case feeds the same numpy inputs (the shapes and values of the
reference's ``tests/test_ndarray.py`` and ``tests/test_operator.py``)
to ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd`` (on the CPU) and compares
the outputs; for a differentiable op with float inputs, also the
gradient of ``sum(out * cotangent)`` with respect to every input, under
both packages' ``autograd.record``. One parametrised case per op.

Tolerances: float32 results within 1e-6 relative per element, plus
1e-6 of the largest magnitude for elements near zero (sums and
transcendental functions round in another order); integer and index
results exact.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()
RS = np.random.RandomState(0)


def _f(*shape, lo=-2.0, hi=2.0):
    return RS.uniform(lo, hi, shape).astype(np.float32)


def _i(*shape, lo=0, hi=4):
    return RS.randint(lo, hi, shape).astype(np.int32)


def _check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    else:
        np.testing.assert_array_equal(got, want)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _run(op, inputs, kwargs, grad):
    jin = [mx.nd.array(a, dtype=a.dtype) for a in inputs]
    tin = [mt.nd.array(a, ctx=CPU, dtype=a.dtype) for a in inputs]
    floats = [i for i, a in enumerate(inputs)
              if np.issubdtype(a.dtype, np.floating)]
    if grad:
        for i in floats:
            jin[i].attach_grad()
            tin[i].attach_grad()
    jfn, tfn = getattr(mx.nd, op), getattr(mt.nd, op)
    tkw = dict(kwargs, ctx=CPU) if not inputs else kwargs
    with mx.autograd.record():
        jout = _as_list(jfn(*jin, **kwargs))
        if grad:
            cots = [np.random.RandomState(7).uniform(
                0.5, 1.5, o.shape).astype(np.float32) for o in jout]
            jhead = sum(((o * mx.nd.array(c)).sum() for o, c in
                         zip(jout, cots)), mx.nd.zeros((1,)))
    with mt.autograd.record():
        tout = _as_list(tfn(*tin, **tkw))
        if grad:
            thead = sum(((o * mt.nd.array(c, ctx=CPU)).sum() for o, c in
                         zip(tout, cots)), mt.nd.zeros((1,), ctx=CPU))
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert t.dtype == j.dtype, (t.dtype, j.dtype)
        _check(t.asnumpy(), j.asnumpy())
    if grad and floats:
        jhead.backward()
        thead.backward()
        for i in floats:
            _check(tin[i].grad.asnumpy(), jin[i].grad.asnumpy())


# (op, inputs, kwargs, differentiable)
CASES = {}


def case(name, op, inputs, kwargs=None, grad=True):
    CASES[name] = (op, inputs, kwargs or {}, grad)


for _op in ("broadcast_add", "broadcast_sub", "broadcast_mul",
            "broadcast_div", "broadcast_maximum", "broadcast_minimum",
            "broadcast_hypot", "broadcast_plus", "broadcast_minus"):
    case(_op, _op, [_f(2, 3), _f(1, 3, lo=0.5)])
case("broadcast_mod", "broadcast_mod", [_f(2, 3), _f(1, 3, lo=0.5)],
     grad=False)
case("broadcast_power", "broadcast_power", [_f(2, 3, lo=0.5), _f(1, 3)])
for _op in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser",
            "broadcast_lesser_equal"):
    _a = _f(3, 4).round()
    case(_op, _op, [_a, _a[:1] * 0 + _a[1:2]], grad=False)
for _op in ("elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
            "_plus", "_minus", "_mul", "_div"):
    case(_op, _op, [_f(3, 2), _f(3, 2, lo=0.5)])
case("add_n", "add_n", [_f(2, 3), _f(2, 3), _f(2, 3)])
case("ElementWiseSum", "ElementWiseSum", [_f(4), _f(4)])
case("broadcast_add_int", "broadcast_add", [_i(2, 3), _i(1, 3)])

for _op in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
            "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_maximum_scalar",
            "_minimum_scalar", "_hypot_scalar", "_power_scalar",
            "_rpower_scalar"):
    case(_op, _op, [_f(2, 3, lo=0.5)], {"scalar": 1.5})
for _op in ("_mod_scalar", "_rmod_scalar"):
    case(_op, _op, [_f(2, 3, lo=0.5)], {"scalar": 1.5}, grad=False)
for _op in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
            "_greater_equal_scalar", "_lesser_scalar",
            "_lesser_equal_scalar"):
    case(_op, _op, [_f(3, 3).round()], {"scalar": 1.0}, grad=False)
case("_plus_scalar_int", "_plus_scalar", [_i(5)], {"scalar": 2.7})
case("_mul_scalar_int", "_mul_scalar", [_i(5)], {"scalar": 3})

_DOMAIN = {"sqrt": (0.2, 3), "rsqrt": (0.2, 3), "log": (0.2, 3),
           "log10": (0.2, 3), "log2": (0.2, 3), "log1p": (-0.5, 3),
           "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
           "arctanh": (-0.9, 0.9), "arccosh": (1.2, 3), "gamma": (0.3, 4),
           "gammaln": (0.3, 4), "reciprocal": (0.5, 3), "rcbrt": (0.5, 3),
           "cbrt": (-3, 3)}
_NO_GRAD = ("sign", "round", "rint", "ceil", "floor", "trunc", "fix",
            "logical_not")
for _op in ("abs", "sign", "round", "rint", "ceil", "floor", "trunc", "fix",
            "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "exp", "log",
            "log10", "log2", "log1p", "expm1", "sin", "cos", "tan", "arcsin",
            "arccos", "arctan", "degrees", "radians", "sinh", "cosh", "tanh",
            "arcsinh", "arccosh", "arctanh", "gamma", "gammaln", "erf",
            "negative", "reciprocal", "logical_not", "relu", "sigmoid",
            "softsign", "_copy", "BlockGrad", "make_loss", "zeros_like",
            "ones_like", "identity", "stop_gradient"):
    _lo, _hi = _DOMAIN.get(_op, (-2.0, 2.0))
    _x = _f(3, 4, lo=_lo, hi=_hi)
    if _op in ("round", "rint"):
        _x[0, :2] = [0.5, 1.5]          # ties round to even in both
    if _op == "logical_not":
        _x[0, 0] = 0.0
    case(_op, _op, [_x], grad=_op not in _NO_GRAD)
case("clip", "clip", [_f(3, 4)], {"a_min": -0.5, "a_max": 0.7})
case("Cast", "Cast", [_f(3, 4)], {"dtype": "float16"}, grad=False)
case("cast_int", "cast", [_f(3, 4)], {"dtype": "int32"}, grad=False)
case("smooth_l1", "smooth_l1", [_f(3, 4)], {"scalar": 1.5})

_R = _f(2, 3, 4)
for _op in ("sum", "mean", "prod", "nansum", "nanprod", "max", "min"):
    case(_op + "_all", _op, [_R])
    case(_op + "_axis1_keep", _op, [_R], {"axis": 1, "keepdims": True})
    case(_op + "_exclude", _op, [_R], {"axis": (0, 2), "exclude": True})
case("sum_axis", "sum_axis", [_R], {"axis": 2})
case("sum_int", "sum", [_i(3, 4)], {"axis": 0}, grad=False)
case("max_axis", "max_axis", [_R], {"axis": -1})
case("nansum_nan", "nansum", [np.array([[1.0, np.nan], [2.0, 3.0]],
                                       np.float32)], {"axis": 1}, grad=False)
case("norm", "norm", [_R])
case("argmax", "argmax", [_R], {"axis": 1}, grad=False)
case("argmax_keep", "argmax", [_R], {"axis": 2, "keepdims": True},
     grad=False)
case("argmin", "argmin", [_R], {"axis": 0}, grad=False)
case("argmax_channel", "argmax_channel", [_f(4, 5)], grad=False)
case("pick", "pick", [_f(3, 4), _i(3).astype(np.float32)], {"axis": -1})
case("pick_keep_axis0", "pick", [_f(3, 4), _i(4, hi=3).astype(np.float32)],
     {"axis": 0, "keepdims": True})
case("broadcast_to", "broadcast_to", [_f(1, 3)], {"shape": (4, 3)})
case("broadcast_to_zero", "broadcast_to", [_f(2, 1)], {"shape": (0, 5)})
case("broadcast_axis", "broadcast_axis", [_f(2, 1, 3)],
     {"axis": 1, "size": 4})
case("broadcast_axes", "broadcast_axes", [_f(1, 3)], {"axis": 0, "size": 2})
_S = np.array([[3.0, 1.0, 2.0, 1.0], [0.5, -1.0, 0.5, 4.0]], np.float32)
for _asc in (True, False):
    case("sort_%s" % _asc, "sort", [_S], {"is_ascend": _asc}, grad=False)
    case("argsort_%s" % _asc, "argsort", [_S], {"is_ascend": _asc},
         grad=False)
case("sort_axis0", "sort", [_S], {"axis": 0}, grad=False)
case("sort_flat", "sort", [_S], {"axis": None}, grad=False)
for _ret in ("indices", "value", "mask", "both"):
    case("topk_" + _ret, "topk", [_S], {"k": 2, "ret_typ": _ret},
         grad=False)
case("topk_ascend_axis0", "topk", [_S], {"k": 1, "axis": 0,
                                         "is_ascend": True}, grad=False)

_T = _f(2, 3, 4)
for _shape in ((4, 6), (0, -1), (-2,), (-3, 4), (2, -4, 1, 3, 4),
               (-1, 2, 2), (4, 0, -1)):
    case("Reshape_%s" % (_shape,), "Reshape", [_T], {"shape": _shape})
case("Reshape_reverse", "Reshape", [_f(10, 5, 4)],
     {"shape": (-1, 0), "reverse": True})
case("reshape", "reshape", [_T], {"shape": (6, 4)})
case("reshape_like", "reshape_like", [_f(2, 6), _f(3, 4)])
case("Flatten", "Flatten", [_T])
case("transpose", "transpose", [_T])
case("transpose_axes", "transpose", [_T], {"axes": (1, 0, 2)})
case("expand_dims", "expand_dims", [_T], {"axis": 1})
case("expand_dims_neg", "expand_dims", [_T], {"axis": -1})
case("squeeze", "squeeze", [_f(2, 1, 3, 1)])
case("squeeze_axis", "squeeze", [_f(2, 1, 3, 1)], {"axis": 1})
case("slice", "slice", [_T], {"begin": (0, 1), "end": (2, 3)})
case("slice_none", "slice", [_T], {"begin": (None, 1, 0),
                                   "end": (None, None, 3)})
case("slice_step", "slice", [_T], {"begin": (0, 0, 3), "end": (2, 3, 0),
                                   "step": (1, 2, -1)})
case("crop", "crop", [_T], {"begin": (1,), "end": (2,)})
case("slice_axis", "slice_axis", [_T], {"axis": 2, "begin": 1, "end": 3})
case("slice_axis_none", "slice_axis", [_T], {"axis": -1, "begin": 1,
                                             "end": None})
case("slice_like", "slice_like", [_T, _f(1, 2, 3)])
case("slice_like_axes", "slice_like", [_T, _f(1, 2, 3)], {"axes": (2,)})
case("Concat", "Concat", [_f(2, 3), _f(2, 2)], {"dim": 1})
case("concat_dim0", "concat", [_f(2, 3), _f(1, 3)], {"dim": 0})
case("stack", "stack", [_f(2, 3), _f(2, 3)], {"axis": 1})
case("SliceChannel", "SliceChannel", [_f(2, 6)], {"num_outputs": 3})
case("split_squeeze", "split", [_f(2, 3)], {"num_outputs": 2, "axis": 0,
                                            "squeeze_axis": True})
case("tile", "tile", [_f(2, 3)], {"reps": (2, 2)})
case("tile_longer", "tile", [_f(3)], {"reps": (2, 1, 2)})
case("repeat", "repeat", [_f(2, 3)], {"repeats": 2, "axis": 1})
case("repeat_flat", "repeat", [_f(2, 3)], {"repeats": 3})
case("reverse", "reverse", [_T], {"axis": 1})
case("flip", "flip", [_T], {"axis": (0, 2)})
case("SwapAxis", "SwapAxis", [_T], {"dim1": 0, "dim2": 2})
case("swapaxes", "swapaxes", [_T], {"dim1": 1, "dim2": 2})
for _mode in ("constant", "edge", "reflect"):
    case("Pad_" + _mode, "Pad", [_f(1, 2, 3, 4)],
         {"mode": _mode, "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
          "constant_value": 0.5})
case("where", "where", [(_f(3, 4) > 0).astype(np.float32), _f(3, 4),
                        _f(3, 4)])
case("where_rows", "where", [np.array([1.0, 0.0, 1.0], np.float32),
                             _f(3, 4), _f(3, 4)])
case("take", "take", [_f(5, 3), np.array([[0, 4], [2, 9]], np.float32)])
case("take_wrap_axis1", "take", [_f(5, 3),
                                 np.array([-1, 4], np.float32)],
     {"axis": 1, "mode": "wrap"})
case("batch_take", "batch_take", [_f(4, 3), np.array([0, 2, 1, 5],
                                                     np.float32)])
case("one_hot", "one_hot", [np.array([0, 2, 1, 7], np.float32)],
     {"depth": 4}, grad=False)
case("one_hot_values", "one_hot", [np.array([[1, 0], [3, -1]], np.int32)],
     {"depth": 4, "on_value": 2.0, "off_value": -1.0}, grad=False)
case("Embedding", "Embedding", [np.array([[0, 3], [1, 1]], np.float32),
                                _f(4, 5)], {"input_dim": 4, "output_dim": 5})
case("gather_nd", "gather_nd", [_f(3, 4, 2), np.array([[0, 2, 1], [3, 0, 1]],
                                                      np.float32)])
case("scatter_nd", "scatter_nd", [_f(3), np.array([[0, 2, 1], [3, 0, 1]],
                                                  np.float32)],
     {"shape": (3, 4)})
case("_zeros", "_zeros", [], {"shape": (2, 3)}, grad=False)
case("_ones", "_ones", [], {"shape": (2, 3), "dtype": "int32"}, grad=False)
case("_full", "_full", [], {"shape": (3,), "value": 2.5}, grad=False)
case("_arange", "_arange", [], {"start": 1, "stop": 7, "step": 1.5},
     grad=False)
case("_arange_repeat", "_arange", [], {"start": 4, "repeat": 2},
     grad=False)
case("_eye", "_eye", [], {"N": 3, "M": 4, "k": 1}, grad=False)
case("dot", "dot", [_f(3, 4), _f(4, 2)])
case("dot_trans", "dot", [_f(4, 3), _f(2, 4)], {"transpose_a": True,
                                                "transpose_b": True})
case("dot_vec", "dot", [_f(4), _f(4)])
case("dot_3d", "dot", [_f(2, 3, 4), _f(4, 5)])
case("batch_dot", "batch_dot", [_f(2, 3, 4), _f(2, 4, 5)])
case("batch_dot_trans", "batch_dot", [_f(2, 4, 3), _f(2, 5, 4)],
     {"transpose_a": True, "transpose_b": True})
case("softmax", "softmax", [_f(3, 5)])
case("softmax_axis0_temp", "softmax", [_f(3, 5)], {"axis": 0,
                                                  "temperature": 2.0})
case("log_softmax", "log_softmax", [_f(3, 5)])
case("log_softmax_axis1", "log_softmax", [_f(2, 3, 4)], {"axis": 1})


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    op, inputs, kwargs, grad = CASES[name]
    _run(op, inputs, kwargs, grad)


# ---------------------------------------------------------------------------
# NDArray methods, operators and indexing
# ---------------------------------------------------------------------------

_A = _f(2, 3, 4)
_B = _f(2, 3, 4, lo=0.5)
METHODS = {
    "add": lambda nd, a, b: a + b, "radd": lambda nd, a, b: 2.0 + a,
    "sub": lambda nd, a, b: a - b, "rsub": lambda nd, a, b: 1.0 - a,
    "mul": lambda nd, a, b: a * b, "rmul": lambda nd, a, b: 3 * a,
    "div": lambda nd, a, b: a / b, "rdiv": lambda nd, a, b: 2.0 / b,
    "mod": lambda nd, a, b: a % b, "rmod": lambda nd, a, b: 2.0 % b,
    "pow": lambda nd, a, b: b ** 2, "rpow": lambda nd, a, b: 2.0 ** a,
    "pow_nd": lambda nd, a, b: b ** a,
    "neg": lambda nd, a, b: -a, "abs": lambda nd, a, b: abs(a),
    "eq": lambda nd, a, b: a == a, "ne": lambda nd, a, b: a != b,
    "gt": lambda nd, a, b: a > b, "ge": lambda nd, a, b: a >= 0.5,
    "lt": lambda nd, a, b: a < 0, "le": lambda nd, a, b: a <= b,
    "iadd": lambda nd, a, b: _inplace(a, b, "__iadd__"),
    "isub": lambda nd, a, b: _inplace(a, 1.5, "__isub__"),
    "imul": lambda nd, a, b: _inplace(a, b, "__imul__"),
    "idiv": lambda nd, a, b: _inplace(a, b, "__itruediv__"),
    "reshape": lambda nd, a, b: a.reshape((6, 4)),
    "reshape_args": lambda nd, a, b: a.reshape(4, -1),
    "flatten": lambda nd, a, b: a.flatten(),
    "expand_dims": lambda nd, a, b: a.expand_dims(0),
    "squeeze": lambda nd, a, b: a[:1].squeeze(),
    "transpose": lambda nd, a, b: a.transpose((2, 0, 1)),
    "T": lambda nd, a, b: a.T,
    "swapaxes": lambda nd, a, b: a.swapaxes(0, 2),
    "broadcast_to": lambda nd, a, b: a[:, :1].broadcast_to((2, 5, 4)),
    "tile": lambda nd, a, b: a.tile((1, 2, 1)),
    "slice_axis": lambda nd, a, b: a.slice_axis(1, 0, 2),
    "sum": lambda nd, a, b: a.sum(), "sum_axis": lambda nd, a, b:
        a.sum(axis=1, keepdims=True),
    "mean": lambda nd, a, b: a.mean(axis=(0, 2)),
    "max": lambda nd, a, b: a.max(axis=0), "min": lambda nd, a, b: a.min(),
    "prod": lambda nd, a, b: b.prod(axis=2),
    "argmax": lambda nd, a, b: a.argmax(axis=1),
    "argmin": lambda nd, a, b: a.argmin(axis=2),
    "norm": lambda nd, a, b: a.norm(), "clip": lambda nd, a, b:
        a.clip(-1, 1),
    "astype": lambda nd, a, b: a.astype("float16"),
    "copy": lambda nd, a, b: a.copy(),
    "detach": lambda nd, a, b: a.detach(),
    "fluent_relu": lambda nd, a, b: a.relu(),
    "fluent_exp": lambda nd, a, b: a.exp(),
    "fluent_softmax": lambda nd, a, b: a.softmax(),
    "fluent_sqrt": lambda nd, a, b: b.sqrt(),
    "getitem_int": lambda nd, a, b: a[1],
    "getitem_neg": lambda nd, a, b: a[-1, 2],
    "getitem_slice": lambda nd, a, b: a[:, 1:3],
    "getitem_step": lambda nd, a, b: a[:, ::2, 1],
    "getitem_nd": lambda nd, a, b: a[nd.array(np.array([1, 0, 1],
                                                       np.int32),
                                              ctx=a.context)],
    "getitem_tuple_nd": lambda nd, a, b: a[0, nd.array(np.array(
        [2, 0], np.int32), ctx=a.context)],
    "setitem_scalar": lambda nd, a, b: _setitem(a, (0, 1), 5.0),
    "setitem_slice": lambda nd, a, b: _setitem(a, slice(0, 1), b[1:2]),
    "setitem_numpy": lambda nd, a, b: _setitem(a, 1, np.ones((3, 4),
                                                             np.float32)),
    "setitem_all": lambda nd, a, b: _setitem(a, slice(None), 2.0),
    "view_write_through": lambda nd, a, b: _view_write(a),
    "full": lambda nd, a, b: nd.full((2, 3), 1.5, ctx=a.context),
    "arange": lambda nd, a, b: nd.arange(2, 8, 2, ctx=a.context)
    if nd is mt.nd else nd.arange(2, 8, 2),
    "concatenate": lambda nd, a, b: nd.concatenate([a, b], axis=1),
    "moveaxis": lambda nd, a, b: nd.moveaxis(a, 0, 2),
    "module_transpose": lambda nd, a, b: nd.transpose(a, axes=(1, 2, 0)),
    "onehot_encode": lambda nd, a, b: nd.onehot_encode(
        nd.array(np.array([1, 3], np.float32), ctx=a.context),
        nd.zeros((2, 4), ctx=a.context)),
    "nd_add_scalar_left": lambda nd, a, b: nd.add(2.0, a),
    "nd_maximum": lambda nd, a, b: nd.maximum(a, 0.3),
    "nd_minimum_nd": lambda nd, a, b: nd.minimum(a, b),
    "nd_power": lambda nd, a, b: nd.power(b, 2.0),
    "nd_equal": lambda nd, a, b: nd.equal(a, a),
    "nd_lesser_equal": lambda nd, a, b: nd.lesser_equal(a, b),
}


def _inplace(a, other, method):
    view = a[0]
    getattr(a, method)(other)
    return [a, view]


def _setitem(a, key, value):
    a[key] = value
    return a


def _view_write(a):
    v = a[1:2]
    v[:] = 7.0
    return a


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_method_matches_jax(name):
    fn = METHODS[name]
    jout = _as_list(fn(mx.nd, mx.nd.array(_A), mx.nd.array(_B)))
    tout = _as_list(fn(mt.nd, mt.nd.array(_A, ctx=CPU),
                       mt.nd.array(_B, ctx=CPU)))
    for t, j in zip(tout, jout):
        assert t.dtype == j.dtype, (t.dtype, j.dtype)
        _check(t.asnumpy(), j.asnumpy())


def test_ndarray_properties_and_scalars():
    a, j = mt.nd.array(_A, ctx=CPU), mx.nd.array(_A)
    assert (a.size, a.ndim, a.shape, len(a), a.stype) == \
        (j.size, j.ndim, j.shape, len(j), j.stype)
    s, js = mt.nd.array([2.5], ctx=CPU), mx.nd.array([2.5])
    assert s.asscalar() == js.asscalar() == float(s) == 2.5
    assert int(s) == 2 and bool(s)
    with pytest.raises(mt.MXNetError):
        bool(a)
    with pytest.raises(mt.MXNetError):
        a.asscalar()
    np.testing.assert_array_equal(np.asarray(a), _A)
    assert [r.shape for r in a] == [r.shape for r in j]
    a.wait_to_read()
    mt.nd.waitall()
    assert a.copyto(CPU).context == CPU
    b = mt.nd.zeros(a.shape, ctx=CPU)
    a.copyto(b)
    np.testing.assert_array_equal(b.asnumpy(), _A)
    e = mt.nd.empty((2, 2), ctx=CPU)
    assert e.shape == (2, 2)


def test_ndarray_pickles():
    import pickle
    a = mt.nd.array(_A, ctx=CPU)
    b = pickle.loads(pickle.dumps(a))
    np.testing.assert_array_equal(b.asnumpy(), _A)
    assert b.context == CPU


def test_nd_and_sym_namespaces_match():
    """Every registered op is an ``mx.nd`` and an ``mx.sym`` function."""
    from mxnet_tpu_torch.ops import registry
    for name in registry.list_ops():
        assert callable(getattr(mt.nd, name)), name
        assert callable(getattr(mt.sym, name)), name


def test_out_argument():
    a = mt.nd.array(_A, ctx=CPU)
    out = mt.nd.zeros(a.shape, ctx=CPU)
    res = mt.nd.relu(a, out=out)
    assert res is out
    np.testing.assert_array_equal(out.asnumpy(), np.maximum(_A, 0))
