"""Sparse storage of the PyTorch port against the JAX package's
(``mx.nd.sparse``, ``cast_storage``, the sparse ``dot``, lazy optimizer
updates, the in-process stores' row-sparse push and pull,
``LibSVMIter``, ``mx.sym.sparse``), each case of ``tests/test_sparse.py``
as a parity case on the same numpy inputs.

Tolerances: values within 1e-6 (relative, atol 1e-7); indices, indptr
and storage types exact, in the JAX package's index dtype (int32, its
default without x64: the port keeps csr ``indptr`` int32 too); gradients
of ``dot`` under ``record`` within 1e-5; three lazy optimizer steps
within 1e-6, rows the gradients never touched bit-unchanged; the
linear classifier of ``examples/sparse/linear_classification.py`` at its
defaults (1000 features, batch 64), 3 batches from one LibSVM file and
zero weights, weight and bias within 1e-5 after each batch. The process
side (``dist_sync`` over gloo) is ``test_torch_sparse_dist.py``.
"""
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.ndarray import sparse as tsp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
RTOL, ATOL = 1e-6, 1e-7


def _nd(pkg, x, **kw):
    return pkg.nd.array(x, ctx=CPU, **kw) if pkg is mt \
        else pkg.nd.array(x, **kw)


def _sp(pkg):
    return tsp if pkg is mt else jsp


def _kw(pkg):
    return {"ctx": CPU} if pkg is mt else {}


def _rsp(pkg, arg, shape=None):
    return _sp(pkg).row_sparse_array(arg, shape=shape, **_kw(pkg))


def _csr(pkg, arg, shape=None):
    return _sp(pkg).csr_matrix(arg, shape=shape, **_kw(pkg))


def _host_dense(x):
    """The dense value of an array of either package, built on the host
    from its compressed fields (a row id stored twice: the last stored
    row wins), so no dense view of the JAX package's is compiled."""
    if x.stype == "default":
        return x.asnumpy()
    data, idx = x.data.asnumpy(), x.indices.asnumpy()
    out = np.zeros(x.shape, data.dtype)
    if x.stype == "csr":
        rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr.asnumpy()))
        out[rows, idx] = data
    else:
        for i, r in enumerate(idx):
            out[r] = data[i]
    return out


def _same(got, want, rtol=RTOL, atol=ATOL):
    """Two arrays of either package: storage type, shape, compressed
    fields (ids exact, values within rtol), and the port's dense view
    against the other's compressed fields."""
    assert got.stype == want.stype
    assert tuple(got.shape) == tuple(want.shape)
    fields = {"row_sparse": ("indices",), "csr": ("indices", "indptr"),
              "default": ()}[want.stype]
    for f in fields:
        g, w = getattr(got, f).asnumpy(), getattr(want, f).asnumpy()
        assert g.dtype == w.dtype, (f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)
    if want.stype != "default":
        np.testing.assert_allclose(got.data.asnumpy(), want.data.asnumpy(),
                                   rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.asnumpy(), _host_dense(want), rtol=rtol,
                               atol=atol)


def _both(fn):
    return fn(mt), fn(mx)


def _sparse_dense(rs, shape, density):
    return ((rs.rand(*shape) < density) * rs.randn(*shape)).astype(np.float32)


def _pair():
    """The two (7, 5) operands most cases share (one set of shapes, so
    the JAX package compiles its ops once for the file): empty first and
    last rows in A, a row of B that cancels A's, a zero inside a stored
    row."""
    rs = np.random.RandomState(11)
    a, b = _sparse_dense(rs, (7, 5), 0.45), _sparse_dense(rs, (7, 5), 0.45)
    a[0] = a[-1] = 0
    b[2] = -a[2]
    return a, b


_A, _B = _pair()


def _tall():
    """The (17, 9) csr operand of the ``dot`` and csr-invariant cases:
    ~60% zeros, an empty row 5."""
    d = np.random.RandomState(3).uniform(-1, 1, (17, 9)).astype(np.float32)
    d[d < 0.4] = 0
    d[5] = 0
    return d


_T = _tall()


# ---------------------------------------------------------------------------
# construction, round trips and cast_storage
# ---------------------------------------------------------------------------

def test_row_sparse_roundtrip():
    data = np.array([[1., 2.], [3., 4.]], np.float32)
    got, want = _both(lambda p: _rsp(p, (data, [1, 3]), (5, 2)))
    assert got.stype == "row_sparse"
    _same(got, want)
    dense = want.asnumpy()
    got, want = _both(lambda p: p.nd.sparse.cast_storage(_nd(p, dense),
                                                        "row_sparse"))
    _same(got, want)


def test_csr_roundtrip():
    dense = np.array([[0, 1, 0], [2, 0, 3], [0, 0, 0]], np.float32)
    got, want = _both(lambda p: _sp(p).cast_storage(_nd(p, dense), "csr"))
    _same(got, want)
    _same(got.tostype("row_sparse"), want.tostype("row_sparse"))
    _same(got.tostype("default"), want.tostype("default"))


@pytest.mark.parametrize("ids", [[2, 4, 5], "ndarray"])
def test_retain(ids):
    data = np.arange(12, dtype=np.float32).reshape(4, 3)

    def run(p):
        rsp = _rsp(p, (data, [1, 3, 5, 8]), (10, 3))
        keep = _nd(p, np.array([3, 8, 9], np.float32)) if ids == "ndarray" \
            else ids
        return rsp.retain(keep)
    got, want = _both(run)
    assert got._dense_cache is None
    _same(got, want)


def test_add_n_union_of_rows():
    def run(p):
        a = _rsp(p, (np.array([[1., 1.], [2., 2.]]), [0, 2]), (4, 2))
        b = _rsp(p, (np.array([[10., 10.], [20., 20.]]), [2, 3]), (4, 2))
        return _sp(p).add_n([a, b])
    got, want = _both(run)
    _same(got, want)
    np.testing.assert_array_equal(got.indices.asnumpy(), [0, 2, 3])


_DUP = (np.array([[1., 2.], [3., 4.], [5., 0.], [0., 0.]], np.float32),
        [3, 1, 3, 0])


def _source(p, kind):
    """Inputs of every storage type: with duplicate and unsorted row ids
    (a zero row among them), empty, and a zero inside a stored row."""
    if kind == "dense":
        return _nd(p, _A)
    if kind == "dense_empty":
        return _nd(p, np.zeros((4, 3), np.float32))
    if kind == "rsp_dup":
        return _rsp(p, _DUP, (5, 2))
    if kind == "rsp_unsorted":
        data = np.array([[0., 5., 0.], [1., 0., 2.], [0., 0., 0.]],
                        np.float32)
        return _rsp(p, (data, [4, 1, 2]), (6, 3))
    if kind == "rsp_empty":
        return _sp(p).zeros("row_sparse", (4, 3), **_kw(p))
    if kind == "csr":
        return _csr(p, _B)
    if kind == "csr_empty":
        return _sp(p).zeros("csr", (5, 7), **_kw(p))
    raise KeyError(kind)


@pytest.mark.parametrize("kind,stype", [
    ("dense", "row_sparse"), ("dense", "csr"),
    ("dense_empty", "row_sparse"), ("dense_empty", "csr"),
    ("rsp_dup", "default"), ("rsp_dup", "csr"),
    ("rsp_unsorted", "csr"), ("rsp_unsorted", "default"),
    ("rsp_empty", "csr"), ("rsp_empty", "default"),
    ("csr", "default"), ("csr", "row_sparse"),
    ("csr_empty", "row_sparse"), ("csr_empty", "default")])
def test_cast_storage_six_directions(kind, stype):
    """All six directions of cast_storage; duplicate row ids keep the last
    stored occurrence in the dense view and in the csr alike, and the
    sparse-to-sparse casts never build the dense view."""
    def run(p):
        src = _source(p, kind)
        return src, _sp(p).cast_storage(src, stype)
    (tsrc, got), (_, want) = _both(run)
    if tsrc.stype != "default" and stype != "default":
        assert tsrc._dense_cache is None and got._dense_cache is None
    _same(got, want)


def test_cast_storage_duplicate_rsp_rows_matches_dense_view():
    got = _rsp(mt, _DUP, (5, 2))
    np.testing.assert_array_equal(got.asnumpy()[3], [5., 0.])   # last wins
    np.testing.assert_array_equal(_rsp(mt, _DUP, (5, 2)).tostype("csr")
                                  .asnumpy(), got.asnumpy())


def test_csr_invariants_and_scipy():
    d = _T
    got, want = _both(lambda p: _csr(p, d))
    _same(got, want)
    ptr = got.indptr.asnumpy()
    assert ptr[0] == 0 and ptr[-1] == got.data.shape[0]
    sc = got.asscipy()
    np.testing.assert_array_equal(sc.toarray(), d)
    back = tsp.array(sc, ctx=CPU)
    _same(back, jsp.array(want.asscipy()))
    with pytest.raises(mt.MXNetError):
        tsp.array(d)


def test_sparse_constructors_need_a_card_or_the_cpu():
    """No silent fallback: without ``ctx=cpu()`` the constructors,
    ``LibSVMIter`` and a store's ``row_sparse_pull`` into a default-context
    array raise where no card is present."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(mt.MXNetError):
        tsp.zeros("row_sparse", (4, 2))
    with pytest.raises(mt.MXNetError):
        tsp.row_sparse_array((np.ones((1, 2)), [0]), shape=(4, 2))
    with pytest.raises(mt.MXNetError):
        tsp.csr_matrix(np.eye(3, dtype=np.float32))
    with pytest.raises(mt.MXNetError):
        mt.nd.zeros((4, 2)).tostype("csr")
    with pytest.raises(mt.MXNetError):
        mt.io.LibSVMIter(data_libsvm=os.devnull, data_shape=(4,))


# ---------------------------------------------------------------------------
# elementwise ops, sums and the storage dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["elemwise_add", "elemwise_sub",
                                "elemwise_mul"])
@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_elemwise_native(op, stype):
    """B's row 2 cancels A's: the sum stays stored."""
    def run(p):
        mk = _csr if stype == "csr" else _rsp
        a, b = mk(p, _A), mk(p, _B)
        return a, b, getattr(_sp(p), op)(a, b)
    (a, b, got), (_, _, want) = _both(run)
    assert a._dense_cache is None and b._dense_cache is None
    assert got._dense_cache is None
    _same(got, want)


@pytest.mark.parametrize("stype", ["csr", "row_sparse"])
def test_elemwise_dispatch_via_registered_ops(stype):
    fns = [lambda p, x, y: p.nd.elemwise_add(x, y),
           lambda p, x, y: p.nd.elemwise_sub(x, y),
           lambda p, x, y: p.nd.elemwise_mul(x, y),
           lambda p, x, y: x + y, lambda p, x, y: x - y,
           lambda p, x, y: x * y]
    for fn in fns:
        def run(p):
            mk = _csr if stype == "csr" else _rsp
            a, b = mk(p, _A), mk(p, _B)
            return a, fn(p, a, b)
        (a, got), (_, want) = _both(run)
        assert got.stype == stype
        _same(got, want)
        assert a._dense_cache is None


def test_mixed_storage_falls_back_dense():
    ad, bd = _A, np.random.RandomState(2).randn(7, 5).astype(np.float32)

    def run(p):
        return _sp(p).elemwise_add(_rsp(p, ad), _nd(p, bd)), \
            _sp(p).elemwise_mul(_csr(p, ad), _rsp(p, bd))
    (g1, g2), (w1, w2) = _both(run)
    _same(g1, w1)
    _same(g2, w2)
    assert g1.stype == g2.stype == "default"


@pytest.mark.parametrize("mk", ["csr", "row_sparse"])
def test_scalar_ops_preserve_stype(mk):
    ad = _B
    for fn, keeps in ((lambda x: x * 2.5, True), (lambda x: x / 2.0, True),
                      (lambda x: -x, True), (lambda x: x + 1.0, False)):
        def run(p):
            arr = (_csr if mk == "csr" else _rsp)(p, ad)
            return arr, fn(arr)
        (arr, got), (_, want) = _both(run)
        assert got.stype == (mk if keeps else "default")
        # f(0) != 0 reads the dense view (the fallback); the rest never
        assert (arr._dense_cache is None) == keeps
        _same(got, want)


@pytest.mark.parametrize("mk", ["csr", "row_sparse"])
def test_square_preserves_stype(mk):
    ad = _B

    def run(p):
        arr = (_csr if mk == "csr" else _rsp)(p, ad)
        return arr, p.nd.square(arr), _sp(p).square(arr)
    (arr, g1, g2), (_, w1, w2) = _both(run)
    _same(g1, w1)
    _same(g2, w2)
    assert g1.stype == mk and arr._dense_cache is None


@pytest.mark.parametrize("kwargs", [
    {"axis": 1, "keepdims": True}, {"axis": 1}, {"axis": 0},
    {"axis": 0, "keepdims": True}, {"axis": (1,), "keepdims": True}])
def test_square_sum_storage_table(kwargs):
    data = np.array([[1., 2.], [0., 3.]], np.float32)

    def run(p):
        rsp = _rsp(p, (data, [1, 4]), (6, 2))
        return _sp(p).square_sum(rsp, **kwargs), \
            p.nd._square_sum(rsp, **kwargs)
    (g1, g2), (w1, w2) = _both(run)
    _same(g1, w1)
    _same(g2, w2)


def test_square_sum_refuses_dense_and_bad_axes():
    rsp = _rsp(mt, (np.ones((1, 2), np.float32), [1]), (3, 2))
    with pytest.raises(mt.MXNetError):
        mt.nd._square_sum(_nd(mt, np.ones((3, 2))))
    with pytest.raises(mt.MXNetError):
        tsp.square_sum(rsp, axis=(0, 1))
    with pytest.raises(mt.MXNetError):
        tsp.square_sum(rsp, axis=2)
    with pytest.raises(mx.MXNetError):
        mx.nd._square_sum(mx.nd.array(np.ones((3, 2))))


@pytest.mark.parametrize("kwargs", [
    {"axis": 1}, {"axis": 0}, {"axis": 1, "keepdims": True},
    {"axis": 0, "keepdims": True}, {}])
def test_sum_csr_axis_native(kwargs):
    ad = _A

    def run(p):
        c = _csr(p, ad)
        return c, p.nd.sum(c, **kwargs), _sp(p).sum(c, **kwargs)
    (c, g1, g2), (_, w1, w2) = _both(run)
    _same(g1, w1, rtol=1e-5)
    _same(g2, w2, rtol=1e-5)
    if kwargs:
        assert c._dense_cache is None


@pytest.mark.parametrize("seed", [0])
def test_kernels_randomised_midscale(seed):
    """Awkward shapes: csr and rsp chains against the JAX package."""
    rs = np.random.RandomState(seed)
    a, b = _sparse_dense(rs, (513, 257), 0.05), \
        _sparse_dense(rs, (513, 257), 0.05)

    def run(p):
        ca, cb = _sp(p).cast_storage(_nd(p, a), "csr"), \
            _sp(p).cast_storage(_nd(p, b), "csr")
        ra = ca.tostype("row_sparse")
        return [p.nd.elemwise_add(ca, cb), p.nd.elemwise_mul(ca, cb), ra,
                ra.tostype("csr"), _sp(p).square_sum(ra, axis=1,
                                                      keepdims=True),
                ra.retain(np.arange(0, 513, 7))]
    for g, w in zip(*_both(run)):
        _same(g, w, rtol=1e-5)


def _same_compressed(got, want, rtol=RTOL, atol=ATOL):
    """``_same`` without any dense view (the arrays at scale)."""
    assert got.stype == want.stype and got.shape == want.shape
    for f in ("indices", "indptr") if want.stype == "csr" else ("indices",):
        np.testing.assert_array_equal(getattr(got, f).asnumpy(),
                                      getattr(want, f).asnumpy(), err_msg=f)
    np.testing.assert_allclose(got.data.asnumpy(), want.data.asnumpy(),
                               rtol=rtol, atol=atol)


def test_sparse_chains_at_scale_never_densify():
    """The embedding-scale cases (1,000,000 × 512, 1024 stored rows or
    2048 stored values): ``add_n``, ``retain``, rsp → csr → rsp, the
    elementwise and scalar ops, ``square``, ``square_sum`` and csr + csr
    against the JAX package's compressed results; no array builds its
    2 GB dense view."""
    nrows, ncols, nnz = 1_000_000, 512, 1024
    rs = np.random.RandomState(16)
    rows = np.unique(rs.randint(0, nrows, nnz * 2))[:nnz].astype(np.int64)
    vals = rs.randn(len(rows), ncols).astype(np.float32)
    crow = np.sort(rs.choice(nrows, 2048, replace=False))
    ccol = rs.randint(0, ncols, 2048)
    cptr = np.concatenate([[0], np.cumsum(np.bincount(crow,
                                                      minlength=nrows))])
    cval = rs.randn(2048).astype(np.float32)

    def run(p):
        sp, kw = _sp(p), _kw(p)
        g1 = sp.row_sparse_array((vals, rows), shape=(nrows, ncols), **kw)
        g2 = sp.row_sparse_array((vals * 2.0, rows), shape=(nrows, ncols),
                                 **kw)
        s = sp.add_n([g1, g2])
        c1 = sp.csr_matrix((cval, ccol, cptr), shape=(nrows, ncols), **kw)
        c2 = sp.csr_matrix((cval * 2.0, ccol, cptr), shape=(nrows, ncols),
                           **kw)
        csr = s.tostype("csr")
        outs = [s, s.retain(rows[:16].tolist()), csr,
                csr.tostype("row_sparse"), sp.elemwise_sub(g1, g2),
                sp.elemwise_mul(g1, g2), g1 * 0.5, p.nd.square(g1),
                sp.square_sum(g1, axis=1, keepdims=True),
                sp.elemwise_add(c1, c2)]
        return [g1, g2, c1, c2] + outs
    got, want = _both(run)
    assert all(a._dense_cache is None for a in got)
    for g, w in zip(got[4:], want[4:]):
        _same_compressed(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_native(transpose_a):
    dense = _T
    rhs = np.random.RandomState(4).uniform(
        -1, 1, (17 if transpose_a else 9, 4)).astype(np.float32)

    def run(p):
        c = _csr(p, dense)
        return c, _sp(p).dot(c, _nd(p, rhs), transpose_a=transpose_a)
    (c, got), (_, want) = _both(run)
    assert got.stype == "default" and c._dense_cache is None
    _same(got, want)
    ref = (dense.T if transpose_a else dense).astype(np.float64) @ rhs
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=1e-5, atol=1e-6)


def test_csr_dot_shapes():
    """An empty matrix, the registered ``dot`` (a dense fallback), a
    vector rhs (fallback), and the inner-dimension mismatch that raises."""
    e, je = _both(lambda p: _sp(p).dot(_sp(p).zeros("csr", (5, 7),
                                                    **_kw(p)),
                                       _nd(p, np.ones((7, 2)))))
    _same(e, je)
    dense = np.eye(4, 6, dtype=np.float32) * 2
    v = np.arange(6, dtype=np.float32)
    g, w = _both(lambda p: _sp(p).dot(_csr(p, dense), _nd(p, v)))
    _same(g, w)
    g, w = _both(lambda p: p.nd.dot(_csr(p, dense), _nd(p, np.ones((6, 3)))))
    _same(g, w)
    for pkg in (mt, mx):
        csr = _csr(pkg, dense)
        with pytest.raises(pkg.MXNetError):
            _sp(pkg).dot(csr, _nd(pkg, np.ones((5, 2), np.float32)))
        with pytest.raises(pkg.MXNetError):
            _sp(pkg).dot(csr, _nd(pkg, np.ones((6, 2), np.float32)),
                         transpose_a=True)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_backward_native(transpose_a):
    """Under ``record`` the gradient reaches the dense rhs only, within
    1e-5 of the JAX package's, and the csr lhs is never densified."""
    lhs = _T
    w0 = np.random.RandomState(4).uniform(
        -1, 1, (17 if transpose_a else 9, 4)).astype(np.float32)

    def run(p):
        csr = _sp(p).cast_storage(_nd(p, lhs), "csr")
        csr._dense_cache = None
        w = _nd(p, w0)
        w.attach_grad()
        with p.autograd.record():
            out = _sp(p).dot(csr, w, transpose_a=transpose_a)
            loss = (out * out).sum()
        loss.backward()
        return csr, w.grad.asnumpy()
    (csr, got), (_, want) = _both(run)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    a = lhs.T if transpose_a else lhs
    np.testing.assert_allclose(got, 2.0 * a.T @ (a @ w0), rtol=1e-5,
                               atol=1e-5)
    assert csr._dense_cache is None


# ---------------------------------------------------------------------------
# lazy optimizer updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,dtype", [
    ("sgd", {}, "float32"),
    ("sgd", {"momentum": 0.9, "wd": 0.01}, "float32"),
    ("sgd", {"momentum": 0.9, "multi_precision": True}, "float16"),
    ("adam", {"wd": 0.01}, "float32"),
    ("adagrad", {"wd": 0.01}, "float32")])
def test_lazy_update_three_steps(name, kw, dtype):
    """Three lazy steps against the JAX package's: weights within 1e-6,
    rows no gradient touched bit-unchanged, states too."""
    rs = np.random.RandomState(0)
    w0 = rs.randn(12, 3).astype(np.float32)
    steps = [(np.sort(rs.choice(10, 4, replace=False)),
              rs.randn(4, 3).astype(np.float32)) for _ in range(3)]

    def run(p):
        opt = p.optimizer.create(name, learning_rate=0.1, rescale_grad=0.5,
                                 clip_gradient=0.8, **kw)
        w = _nd(p, w0, dtype=dtype)
        st = opt.create_state_multi_precision(0, w)
        out = []
        for rows, g in steps:
            opt.update_multi_precision(0, w, _rsp(p, (g, rows), (12, 3)),
                                       st)
            out.append(w.asnumpy())
        return out, st
    (got, gst), (want, _) = _both(run)
    touched = np.unique(np.concatenate([r for r, _ in steps]))
    untouched = np.setdiff1d(np.arange(12), touched)
    w_start = w0.astype(dtype).astype(np.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(g[untouched], w_start[untouched])
    assert not np.array_equal(got[-1][touched], w_start[touched])
    # states: momentum, moments and history start at zero, an fp32 master
    # at the weight; their untouched rows keep that
    flat = list(gst) if isinstance(gst, tuple) else [gst]
    if kw.get("multi_precision"):
        flat, master = [flat[0]], flat[1]
        np.testing.assert_array_equal(master.asnumpy()[untouched],
                                      w_start[untouched])
    for st in flat:
        if st is not None:
            np.testing.assert_array_equal(st.asnumpy()[untouched], 0)


def test_sgd_lazy_exact_values():
    opt = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    w = _nd(mt, np.ones((5, 3), np.float32))
    st = opt.create_state(0, w)
    opt.update(0, w, _rsp(mt, (np.full((2, 3), 0.5, np.float32), [1, 3]),
                          (5, 3)), st)
    np.testing.assert_allclose(w.asnumpy()[[1, 3]], 0.95, rtol=1e-6)
    np.testing.assert_array_equal(w.asnumpy()[[0, 2, 4]], 1.0)


def test_fused_updater_takes_the_lazy_path():
    """``FusedUpdater.update_batch`` with a row_sparse gradient goes
    parameter by parameter and equals a direct lazy update."""
    w0 = np.random.RandomState(1).randn(6, 2).astype(np.float32)
    g = _rsp(mt, (np.ones((2, 2), np.float32), [0, 4]), (6, 2))
    a, b = _nd(mt, w0), _nd(mt, w0)
    up = mt.optimizer.get_updater(mt.optimizer.create("sgd", momentum=0.9))
    up.update_batch([0], [g], [a])
    opt = mt.optimizer.create("sgd", momentum=0.9)
    opt.update(0, b, g, opt.create_state(0, b))
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


# ---------------------------------------------------------------------------
# the stores, in process
# ---------------------------------------------------------------------------

def test_kvstore_row_sparse_push_pull():
    def run(p):
        kv = p.kv.create("device")
        kv.init("emb", _nd(p, np.zeros((6, 2))))
        g1 = _rsp(p, (np.ones((2, 2), np.float32), [0, 2]), (6, 2))
        g2 = _rsp(p, (np.full((1, 2), 3.0, np.float32), [2]), (6, 2))
        kv.push("emb", [g1, g2])
        out = _sp(p).zeros("row_sparse", (6, 2), **_kw(p))
        kv.row_sparse_pull("emb", out=out, row_ids=_nd(p, [0, 2]))
        dense = _nd(p, np.zeros((6, 2)))
        kv.row_sparse_pull("emb", out=dense, row_ids=_nd(p, [2, 5]))
        return kv._store["emb"], out, dense
    for g, w in zip(*_both(run)):
        _same(g, w)


def test_sparse_grad_stays_sparse_through_kvstore():
    def run(p):
        kv = p.kv.create("local")
        kv.init(0, _nd(p, np.zeros((4, 2))))
        g = _rsp(p, (np.ones((1, 2), np.float32), [1]), (4, 2))
        kv.push(0, [g, g])
        out = _sp(p).zeros("row_sparse", (4, 2), **_kw(p))
        kv.row_sparse_pull(0, out=out, row_ids=_nd(p, [0, 1, 3]))
        return kv._store[0], out
    (g, go), (w, wo) = _both(run)
    assert isinstance(g, tsp.RowSparseNDArray) and g._dense_cache is None
    _same(g, w)
    _same(go, wo)


def test_kvstore_mixed_sparse_dense_push(monkeypatch, caplog):
    """A shard list mixing storage types is summed dense, every
    contribution kept, and the fallback is logged under
    ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``."""
    monkeypatch.setenv("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", "1")
    from mxnet_tpu_torch import config
    monkeypatch.setattr(config, "_fallback_logged", set())

    def run(p):
        kv = p.kv.create("local")
        kv.init(0, _nd(p, np.zeros((4, 2))))
        rsp = _rsp(p, (np.ones((1, 2), np.float32), [1]), (4, 2))
        kv.push(0, [rsp, _nd(p, np.ones((4, 2)))])
        out = _nd(p, np.zeros((4, 2)))
        kv.pull(0, out=out)
        return out
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch"):
        got = run(mt)
    assert "storage fallback: kvstore push of [row_sparse, default] " \
           "shards" in caplog.text
    _same(got, run(mx))


@pytest.mark.parametrize("kv_type", ["local", "dist_sync"])
def test_compression_rejects_sparse(kv_type):
    for pkg in (mt, mx):
        kv = pkg.kv.create(kv_type)
        kv.set_gradient_compression({"type": "2bit"})
        kv.init(0, _nd(pkg, np.zeros((4, 2))))
        rsp = _rsp(pkg, (np.ones((1, 2), np.float32), [1]), (4, 2))
        with pytest.raises(pkg.MXNetError, match="compression"):
            kv.push(0, [rsp])


@pytest.mark.parametrize("opt", ["sgd", "adam", "adagrad"])
def test_lazy_update_inside_the_store(opt):
    """``set_optimizer`` on a ``device`` store: a row_sparse push (two
    shards) updates only the touched rows, as the JAX package's store."""
    rs = np.random.RandomState(7)
    w0 = rs.randn(8, 3).astype(np.float32)
    pushes = [[(rs.randn(2, 3).astype(np.float32), [1, 5]),
               (rs.randn(3, 3).astype(np.float32), [5, 6, 0])]
              for _ in range(3)]

    def run(p):
        kv = p.kv.create("device")
        kv.init(3, _nd(p, w0))
        kv.set_optimizer(p.optimizer.create(opt, learning_rate=0.1,
                                            momentum=0.9) if opt == "sgd"
                         else p.optimizer.create(opt, learning_rate=0.1))
        out = []
        for shards in pushes:
            kv.push(3, [_rsp(p, s, (8, 3)) for s in shards])
            got = _nd(p, np.zeros((8, 3)))
            kv.pull(3, out=got)
            out.append(got.asnumpy())
        return out
    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(g[[2, 3, 4, 7]], w0[[2, 3, 4, 7]])


# ---------------------------------------------------------------------------
# LibSVMIter
# ---------------------------------------------------------------------------

def _libsvm(path, rows=37, features=50, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(rows):
            idx = rng.choice(features, 5, replace=False)
            f.write("%g %s\n" % (i % 2, " ".join(
                "%d:%.4f" % (k, rng.randn()) for k in idx)))
        # a repeated feature (the last value wins), explicit zeros, a
        # negative index (from the end, as numpy indexes)
        f.write("1 3:0 3:2.5 7:0.0 -1:1.5\n")
    return str(path)


@pytest.mark.parametrize("parts,index", [(1, 0), (2, 0), (2, 1)])
def test_libsvm_iter_matches_the_jax_iterator(tmp_path, parts, index):
    path = _libsvm(tmp_path / "d.libsvm")
    a = mx.io.LibSVMIter(data_libsvm=path, data_shape=(50,), batch_size=8,
                         num_parts=parts, part_index=index)
    b = mt.io.LibSVMIter(data_libsvm=path, data_shape=(50,), batch_size=8,
                         num_parts=parts, part_index=index, ctx=CPU)
    assert b.provide_data == a.provide_data
    assert b.provide_label == a.provide_label
    for _ in range(2):
        a.reset()
        b.reset()
        n = 0
        for ba, bb in zip(a, b):
            _same(bb.data[0], ba.data[0])
            _same(bb.label[0], ba.label[0])
            assert bb.pad == ba.pad
            n += 1
        assert n == -(-a.num_data // 8) and b.num_data == a.num_data


# ---------------------------------------------------------------------------
# the slice as a whole: examples/sparse/linear_classification.py
# ---------------------------------------------------------------------------

def _example():
    spec = importlib.util.spec_from_file_location(
        "sparse_linear_classification",
        os.path.join(ROOT, "examples", "sparse", "linear_classification.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _linear_classification(p, path, features=1000, batch=64, batches=3):
    """The example's loop (its defaults: 1000 features, batch 64, lr 0.5,
    a ``device`` store with SGD inside), the store's weight and the bias
    after each batch."""
    kw = _kw(p)
    sp = _sp(p)
    train = p.io.LibSVMIter(data_libsvm=path, data_shape=(features,),
                            batch_size=batch, **kw)
    kv = p.kv.create("device")
    weight = p.nd.zeros((features, 2), **kw)
    bias = p.nd.zeros((2,), **kw)
    kv.init("weight", weight)
    opt = p.optimizer.create("sgd", learning_rate=0.5,
                             rescale_grad=1.0 / batch)
    kv.set_optimizer(opt)
    b_state = opt.create_state(1, bias)
    metric = p.metric.Accuracy()
    out = []
    for i, b in enumerate(train):
        if i == batches:
            break
        x, y = b.data[0], b.label[0]
        row_ids = p.nd.array(np.unique(x.indices.asnumpy()), dtype="int32",
                             **kw)
        w_rsp = sp.zeros("row_sparse", weight.shape, **kw)
        kv.row_sparse_pull("weight", out=w_rsp, row_ids=row_ids)
        w_dense = w_rsp.tostype("default")
        w_dense.attach_grad()
        bias.attach_grad()
        with p.autograd.record():
            pred = sp.dot(x, w_dense) + bias
            loss = p.nd.softmax_cross_entropy(pred, y)
        loss.backward()
        grad = sp.cast_storage(w_dense.grad, "row_sparse")
        kv.push("weight", grad)
        opt.update(1, bias, bias.grad, b_state)
        metric.update([y], [p.nd.softmax(pred)])
        full = p.nd.zeros((features, 2), **kw)
        kv.pull("weight", out=full)
        out.append((full.asnumpy(), bias.asnumpy(), grad, x))
    return out, metric.get()[1]


def test_linear_classification_slice(tmp_path):
    path = str(tmp_path / "train.libsvm")
    _example().write_synthetic_libsvm(path, num_features=1000)
    (got, acc), (want, jacc) = _both(
        lambda p: _linear_classification(p, path))
    assert len(got) == 3
    for (gw, gb, gg, gx), (ww, wb, wg, _) in zip(got, want):
        np.testing.assert_allclose(gw, ww, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-5)
        _same(gg, wg, rtol=1e-5, atol=1e-6)
        assert gx._dense_cache is None      # the batch stayed compressed
    assert acc == jacc


# ---------------------------------------------------------------------------
# the symbolic namespace, the embedding alias, carried weights
# ---------------------------------------------------------------------------

def test_sym_sparse_namespace():
    names = sorted(n for n in dir(mx.sym.sparse) if not n.startswith("_")
                   and callable(getattr(mx.sym.sparse, n)))
    assert names and all(hasattr(mt.sym.sparse, n) for n in names)
    for pkg in (mt, mx):
        a, b = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        s = pkg.sym.sparse.elemwise_add(pkg.sym.sparse.dot(a, b), b)
        assert s.list_arguments() == ["a", "b"]
    t = mt.sym.sparse.dot(mt.sym.Variable("a"), mt.sym.Variable("b"))
    ex = t.bind(CPU, {"a": _nd(mt, np.eye(3)), "b": _nd(mt, np.ones((3, 2)))})
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), np.ones((3, 2)))


def test_sparse_embedding_alias():
    idx = np.array([[0, 3], [2, 1]], np.float32)
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    got, want = _both(lambda p: p.nd._contrib_SparseEmbedding(
        _nd(p, idx), _nd(p, w), input_dim=4, output_dim=3,
        sparse_grad=True))
    _same(got, want)
    assert mt.ops.registry.get_op("_contrib_SparseEmbedding") is \
        mt.ops.registry.get_op("Embedding")


def test_weights_carry_sparse_values():
    r = jsp.row_sparse_array((np.ones((2, 3), np.float32), [1, 4]),
                             shape=(6, 3))
    c = jsp.csr_matrix(np.eye(3, 5, dtype=np.float32))
    got = mt.weights.params_from_numpy(
        {"r": r, "c": c, "t": ((r.data.asnumpy(), r.indices.asnumpy()),
                               r.shape)}, ctx=CPU)
    _same(got["arg:r"], r)
    _same(got["arg:c"], c)
    _same(got["arg:t"], r)
    tree = mt.weights.tree_from_numpy({"c": c}, ctx=CPU)
    _same(tree["c"], c)
    with pytest.raises(mt.MXNetError):
        mt.weights.sparse_from_numpy(np.ones(3))
