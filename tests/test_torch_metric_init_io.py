"""The port's new metrics, initializers and ``CSVIter`` against the JAX
package's.

Metrics: the same (label, prediction) batches through both packages'
metrics, ``get()`` equal within 1e-6 relative (both reduce on the host
in numpy; CrossEntropy-based ones in fp32 on each package's device).
Initializers: the same arrays, bit-equal, from one ``np.random.seed``
(Orthogonal draws from numpy in both; Constant and Bilinear draw
nothing); Load and Mixed pass values through unchanged. ``CSVIter``:
the same batches from files the test writes.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()


def _batches(kind, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        if kind == "binary":
            label = rs.randint(0, 2, (8,)).astype(np.float32)
            pred = rs.uniform(0, 1, (8, 2)).astype(np.float32)
        elif kind == "class":
            label = rs.randint(0, 4, (8,)).astype(np.float32)
            pred = rs.dirichlet(np.ones(4), 8).astype(np.float32)
        else:
            label = rs.uniform(-1, 1, (8,)).astype(np.float32)
            pred = rs.uniform(-1, 1, (8, 1)).astype(np.float32)
        out.append((label, pred))
    return out


def _feval(label, pred):
    return float(np.abs(label.ravel() - pred.ravel()).sum()), \
        float(np.abs(label).sum())


def _pair_feval(label, pred):
    return (label.size, float((pred.ravel() > 0).sum()))


_METRICS = [
    ("f1", "binary", {}), ("mae", "reg", {}), ("mse", "reg", {}),
    ("rmse", "reg", {}), ("nll_loss", "class", {}),
    ("negativeloglikelihood", "class", {}), ("pearsonr", "reg", {}),
    ("pearsoncorrelation", "reg", {}), ("torch", "reg", {}),
    ("caffe", "reg", {}),
]


@pytest.mark.parametrize("name,kind,kw", _METRICS,
                         ids=[m[0] for m in _METRICS])
@pytest.mark.parametrize("as_nd", [False, True], ids=["numpy", "ndarray"])
def test_metric_matches_jax(name, kind, kw, as_nd):
    jm, tm = mx.metric.create(name, **kw), mt.metric.create(name, **kw)
    assert (tm.name, type(tm).__name__) == (jm.name, type(jm).__name__)
    for label, pred in _batches(kind):
        if as_nd:
            jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
            tm.update([mt.nd.array(label, ctx=CPU)],
                      [mt.nd.array(pred, ctx=CPU)])
        else:
            jm.update([label], [pred])
            tm.update([label], [pred])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert jn == tn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


@pytest.mark.parametrize("feval", [_feval, _pair_feval,
                                   lambda l, p: float(l.sum())],
                         ids=["sum_pair", "count_pair", "lambda"])
def test_custom_metric_and_np_match_jax(feval):
    for make in (lambda pkg: pkg.metric.CustomMetric(feval),
                 lambda pkg: pkg.metric.np(feval),
                 lambda pkg: pkg.metric.create(feval)):
        jm, tm = make(mx), make(mt)
        assert jm.name == tm.name
        for label, pred in _batches("reg"):
            jm.update([label], [pred])
            tm.update([mt.nd.array(label, ctx=CPU)],
                      [mt.nd.array(pred, ctx=CPU)])
        np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)


def test_f1_rejects_multiclass_labels():
    m = mt.metric.create("f1")
    with pytest.raises(mt.MXNetError, match="binary"):
        m.update([np.array([0, 1, 2])], [np.zeros((3, 3), np.float32)])


def _init_pair(make, shape, name="w_weight", seed=3):
    np.random.seed(seed)
    ja = mx.nd.zeros(shape)
    make(mx)(mx.init.InitDesc(name), ja)
    np.random.seed(seed)
    ta = mt.nd.zeros(shape, ctx=CPU)
    make(mt)(mt.init.InitDesc(name), ta)
    return ja.asnumpy(), ta.asnumpy()


_INITS = [
    ("constant", lambda pkg: pkg.init.Constant(0.37), (3, 4)),
    ("orthogonal_uniform", lambda pkg: pkg.init.Orthogonal(), (4, 6)),
    ("orthogonal_tall", lambda pkg: pkg.init.Orthogonal(scale=0.5),
     (6, 2, 2)),
    ("orthogonal_normal",
     lambda pkg: pkg.init.Orthogonal(rand_type="normal"), (5, 5)),
    ("bilinear_4", lambda pkg: pkg.init.Bilinear(), (3, 1, 4, 4)),
    ("bilinear_32", lambda pkg: pkg.init.Bilinear(), (21, 21, 32, 32)),
    ("bilinear_odd", lambda pkg: pkg.init.Bilinear(), (2, 1, 3, 5)),
    ("registry_constant", lambda pkg: pkg.initializer.create(
        "constant", value=-2.0), (2, 3)),
]


@pytest.mark.parametrize("make,shape", [(m, s) for _, m, s in _INITS],
                         ids=[i[0] for i in _INITS])
def test_initializer_bit_equal(make, shape):
    ja, ta = _init_pair(make, shape)
    np.testing.assert_array_equal(ta, ja)


def test_msra_prelu_is_gaussian_xavier():
    """MSRAPrelu draws as Xavier(gaussian, magnitude 2 / (1 + slope^2));
    the port's Xavier draws from a torch generator, so the two packages
    agree in distribution: the spread over a large array."""
    shape = (256, 128, 3, 3)
    ta = mt.nd.zeros(shape, ctx=CPU)
    mt.init.MSRAPrelu(slope=0.5)("c_weight", ta)
    ja = mx.nd.zeros(shape)
    mx.init.MSRAPrelu(slope=0.5)("c_weight", ja)
    fan = (128 * 9 + 256 * 9) / 2.0
    want = np.sqrt(2.0 / (1 + 0.25) / fan)
    for a in (ta.asnumpy(), ja.asnumpy()):
        assert abs(a.std() / want - 1) < 0.01
        assert abs(a.mean()) < 4 * want / np.sqrt(a.size)


def test_load_and_mixed_pass_values_through(tmp_path):
    rs = np.random.RandomState(4)
    w, b = rs.rand(3, 4).astype(np.float32), rs.rand(3).astype(np.float32)
    path = str(tmp_path / "p.params")
    mx.nd.save(path, {"arg:fc_weight": mx.nd.array(w),
                      "arg:fc_bias": mx.nd.array(b)})
    for pkg, ctx in ((mx, {}), (mt, {"ctx": CPU})):
        init = pkg.init.Mixed(
            ["fc_weight", ".*"],
            [pkg.init.Load(path), pkg.init.Constant(5.0)])
        wa, ba = pkg.nd.zeros((3, 4), **ctx), pkg.nd.zeros((3,), **ctx)
        init("fc_weight", wa)
        init("fc_bias", ba)
        np.testing.assert_array_equal(wa.asnumpy(), w)
        # Constant sets weights; a bias takes the default rule, zeros
        np.testing.assert_array_equal(ba.asnumpy(), np.zeros(3))
        loaded = pkg.init.Load({"arg:fc_bias": pkg.nd.array(b, **ctx)},
                               default_init=pkg.init.Constant(1.0))
        loaded("fc_bias", ba)
        loaded("other_weight", wa)
        np.testing.assert_array_equal(ba.asnumpy(), b)
        np.testing.assert_array_equal(wa.asnumpy(), np.ones((3, 4)))
    with pytest.raises(mt.MXNetError, match="shape mismatch"):
        mt.init.Load(path)("fc_weight", mt.nd.zeros((4, 3), ctx=CPU))
    with pytest.raises(mt.MXNetError, match="no pattern"):
        mt.init.Mixed(["a"], [mt.init.Zero()])("b", mt.nd.zeros((1,),
                                                                ctx=CPU))


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("label_shape", [(1,), (2,)])
def test_csv_iter_matches_jax(tmp_path, round_batch, label_shape):
    rs = np.random.RandomState(5)
    data = rs.rand(10, 6).astype(np.float32)
    label = rs.rand(10, label_shape[0]).astype(np.float32)
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    kw = dict(data_csv=dpath, data_shape=(2, 3), label_csv=lpath,
              label_shape=label_shape, batch_size=4,
              round_batch=round_batch)
    jit, tit = mx.io.CSVIter(**kw), mt.io.CSVIter(**kw)
    assert [tuple(d) for d in tit.provide_data] == \
        [tuple(d) for d in jit.provide_data]
    assert [tuple(d) for d in tit.provide_label] == \
        [tuple(d) for d in jit.provide_label]
    for _ in range(2):
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) == (3 if round_batch else 2)
        for j, t in zip(jb, tb):
            assert j.pad == t.pad
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
        jit.reset()
        tit.reset()
