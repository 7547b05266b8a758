"""Symbol, shape inference, export and naming of the PyTorch port against
the JAX package.

A graph the JAX package exports loads in the port with the same
arguments, auxiliary states and inferred shapes; the same Gluon model
built in both packages exports the same JSON nodes and the same
parameter names and shapes, so weights carry across by name. The graph
surface (``get_internals`` and name lookup on it, ``get_children``,
``attr``/``list_attr``, ``list_inputs``, ``infer_type``, ``debug_str``,
copies, ``eval``) gives what the JAX package's gives, and
``examples/image-classification/fine_tune.py``'s protocol at its own
12x12 size keeps the frozen weights bit-equal and the new head within
1e-6 of JAX's.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mj
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet

HW = 32


@pytest.fixture
def nhwc_fused(monkeypatch):
    """Both packages build channels-last with fused block tails; the
    process-wide layout default is restored afterwards."""
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    mj.layout.set_default_layout("NHWC")
    mt.layout.set_default_layout("NHWC")
    yield
    mj.layout.set_default_layout(None)
    mt.layout.set_default_layout(None)


def _small(pkg, resnet, **kw):
    with pkg.name.NameManager():
        return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                               [16, 32, 64, 128, 256], classes=10, **kw)


def _export_jax(tmp_path):
    net = _small(mj, jresnet)
    net.initialize(mj.init.Xavier())
    net(mj.nd.zeros((1, HW, HW, 3)))
    with mj.name.NameManager():
        net.export(str(tmp_path / "jax"))
    return str(tmp_path / "jax")


def _export_port(tmp_path):
    net = _small(mt, tresnet)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    net(mt.nd.zeros((1, HW, HW, 3), ctx=mt.cpu()))
    with mt.name.NameManager():
        net.export(str(tmp_path / "port"))
    return str(tmp_path / "port")


def test_port_loads_jax_graph(nhwc_fused, tmp_path):
    path = _export_jax(tmp_path)
    jsym = mj.sym.load(path + "-symbol.json")
    tsym = mt.sym.load(path + "-symbol.json")
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert tsym.list_outputs() == jsym.list_outputs()
    for shape in [(2, HW, HW, 3), (5, HW, HW, 3)]:
        assert tsym.infer_shape_partial(data=shape) == \
            jsym.infer_shape_partial(data=shape)
    fused = [n for n in tsym._topo_nodes()
             if n.op is not None and n.op.name == "_contrib_BatchNormAddReLU"]
    assert len(fused) == 4 and all(n.attrs["axis"] == -1 for n in fused)
    # the port's own serialization round-trips the graph unchanged
    again = mt.sym.load_json(tsym.tojson())
    assert json.loads(again.tojson()) == json.loads(tsym.tojson())


def test_symbolic_mlp_shapes_match():
    for pkg in (mj, mt):
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu", name="relu1")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
        net = pkg.sym.SoftmaxOutput(net, name="softmax")
        if pkg is mj:
            jnet = net
    assert net.list_arguments() == jnet.list_arguments()
    assert net.infer_shape_partial(data=(4, 5)) == \
        jnet.infer_shape_partial(data=(4, 5))
    assert net.infer_shape(data=(4, 5)) == jnet.infer_shape(data=(4, 5))
    assert net.tojson() == jnet.tojson()


def test_port_export_matches_jax_export(nhwc_fused, tmp_path):
    jpath = _export_jax(tmp_path)
    tpath = _export_port(tmp_path)
    with open(jpath + "-symbol.json") as f:
        jgraph = json.load(f)
    with open(tpath + "-symbol.json") as f:
        tgraph = json.load(f)
    assert len(tgraph["nodes"]) == len(jgraph["nodes"])
    for jn, tn in zip(jgraph["nodes"], tgraph["nodes"]):
        assert tn == jn
    assert tgraph == jgraph
    with np.load(jpath + "-0000.params") as jp, \
            np.load(tpath + "-0000.params") as tp:
        assert sorted(tp.keys()) == sorted(jp.keys())
        for k in jp.keys():
            assert tp[k].shape == jp[k].shape, k
        assert "arg:resnetv10_stage1_conv2d0_weight" in jp.keys()
        assert "aux:resnetv10_stage1_fusedbnaddrelu0_running_mean" in jp.keys()
    assert os.path.getsize(tpath + "-0000.params") > 0


def test_gluon_parameter_names_match():
    for layout in (None, "NHWC"):
        mj.layout.set_default_layout(layout)
        mt.layout.set_default_layout(layout)
        try:
            jn = _small(mj, jresnet)
            tn = _small(mt, tresnet)
        finally:
            mj.layout.set_default_layout(None)
            mt.layout.set_default_layout(None)
        jp, tp = jn.collect_params(), tn.collect_params()
        assert list(tp.keys()) == list(jp.keys())
        assert [p.shape for p in tp.values()] == [p.shape for p in jp.values()]


def test_variable_attributes_match_jax():
    """``lr_mult``, ``wd_mult``, ``init`` and the numpy dtype name land in
    the variable's attributes as in the JAX package (ROADMAP Queue 3,
    fault 1: the port used to drop the first three and write
    ``"<class 'numpy.float32'>"``)."""
    kw = dict(shape=(2, 3), dtype=np.float32, lr_mult=0.5, wd_mult=0.0,
              init="zeros")
    assert mt.sym.Variable("w", **kw).attr_dict() == \
        mj.sym.Variable("w", **kw).attr_dict()
    xav_t = mt.sym.Variable("v", init=mt.init.Xavier(magnitude=2))
    xav_j = mj.sym.Variable("v", init=mj.init.Xavier(magnitude=2))
    assert json.loads(xav_t.attr_dict()["v"]["__init__"]) == \
        json.loads(xav_j.attr_dict()["v"]["__init__"])


def test_float16_variable_binds_float16_like_jax():
    """``Variable("data", dtype=np.float16)`` under a FullyConnected binds
    float16 arguments in both packages."""
    shapes = {"data": (2, 3)}
    types = []
    for pkg, kw in ((mj, {}), (mt, {"ctx": mt.cpu()})):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data",
                                                      dtype=np.float16),
                                     num_hidden=4, name="fc")
        ex = net.simple_bind(**kw, **shapes)
        types.append([np.dtype(a.dtype).name for a in ex.arg_arrays])
    assert types[0] == types[1] == ["float16"] * 3


# ---------------------------------------------------------------------------
# the graph surface: internals, children, attributes, types, eval
# ---------------------------------------------------------------------------

def _small_graph(pkg):
    with pkg.name.NameManager():
        data = pkg.sym.Variable("data", lr_mult=2.0)
        net = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                                  pad=(1, 1), name="conv1")
        net = pkg.sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = pkg.sym.Activation(net, act_type="relu", name="relu1")
        net = pkg.sym.Flatten(net, name="flatten")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_graph_surface_matches_jax():
    j, t = _small_graph(mj), _small_graph(mt)
    ji, ti = j.get_internals(), t.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    assert "flatten_output" in ti.list_outputs()
    feat_j, feat_t = ji["flatten_output"], ti["flatten_output"]
    assert feat_t.list_arguments() == feat_j.list_arguments()
    assert feat_t.list_auxiliary_states() == feat_j.list_auxiliary_states()
    assert t.get_children().list_outputs() == \
        j.get_children().list_outputs()
    assert ti["data"].get_children() is None
    assert t.list_inputs() == j.list_inputs()
    assert ti["data"].attr("__lr_mult__") == ji["data"].attr("__lr_mult__")
    assert ti["data"].list_attr() == ji["data"].list_attr()
    assert t.attr("nonexistent") is None
    with pytest.raises(mt.MXNetError):
        t.list_attr(recursive=True)
    assert t.debug_str() == j.debug_str()
    jt = j.infer_type(data=np.float32)
    tt = t.infer_type(data=np.float32)
    assert tt == jt
    assert all(d == np.float32 for d in tt[0] + tt[1] + tt[2])
    import copy
    assert copy.copy(t).list_outputs() == t.list_outputs()
    deep = copy.deepcopy(t)
    assert deep.tojson() == t.tojson() and deep is not t
    for name in ("copy", "asnumpy", "wait_to_read", "backward"):
        with pytest.raises(mt.MXNetError, match="not supported for Symbol"):
            getattr(t, name)()
    with pytest.raises(mt.MXNetError, match="not implemented"):
        t.gradient(["data"])


def test_symbol_eval_matches_jax():
    rs = np.random.RandomState(0)
    a, b = rs.randn(2, 3).astype(np.float32), rs.randn(2, 3).astype(np.float32)
    outs = {}
    for pkg, kw in ((mj, {}), (mt, {"ctx": mt.cpu()})):
        x, y = pkg.sym.Variable("x"), pkg.sym.Variable("y")
        s = pkg.sym.relu(x * y + 1.5)
        got = s.eval(x=pkg.nd.array(a, **kw), y=pkg.nd.array(b, **kw), **kw)
        outs[pkg] = got[0].asnumpy()
    # XLA's jitted graph contracts x*y+1.5 into one FMA
    np.testing.assert_allclose(outs[mt], outs[mj], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# examples/image-classification/fine_tune.py at its own 12x12 size
# ---------------------------------------------------------------------------

IMG = 12


def _draw(rs, cls, n):
    """fine_tune.py:33-51 (copied): oriented bars, 4 source classes."""
    x = np.zeros((n, 1, IMG, IMG), np.float32)
    for i in range(n):
        c = int(cls[i])
        a = np.zeros((IMG, IMG), np.float32)
        p = rs.randint(2, IMG - 2)
        if c == 0:
            a[p, :] = 1.0
        elif c == 1:
            a[:, p] = 1.0
        elif c == 2:
            np.fill_diagonal(a, 1.0)
        else:
            a[p, :] = 1.0
            a[:, p] = 1.0
        x[i, 0] = a + 0.1 * rs.normal(size=(IMG, IMG))
    return x


def _backbone(pkg, data):
    """fine_tune.py:54-63 (copied)."""
    net = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                              pad=(1, 1), name="conv1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2))
    net = pkg.sym.Convolution(net, kernel=(3, 3), num_filter=16,
                              pad=(1, 1), name="conv2")
    net = pkg.sym.Activation(net, act_type="relu")
    return pkg.sym.Flatten(net, name="flatten")


def test_fine_tune_protocol_matches_jax(tmp_path):
    """fine_tune.py:66-123: stage 1 trains the source task (the JAX
    package) and checkpoints it; stage 2, in both packages, cuts the
    loaded graph at ``get_internals()["flatten_output"]``, adds a 3-class
    head (zero-initialised in both, ``allow_missing``) and fits with the
    backbone in ``fixed_param_names``. The frozen weights stay bit-equal
    to the checkpoint's, the head is within 1e-6 of JAX's, and the head
    alone learns the target task."""
    rs = np.random.RandomState(0)
    prefix = str(tmp_path / "source")
    ys = rs.randint(0, 4, 512).astype(np.float32)
    xs = _draw(rs, ys, 512)
    np.random.seed(1)
    it = mj.io.NDArrayIter(xs, ys, batch_size=32, shuffle=True,
                           label_name="softmax_label")
    src = mj.sym.SoftmaxOutput(
        mj.sym.FullyConnected(_backbone(mj, mj.sym.Variable("data")),
                              num_hidden=4, name="src_fc"), name="softmax")
    mod = mj.mod.Module(src, context=mj.cpu())
    mod.fit(it, num_epoch=3, initializer=mj.initializer.Xavier(),
            optimizer_params={"learning_rate": 0.01})
    mod.save_checkpoint(prefix, 3)
    yt = rs.randint(0, 3, 384).astype(np.float32)
    xt = _draw(rs, yt, 384)
    heads, accs = {}, {}
    for pkg, kw in ((mj, {}), (mt, {"ctx": mt.cpu()})):
        sym, arg_params, aux_params = pkg.model.load_checkpoint(prefix, 3,
                                                                **kw)
        features = sym.get_internals()["flatten_output"]
        net = pkg.sym.FullyConnected(features, num_hidden=3, name="tgt_fc")
        net = pkg.sym.SoftmaxOutput(net, name="softmax")
        backbone = [n for n in net.list_arguments()
                    if n.startswith(("conv1", "conv2"))]
        assert backbone == ["conv1_weight", "conv1_bias", "conv2_weight",
                            "conv2_bias"]
        np.random.seed(2)
        it2 = pkg.io.NDArrayIter(xt, yt, batch_size=32, shuffle=True,
                                 label_name="softmax_label")
        tuned = pkg.mod.Module(net, context=kw.get("ctx", mj.cpu()),
                               fixed_param_names=backbone)
        before = {n: arg_params[n].asnumpy() for n in backbone}
        tuned.fit(it2, num_epoch=3, arg_params=arg_params,
                  aux_params=aux_params, allow_missing=True,
                  initializer=pkg.initializer.Zero(),
                  optimizer_params={"learning_rate": 0.01})
        after, _ = tuned.get_params()
        for n in backbone:
            np.testing.assert_array_equal(after[n].asnumpy(), before[n],
                                          err_msg=n)
        heads[pkg] = {n: after[n].asnumpy() for n in after
                      if n.startswith("tgt_fc")}
        metric = pkg.metric.Accuracy()
        it2.reset()
        tuned.score(it2, metric)
        accs[pkg] = metric.get()[1]
    for n in heads[mj]:
        np.testing.assert_allclose(heads[mt][n], heads[mj][n], rtol=0,
                                   atol=1e-6, err_msg=n)
    assert accs[mt] == accs[mj] and accs[mt] > 0.9, accs
