"""Symbol, shape inference, export and naming of the PyTorch port against
the JAX package.

A graph the JAX package exports loads in the port with the same
arguments, auxiliary states and inferred shapes; the same Gluon model
built in both packages exports the same JSON nodes and the same
parameter names and shapes, so weights carry across by name.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mj
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet

import mxnet_tpu_torch as mt
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
