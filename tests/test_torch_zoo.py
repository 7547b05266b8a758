"""Image classification beyond ResNet in the PyTorch port, against the
JAX package: ``LRN``, the SGD update ops as ``mx.nd`` functions, the
1-, 2- and 3-D convolution and pooling layers of ``gluon.nn``, the
image-classification symbols and the Gluon model zoo.

Tolerances: LRN's forward and gradient within 1e-6 (nsize 3, 4 and 5:
``F.local_response_norm`` pads and scales as the reference does); the
update ops within 2 fp32 ulps (XLA contracts their multiply-adds into
FMAs); the layers within 1e-6; every zoo constructor's logits at a
small input (32x32, or the least size its pools allow: 67 for AlexNet,
299 for Inception v3: its last pool is 8x8) within 1e-5 of the largest |logit| on the same
weights; the ten symbols of ``examples/image-classification/symbols``
(the copies ``chip_smoke.py`` runs) list the same arguments and infer
the same shapes as the examples, and AlexNet's symbol forward at 67x67
is within 1e-5 of the largest |logit|. Training the zoo's DenseNet is
in ``tests/test_torch_zoo_training.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_kvstore import chip_smoke, jsymbols

CPU = mt.cpu()


def _nd(pkg, x):
    return pkg.nd.array(x, ctx=CPU) if pkg is mt else pkg.nd.array(x)


def _scaled(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


# ---------------------------------------------------------------------------
# LRN and the update ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nsize", [3, 4, 5])
def test_lrn_forward_and_gradient_match_jax(nsize):
    rs = np.random.RandomState(nsize)
    x = rs.randn(2, 7, 4, 5).astype(np.float32) * 3
    head = rs.randn(*x.shape).astype(np.float32)
    res = {}
    for pkg in (mx, mt):
        a = _nd(pkg, x)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.LRN(a, alpha=0.001, beta=0.75, knorm=2.0,
                           nsize=nsize)
        y.backward(_nd(pkg, head))
        res[pkg] = (y.asnumpy(), a.grad.asnumpy())
    np.testing.assert_allclose(res[mt][0], res[mx][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res[mt][1], res[mx][1], rtol=0, atol=1e-6)
    # a 2-D input (N, C) is normalised across C as well
    two = {pkg: pkg.nd.LRN(_nd(pkg, x[:, :, 0, 0]), nsize=nsize).asnumpy()
           for pkg in (mx, mt)}
    np.testing.assert_allclose(two[mt], two[mx], rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", ["sgd_update", "sgd_mom_update",
                                "mp_sgd_update", "mp_sgd_mom_update"])
def test_sgd_update_ops_write_in_place_like_jax(op):
    rs = np.random.RandomState(1)
    w, g, m = (rs.randn(5, 3).astype(np.float32) for _ in range(3))
    kw = {"lr": 0.1, "wd": 1e-3, "rescale_grad": 0.5, "clip_gradient": 0.8}
    if "mom" in op:
        kw["momentum"] = 0.9
    res = {}
    for pkg in (mx, mt):
        arrays = {"weight": _nd(pkg, w), "grad": _nd(pkg, g)}
        if "mom" in op:
            arrays["mom"] = _nd(pkg, m)
        if op.startswith("mp_"):
            arrays["weight32"] = _nd(pkg, w)
        out = getattr(pkg.nd, op)(*arrays.values(), **kw)
        assert out is arrays["weight"]
        res[pkg] = {k: v.asnumpy() for k, v in arrays.items()}
    for k in res[mx]:
        np.testing.assert_allclose(res[mt][k], res[mx][k], rtol=4.8e-7,
                                   atol=0, err_msg=k)
    assert hasattr(mt.sym, op)


# ---------------------------------------------------------------------------
# gluon.nn: 1-, 2- and 3-D convolutions and pools
# ---------------------------------------------------------------------------

_LAYERS = [
    ("Conv1D", (2, 3, 11), {"channels": 4, "kernel_size": 3, "strides": 2,
                            "padding": 1, "in_channels": 3}),
    ("Conv3D", (2, 3, 5, 6, 7), {"channels": 4, "kernel_size": 3,
                                 "padding": 1, "in_channels": 3}),
    ("MaxPool1D", (2, 3, 11), {"pool_size": 3, "strides": 2}),
    ("MaxPool1D", (2, 3, 11), {"pool_size": 3, "strides": 2,
                               "ceil_mode": True}),
    ("MaxPool3D", (2, 3, 5, 6, 7), {"pool_size": 2, "strides": 2,
                                    "ceil_mode": True}),
    ("AvgPool1D", (2, 3, 11), {"pool_size": 3, "strides": 2, "padding": 1}),
    ("AvgPool2D", (2, 3, 9, 8), {"pool_size": 3, "strides": 1,
                                 "padding": 1}),
    ("AvgPool2D", (2, 3, 9, 8), {"pool_size": 3, "strides": 2,
                                 "ceil_mode": True}),
    ("AvgPool3D", (2, 3, 5, 6, 7), {"pool_size": 2}),
    ("GlobalMaxPool1D", (2, 3, 11), {}),
    ("GlobalMaxPool2D", (2, 3, 9, 8), {}),
    ("GlobalMaxPool3D", (2, 3, 5, 6, 7), {}),
    ("GlobalAvgPool1D", (2, 3, 11), {}),
    ("GlobalAvgPool3D", (2, 3, 5, 6, 7), {}),
]


@pytest.mark.parametrize("name,shape,kw", _LAYERS,
                         ids=["%s-%d" % (l[0], i)
                              for i, l in enumerate(_LAYERS)])
def test_conv_and_pool_layers_match_jax(name, shape, kw):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    blocks = {pkg: getattr(pkg.gluon.nn, name)(**kw) for pkg in (mx, mt)}
    blocks[mx].initialize(mx.init.Xavier())
    blocks[mt].initialize(ctx=CPU)
    for jp, tp in zip(blocks[mx].collect_params().values(),
                      blocks[mt].collect_params().values()):
        tp.set_data(_nd(mt, jp.data().asnumpy()))
    outs = {pkg: blocks[pkg](_nd(pkg, x)).asnumpy() for pkg in (mx, mt)}
    assert outs[mt].shape == outs[mx].shape
    np.testing.assert_allclose(outs[mt], outs[mx], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the image-classification symbols (chip_smoke.py's copies)
# ---------------------------------------------------------------------------

_NETWORKS = [("mlp", (1, 28, 28), {}), ("lenet", (1, 28, 28), {}),
             ("alexnet", (3, 224, 224), {}),
             ("resnet", (3, 224, 224), {"num_layers": 50}),
             ("vgg", (3, 224, 224), {"num_layers": 16}),
             ("googlenet", (3, 224, 224), {}),
             ("mobilenet", (3, 224, 224), {}),
             ("resnext", (3, 224, 224), {"num_layers": 50}),
             ("inception-bn", (3, 224, 224), {}),
             ("inception-v3", (3, 299, 299), {})]


@pytest.mark.parametrize("network,shape,kw", _NETWORKS,
                         ids=[n for n, _, _ in _NETWORKS])
def test_symbol_copies_match_the_examples(network, shape, kw):
    with mx.name.NameManager():
        want = jsymbols.get_symbol(network, 1000, **kw)
    with mt.name.NameManager():
        got = chip_smoke.ic_symbol(mt, network, 1000, **kw)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()
    assert got.list_outputs() == want.list_outputs()
    data = (2,) + shape
    g = got.infer_shape(data=data)
    w = want.infer_shape(data=data)
    assert [tuple(s) for s in g[0]] == [tuple(s) for s in w[0]]
    assert [tuple(s) for s in g[1]] == [tuple(s) for s in w[1]] == \
        [(2, 1000)]


def test_alexnet_symbol_forward_matches_jax():
    """LRN inside AlexNet's symbol, at 67x67 (the least input its three
    pools take), on the JAX Module's Xavier weights."""
    x = np.random.RandomState(0).uniform(0, 1, (2, 3, 67, 67)) \
        .astype(np.float32)
    with mx.name.NameManager():
        jsym = jsymbols.get_symbol("alexnet", 10)
    with mt.name.NameManager():
        tsym = chip_smoke.ic_symbol(mt, "alexnet", 10)
    jmod = mx.mod.Module(jsym, context=mx.cpu())
    jmod.bind([("data", x.shape)], [("softmax_label", (2,))],
              for_training=False)
    np.random.seed(0)
    jmod.init_params(mx.initializer.Xavier())
    arg, aux = jmod.get_params()
    tmod = mt.mod.Module(tsym, context=CPU)
    tmod.bind([("data", x.shape)], [("softmax_label", (2,))],
              for_training=False)
    mt.weights.load_into_module(tmod, {k: v.asnumpy() for k, v in
                                       arg.items()}, {})
    outs = {}
    for pkg, mod in ((mx, jmod), (mt, tmod)):
        mod.forward(pkg.io.DataBatch([_nd(pkg, x)], [_nd(pkg, np.zeros(2))]),
                    is_train=False)
        outs[pkg] = mod.get_outputs()[0].asnumpy()
    assert _scaled(outs[mt], outs[mx]) <= 1e-5


# ---------------------------------------------------------------------------
# the Gluon model zoo
# ---------------------------------------------------------------------------

_ZOO = [("alexnet", 67), ("vgg11", 32), ("vgg11_bn", 32), ("vgg13", 32),
        ("vgg13_bn", 32), ("vgg16", 32), ("vgg16_bn", 32), ("vgg19", 32),
        ("vgg19_bn", 32), ("squeezenet1.0", 32), ("squeezenet1.1", 32),
        ("densenet121", 32), ("densenet161", 32), ("densenet169", 32),
        ("densenet201", 32), ("inceptionv3", 299), ("mobilenet1.0", 32),
        ("mobilenet0.75", 32), ("mobilenet0.5", 32),
        ("mobilenet0.25", 32), ("resnet18_v2", 32), ("resnet50_v2", 32)]


def _zoo_pair(name, hw, classes=10, batch=2, seed=0):
    """The same zoo network in both packages on the JAX one's weights,
    BatchNorm statistics drawn at random."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (batch, 3, hw, hw)).astype(np.float32)
    jnet = mx.gluon.model_zoo.vision.get_model(name, classes=classes,
                                               prefix="zoo_")
    tnet = mt.gluon.model_zoo.vision.get_model(name, classes=classes,
                                               prefix="zoo_")
    mx.random.seed(seed)
    np.random.seed(seed)
    jnet.initialize(mx.init.Xavier())
    tnet.initialize(ctx=CPU)
    jnet(_nd(mx, x))
    tnet(_nd(mt, x))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    for k, p in jp.items():
        v = p.data().asnumpy()
        if k.endswith("running_mean"):
            v = rs.randn(*v.shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        p.set_data(_nd(mx, v))
        tp[k].set_data(_nd(mt, v))
    return jnet, tnet, x


@pytest.mark.parametrize("name,hw", _ZOO, ids=[n for n, _ in _ZOO])
def test_zoo_constructor_matches_jax(name, hw):
    jnet, tnet, x = _zoo_pair(name, hw)
    want = jnet(_nd(mx, x)).asnumpy()
    got = tnet(_nd(mt, x)).asnumpy()
    assert got.shape == want.shape == (2, 10)
    assert _scaled(got, want) <= 1e-5


def test_get_model_names_and_pretrained():
    names = ["alexnet", "densenet121", "inceptionv3", "inception_v3",
             "mobilenet0.25", "mobilenet1_0", "resnet152_v2",
             "squeezenet1.1", "vgg19_bn"]
    for n in names:
        assert type(mt.gluon.model_zoo.vision.get_model(n)).__name__ == \
            type(mx.gluon.model_zoo.vision.get_model(n)).__name__
    with pytest.raises(mt.MXNetError, match="not in zoo"):
        mt.gluon.model_zoo.vision.get_model("lenet")
    for ctor in ("alexnet", "densenet121", "inceptionv3", "mobilenet0.5",
                 "resnet18_v1", "squeezenet1.0", "vgg11"):
        with pytest.raises(mt.MXNetError, match="download"):
            mt.gluon.model_zoo.vision.get_model(ctor, pretrained=True)


@pytest.mark.parametrize("fault", ["none", "dropped_beta", "flipped_beta",
                                   "halved_beta", "dropped_beta_fp64",
                                   "dropped_weight_fp64"])
def test_step1_gate_fails_a_wrong_update(fault):
    """``chip_smoke._step1_gate`` on planted weights: a BatchNorm shift
    whose fp32 update is a few percent off (as one step leaves it on
    either device) passes; a dropped, sign-flipped or halved shift
    update in the fp32 step fails (the CPU's fp32 resolves it here), and
    so does any dropped update in the fp64 step."""
    import torch
    rs = np.random.RandomState(0)
    w0 = {"bn_beta": np.zeros(16), "conv_weight": rs.randn(16, 8) * 0.1}
    upd = {"bn_beta": rs.randn(16) * 1e-4, "conv_weight": rs.randn(16, 8)
           * 1e-5}
    cpu64 = {k: w0[k] + upd[k] for k in w0}
    noise = {"bn_beta": 3e-6, "conv_weight": 1e-5}

    def off(scale, seed):
        r = np.random.RandomState(seed)
        return {k: cpu64[k] + r.randn(*v.shape) * noise[k] * scale
                for k, v in cpu64.items()}
    cpu, card, card64 = off(1, 1), off(1, 2), off(1e-9, 3)
    if fault == "dropped_beta":
        card["bn_beta"] = w0["bn_beta"]
    elif fault == "flipped_beta":
        card["bn_beta"] = w0["bn_beta"] - upd["bn_beta"]
    elif fault == "halved_beta":
        card["bn_beta"] = w0["bn_beta"] + upd["bn_beta"] / 2
    elif fault == "dropped_beta_fp64":
        card64["bn_beta"] = w0["bn_beta"]
    elif fault == "dropped_weight_fp64":
        card64["conv_weight"] = w0["conv_weight"]

    def t(d, dtype):
        return {k: torch.tensor(v, dtype=dtype) for k, v in d.items()}
    ok, rep = chip_smoke._step1_gate(
        t(card, torch.float32), t(card64, torch.float64),
        t(cpu, torch.float32), t(cpu64, torch.float64),
        t(w0, torch.float32))
    assert ok == (fault == "none"), rep
    if fault == "none":
        assert rep["planted_not_caught"] == [], rep
        assert rep["by_kind"]["beta"]["planted_caught_fp32"] == 1, rep
        assert rep["by_kind"]["beta"]["fp32_resolves_update"] == 1, rep
