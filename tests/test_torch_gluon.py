"""Gluon in the PyTorch port against the JAX package: losses, parameters,
checkpoints, the Trainer and the README's training loop.

The same numpy inputs and weights go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` on the CPU:

* every ported loss on the inputs of ``tests/test_loss.py`` (and a
  weighted, a 3-D and a hybridized case), outputs and input gradients;
* ``Parameter`` gradients under ``grad_req`` write/add/null, the
  ``zero_grad``/``setattr``/``cast`` helpers, ``collect_params(select)``,
  ``save_params``/``load_params`` and ``Trainer.save_states`` written by
  one package and read by the other;
* three steps of the README's loop (``autograd.record`` → loss →
  ``backward`` → ``Trainer.step``) on ``resnet18_v1(thumbnail=True)``,
  NHWC with fused block tails, 32x32, batch 4, 10 classes, SGD lr 0.05
  momentum 0.9, hybridized and not, against the JAX package's same
  loop. The ReLU units share the port's branch masks (``_ReluMasks`` of
  ``test_torch_training.py``: units within rounding of zero flip between
  the frameworks). The JAX package's hybridized loop runs under
  ``jax.disable_jit()`` so every step replays its own masks (its
  ``_CachedOp`` traces the block once for the shapes and once more for
  each backward).

Tolerances: losses and their gradients 1e-6 relative (plus 1e-7
absolute for values near zero). The loop's step 1: loss 1e-6 relative,
every parameter and moving statistic within 1e-5 of its tensor's largest
magnitude (measured: 8e-8 and 7.7e-6). Steps 2 and 3: 1e-4 for both, as
PR 4's three raw steps: BatchNorm over batch 4 at the 4x4 stage-4 maps
divides by small batch variances, so the fp32 rounding of the two
frameworks' convolutions (sums in other orders) grows about threefold a
step (measured 1.6e-5 and 7.0e-5 of the largest magnitude, losses
1.8e-5 relative at step 2) while the lr-0.05 momentum step moves the
loss from 2.9 to 0.8 to 11.2. The port's hybridized steps equal its
eager ones to 1e-6.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

from test_torch_training import _ReluMasks

CPU = mt.cpu()


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _pair(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return mx.nd.array(a), mt.nd.array(a, ctx=CPU)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

_RS = np.random.RandomState(0)
_LOSS_CASES = {
    "l2": ("L2Loss", {}, [[[1.0, 2.0], [3.0, 4.0]], [[1.5, 2.0], [2.0, 4.0]]]),
    "l2_weight": ("L2Loss", {"weight": 2.0},
                  [[[1.0, 1.0], [1.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]]]),
    "l2_sample_weight": ("L2Loss", {},
                         [[[1.0, 1.0], [1.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]],
                          [[1.0], [0.0]]]),
    "l1": ("L1Loss", {}, [[[1.0, 2.0]], [[2.0, 0.0]]]),
    "softmax_ce": ("SoftmaxCrossEntropyLoss", {},
                   [[[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]], [2, 0]]),
    "softmax_ce_dense": ("SoftmaxCELoss", {"sparse_label": False},
                         [_RS.rand(4, 5), np.eye(5)[[0, 1, 2, 3]]]),
    "softmax_ce_3d_axis1": ("SoftmaxCrossEntropyLoss", {"axis": 1},
                            [_RS.randn(2, 4, 3), _RS.randint(0, 4, (2, 3))]),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {},
                    [[[0.5, -0.5]], [[1.0, 0.0]]]),
    "sigmoid_bce_from_sigmoid": ("SigmoidBCELoss", {"from_sigmoid": True},
                                 [[[0.3, 0.8]], [[1.0, 0.0]]]),
    "kl_div": ("KLDivLoss", {"from_logits": True},
               [np.log([[0.3, 0.7]]), [[0.5, 0.5]]]),
    "kl_div_logits": ("KLDivLoss", {"from_logits": False},
                      [_RS.randn(3, 4), _RS.dirichlet(np.ones(4), 3)]),
    "huber": ("HuberLoss", {"rho": 1.0}, [[[0.0, 3.0]], [[0.5, 0.0]]]),
    "hinge": ("HingeLoss", {}, [[[0.3], [-2.0]], [[1.0], [-1.0]]]),
    "squared_hinge": ("SquaredHingeLoss", {},
                      [[[0.3], [-2.0]], [[1.0], [-1.0]]]),
    "logistic": ("LogisticLoss", {}, [_RS.randn(3, 2),
                                      np.sign(_RS.randn(3, 2))]),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        [_RS.randn(3, 2), _RS.randint(0, 2, (3, 2))]),
    "triplet": ("TripletLoss", {}, [_RS.randn(3, 4), _RS.randn(3, 4),
                                    _RS.randn(3, 4)]),
}


@pytest.mark.parametrize("case", sorted(_LOSS_CASES))
def test_loss_matches_jax(case):
    """Output and the gradient of its sum with respect to the prediction."""
    cls, kwargs, ins = _LOSS_CASES[case]
    jl, tl = getattr(jloss, cls)(**kwargs), getattr(tloss, cls)(**kwargs)
    jins, tins = zip(*[_pair(a) for a in ins])
    jins[0].attach_grad()
    tins[0].attach_grad()
    with mx.autograd.record():
        jout = jl(*jins)
        jtot = jout.sum()
    jtot.backward()
    with mt.autograd.record():
        tout = tl(*tins)
        ttot = tout.sum()
    ttot.backward()
    _close(tout.asnumpy(), jout.asnumpy())
    _close(tins[0].grad.asnumpy(), jins[0].grad.asnumpy())


@pytest.mark.parametrize("case", ["softmax_ce", "huber", "logistic_binary",
                                  "l2_sample_weight"])
def test_hybridized_loss_equals_eager(case):
    cls, kwargs, ins = _LOSS_CASES[case]
    tins = [_pair(a)[1] for a in ins]
    eager = getattr(tloss, cls)(**kwargs)(*tins).asnumpy()
    hyb = getattr(tloss, cls)(**kwargs)
    hyb.hybridize()
    _close(hyb(*tins).asnumpy(), eager)


# ---------------------------------------------------------------------------
# Parameters, checkpoints and the Trainer
# ---------------------------------------------------------------------------

def _mlp(pkg, ctx_kw):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=5))
            net.add(pkg.gluon.nn.Dense(3, in_units=8))
    net.initialize(pkg.init.Xavier(), **ctx_kw)
    return net


def _mlp_pair():
    jnet = _mlp(mx, {})
    tnet = _mlp(mt, {"ctx": CPU})
    mt.weights.load_into_block(tnet, jnet.collect_params(), ctx=CPU)
    return jnet, tnet


def _mlp_grads(pkg, net, x, y, ctx_kw, steps=1):
    L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = pkg.nd.array(x, **ctx_kw)
    ys = pkg.nd.array(y, **ctx_kw)
    for _ in range(steps):
        with pkg.autograd.record():
            loss = L(net(xs), ys)
        loss.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()
            if p.grad_req != "null"}


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_parameter_grads_match_jax(grad_req):
    """Two recorded passes: 'write' keeps the last gradient, 'add' their
    sum."""
    jnet, tnet = _mlp_pair()
    jnet.collect_params().setattr("grad_req", grad_req)
    tnet.collect_params().setattr("grad_req", grad_req)
    rs = np.random.RandomState(1)
    x, y = rs.randn(6, 5).astype(np.float32), rs.randint(0, 3, 6)
    jg = _mlp_grads(mx, jnet, x, y, {}, steps=2)
    tg = _mlp_grads(mt, tnet, x, y, {"ctx": CPU}, steps=2)
    assert sorted(jg) == sorted(tg)
    for k in jg:
        _close(tg[k], jg[k], rtol=1e-5, atol=1e-6)


def test_grad_req_null_and_zero_grad():
    _, tnet = _mlp_pair()
    params = tnet.collect_params()
    bias = params["mlp_dense0_bias"]
    bias.grad_req = "null"
    with pytest.raises(mt.MXNetError):
        bias.grad()
    rs = np.random.RandomState(2)
    g = _mlp_grads(mt, tnet, rs.randn(4, 5), rs.randint(0, 3, 4),
                   {"ctx": CPU})
    assert "mlp_dense0_bias" not in g
    assert np.abs(g["mlp_dense0_weight"]).sum() > 0
    params.zero_grad()
    for p in params.values():
        if p.grad_req != "null":
            assert not p.grad().asnumpy().any()
            assert len(p.list_grad()) == len(p.list_data()) == 1
            assert p.list_ctx() == [CPU]


def test_parameter_cast_and_var():
    _, tnet = _mlp_pair()
    p = tnet.collect_params()["mlp_dense1_weight"]
    p.cast("float16")
    assert p.data().dtype == np.float16 and p.grad().dtype == np.float16
    v = p.var()
    assert v.attr_dict()["mlp_dense1_weight"]["__dtype__"] == "float16"


@pytest.mark.parametrize("select", [None, ".*weight", "mlp_dense1_.*"])
def test_collect_params_select_matches_jax(select):
    jnet, tnet = _mlp_pair()
    assert list(tnet.collect_params(select).keys()) == \
        list(jnet.collect_params(select).keys())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_params_both_ways(writer, tmp_path):
    jnet, tnet = _mlp_pair()
    rs = np.random.RandomState(3)
    src, dst = (tnet, jnet) if writer == "port" else (jnet, tnet)
    for p in src.collect_params().values():
        a = rs.randn(*p.shape).astype(np.float32)
        p.set_data(mt.nd.array(a, ctx=CPU) if writer == "port"
                   else mx.nd.array(a))
    fname = str(tmp_path / "mlp.params")
    src.save_params(fname)
    if writer == "port":
        dst.load_params(fname)
    else:
        dst.load_params(fname, ctx=CPU)
    for (k, a), (k2, b) in zip(src.collect_params().items(),
                               dst.collect_params().items()):
        assert k == k2
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trainer_states_both_ways(writer, tmp_path):
    """Two momentum steps in the writer, its states saved, loaded by the
    other package's Trainer; one more step on both from the same weights
    and states gives the same weights."""
    jnet, tnet = _mlp_pair()
    rs = np.random.RandomState(4)
    x, y = rs.randn(6, 5).astype(np.float32), rs.randint(0, 3, 6)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    (wnet, wtr, wpkg, wkw), (rnet, rtr, rpkg, rkw) = (
        (tnet, ttr, mt, {"ctx": CPU}), (jnet, jtr, mx, {}))
    if writer == "jax":
        (wnet, wtr, wpkg, wkw), (rnet, rtr, rpkg, rkw) = \
            (rnet, rtr, rpkg, rkw), (wnet, wtr, wpkg, wkw)
    for _ in range(2):
        _mlp_grads(wpkg, wnet, x, y, wkw)
        wtr.step(6)
    fname = str(tmp_path / "trainer.states")
    wtr.save_states(fname)
    for k, p in rnet.collect_params().items():
        p.set_data(rpkg.nd.array(wnet.collect_params()[k].data().asnumpy(),
                                 **rkw))
    rtr.load_states(fname)
    for net, tr, pkg, kw in ((wnet, wtr, wpkg, wkw), (rnet, rtr, rpkg, rkw)):
        _mlp_grads(pkg, net, x, y, kw)
        tr.step(6)
    for k, p in wnet.collect_params().items():
        _close(rnet.collect_params()[k].data().asnumpy(), p.data().asnumpy(),
               rtol=1e-5, atol=1e-6)


def _dense_adam(pkg, kw, w, b):
    net = pkg.gluon.nn.Dense(2, in_units=3)
    net.initialize(**kw)
    net.weight.set_data(pkg.nd.array(w, **kw))
    net.bias.set_data(pkg.nd.array(b, **kw))
    return net, pkg.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.1})


def _dense_step(pkg, kw, net, tr, x, y):
    with pkg.autograd.record():
        loss = pkg.gluon.loss.L2Loss()(net(pkg.nd.array(x, **kw)),
                                       pkg.nd.array(y, **kw))
    loss.backward()
    tr.step(x.shape[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_states_resumes_the_update_counts(writer, tmp_path):
    """Adam's bias correction reads the update count: 3 steps, the
    states saved, a new Trainer loads them, 1 more step must equal the
    uninterrupted 4 steps (bit-equal within the port; within 1e-5
    relative, 1e-6 absolute, of the JAX package's run when the JAX
    package wrote the file: Adam's sqrt and division round apart). Before
    the repair the reloaded optimizer restarted at count 1."""
    rs = np.random.RandomState(7)
    w, b = rs.randn(2, 3).astype(np.float32), rs.randn(2).astype(np.float32)
    xs = [rs.randn(4, 3).astype(np.float32) for _ in range(4)]
    ys = [rs.randn(4, 2).astype(np.float32) for _ in range(4)]
    wpkg, wkw = (mt, {"ctx": CPU}) if writer == "port" else (mx, {})
    ref, rtr = _dense_adam(wpkg, wkw, w, b)
    for x, y in zip(xs, ys):
        _dense_step(wpkg, wkw, ref, rtr, x, y)
    net, tr = _dense_adam(wpkg, wkw, w, b)
    for x, y in zip(xs[:3], ys[:3]):
        _dense_step(wpkg, wkw, net, tr, x, y)
    fname = str(tmp_path / "adam.states")
    tr.save_states(fname)
    mid = [p.data().asnumpy() for p in (net.weight, net.bias)]
    net2, tr2 = _dense_adam(mt, {"ctx": CPU}, *mid)
    tr2.load_states(fname)
    assert tr2._optimizer.num_update == 3
    _dense_step(mt, {"ctx": CPU}, net2, tr2, xs[3], ys[3])
    for got, want in ((net2.weight, ref.weight), (net2.bias, ref.bias)):
        if writer == "port":
            np.testing.assert_array_equal(got.data().asnumpy(),
                                          want.data().asnumpy())
        else:
            _close(got.data().asnumpy(), want.data().asnumpy(), rtol=1e-5,
                   atol=1e-6)


def test_trainer_kvstore_and_learning_rate():
    _, tnet = _mlp_pair()
    for kv in (None, "local", "device"):
        tr = mt.gluon.Trainer(tnet.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore=kv)
        assert tr._kvstore is None
    tr.set_learning_rate(0.5)
    assert tr.learning_rate == 0.5
    # a dist store outside a launched job: one worker, the store made at
    # construction and the optimizer in it (the multi-process runs are
    # test_torch_dist.py's)
    tr = mt.gluon.Trainer(tnet.collect_params(), "sgd", {},
                          kvstore="dist_sync")
    assert tr._kvstore.type == "dist_sync" and tr._update_on_kvstore
    assert tr._kvstore.num_workers == 1 and tr._kv_initialized


def test_update_between_recorded_steps_keeps_backward_right():
    """Trainer.step writes the weights in place between two recorded
    steps; the second backward is taken at the new weights (the JAX
    package's, which rebinds them)."""
    jnet, tnet = _mlp_pair()
    rs = np.random.RandomState(5)
    x, y = rs.randn(6, 5).astype(np.float32), rs.randint(0, 3, 6)
    for pkg, net, kw in ((mx, jnet, {}), (mt, tnet, {"ctx": CPU})):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        _mlp_grads(pkg, net, x, y, kw)
        tr.step(6)
    jg = _mlp_grads(mx, jnet, x, y, {})
    tg = _mlp_grads(mt, tnet, x, y, {"ctx": CPU})
    for k in jg:
        _close(tg[k], jg[k], rtol=1e-5, atol=1e-6)


def test_utils_split_and_clip():
    a = mt.nd.array(np.arange(12, dtype=np.float32).reshape(6, 2), ctx=CPU)
    parts = mt.gluon.utils.split_data(a, 3)
    ref = mx.gluon.utils.split_data(mx.nd.array(a.asnumpy()), 3)
    for p, r in zip(parts, ref):
        np.testing.assert_array_equal(p.asnumpy(), r.asnumpy())
    assert mt.gluon.utils.split_and_load(a, [CPU])[0] is a
    with pytest.raises(mt.MXNetError):
        mt.gluon.utils.split_data(a, 4)
    arrs = [mt.nd.array([3.0, 4.0], ctx=CPU), mt.nd.array([12.0], ctx=CPU)]
    jarrs = [mx.nd.array([3.0, 4.0]), mx.nd.array([12.0])]
    n = mt.gluon.utils.clip_global_norm(arrs, 1.0)
    jn = mx.gluon.utils.clip_global_norm(jarrs, 1.0)
    assert abs(n - jn) < 1e-5
    for t, j in zip(arrs, jarrs):
        _close(t.asnumpy(), j.asnumpy())
    with pytest.raises(mt.MXNetError, match="network"):
        mt.gluon.utils.download("http://example.invalid/x")


def test_block_repr_apply_and_cast():
    _, tnet = _mlp_pair()
    assert "Dense" in repr(tnet)
    seen = []
    tnet.apply(lambda b: seen.append(b.name))
    assert seen[-1] == tnet.name and len(seen) == 3
    tnet.cast("float16")
    assert all(p.data().dtype == np.float16
               for p in tnet.collect_params().values())


# ---------------------------------------------------------------------------
# The README's loop, 3 steps on resnet18_v1(thumbnail=True)
# ---------------------------------------------------------------------------

STEPS, BATCH, HW, CLASSES = 3, 4, 32, 10


def _resnet18(pkg, ctx_kw, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
    pkg.layout.set_default_layout("NHWC")
    try:
        with pkg.name.NameManager():
            net = (tres if pkg is mt else jres).resnet18_v1(
                thumbnail=True, classes=CLASSES)
        net.initialize(pkg.init.Xavier(), **ctx_kw)
        net(pkg.nd.zeros((1, HW, HW, 3), **ctx_kw))
    finally:
        pkg.layout.set_default_layout(None)
    return net


def _carried_resnet18(monkeypatch):
    np.random.seed(0)
    jnet = _resnet18(mx, {}, monkeypatch)
    rs = np.random.RandomState(9)
    for name, p in jnet.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array((rs.rand(*p.shape) + 0.5)
                                   .astype(np.float32)))
        elif name.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array((rs.randn(*p.shape) * 0.1)
                                   .astype(np.float32)))
    tnet = _resnet18(mt, {"ctx": CPU}, monkeypatch)
    mt.weights.load_into_block(tnet, jnet.collect_params(), ctx=CPU)
    return jnet, tnet


def _loop(pkg, net, x, y, kw, hooks):
    """README.md's loop: record, loss, backward, Trainer.step; returns the
    losses and every parameter after each step."""
    L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.05, "momentum": 0.9})
    xs, ys = pkg.nd.array(x, **kw), pkg.nd.array(y, **kw)
    losses, snaps = [], []
    for step in range(STEPS):
        hooks(step)
        with pkg.autograd.record():
            loss = L(net(xs), ys)
        loss.backward()
        tr.step(BATCH)
        losses.append(float(loss.mean().asscalar()))
        snaps.append({k: p.data().asnumpy()
                      for k, p in net.collect_params().items()})
    return losses, snaps


def _assert_snaps(got, want, tol):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            err = float(np.abs(g[k] - w[k]).max())
            assert err <= tol * max(float(np.abs(w[k]).max()), 1e-30), \
                (k, err)


@pytest.mark.parametrize("hybridize", [False, True])
def test_readme_loop_matches_jax(hybridize, monkeypatch):
    jnet, tnet = _carried_resnet18(monkeypatch)
    relu = _ReluMasks(monkeypatch)
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (BATCH, HW, HW, 3)).astype(np.float32)
    y = rs.randint(0, CLASSES, BATCH).astype(np.int32)
    if hybridize:
        tnet.hybridize()
        jnet.hybridize()

    def port_hook(step):
        if step:
            relu.step_masks.append(relu.masks)
        relu.masks = []

    t_losses, t_snaps = _loop(mt, tnet, x, y, {"ctx": CPU}, port_hook)
    relu.step_masks.append(relu.masks)

    def jax_hook(step):
        masks = relu.step_masks[step]
        # the hybridized _CachedOp runs the block twice a step (forward,
        # and again inside its backward) and once more to trace shapes
        reps = (3 if step == 0 else 2) if hybridize else 1
        relu.replay(masks * reps)

    with jax.disable_jit(hybridize):
        j_losses, j_snaps = _loop(mx, jnet, x, y, {}, jax_hook)
    assert not relu._replay
    np.testing.assert_allclose(t_losses[:1], j_losses[:1], rtol=1e-6)
    _assert_snaps(t_snaps[:1], j_snaps[:1], 1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    _assert_snaps(t_snaps, j_snaps, 1e-4)


def test_hybridized_loop_equals_eager(monkeypatch):
    """The port's hybridized loop against its eager loop from the same
    weights, BatchNorm moving stats included."""
    _, a = _carried_resnet18(monkeypatch)
    _, b = _carried_resnet18(monkeypatch)
    b.hybridize()
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (BATCH, HW, HW, 3)).astype(np.float32)
    y = rs.randint(0, CLASSES, BATCH).astype(np.int32)
    la, sa = _loop(mt, a, x, y, {"ctx": CPU}, lambda s: None)
    lb, sb = _loop(mt, b, x, y, {"ctx": CPU}, lambda s: None)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    _assert_snaps(sb, sa, 1e-6)
    assert b._cached_op is not None and len(b._cached_op._cache) == 1


def test_forward_outside_record_builds_no_graph(monkeypatch):
    """A forward outside ``record`` keeps no activations: its output needs
    no grad; under ``record`` it does."""
    _, tnet = _carried_resnet18(monkeypatch)
    x = mt.nd.zeros((2, HW, HW, 3), ctx=CPU)
    for hyb in (False, True):
        if hyb:
            tnet.hybridize()
        assert not tnet(x)._data.requires_grad
        with mt.autograd.record():
            assert tnet(x)._data.requires_grad


def test_hybridize_finishes_deferred_shapes_and_matches_jax():
    """A hybridized net whose shapes are deferred runs eagerly once to
    complete them, then through its cached program, per input signature
    and train mode; the forward matches the JAX package's hybridized
    net from the same weights."""
    outs = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        with pkg.name.NameManager():
            net = pkg.gluon.nn.HybridSequential(prefix="def_")
            with net.name_scope():
                net.add(pkg.gluon.nn.Dense(6, activation="tanh"))
                net.add(pkg.gluon.nn.BatchNorm(axis=1))
                net.add(pkg.gluon.nn.Dense(2))
        net.initialize(pkg.init.Xavier(), **kw)
        net.hybridize()
        outs.append(net)
    jnet, tnet = outs
    x = np.random.RandomState(6).randn(4, 5).astype(np.float32)
    jy = jnet(mx.nd.array(x))
    assert tnet.collect_params()["def_dense0_weight"].shape == (6, 0)
    tnet(mt.nd.array(x, ctx=CPU))               # deferred: one eager call
    assert tnet.collect_params()["def_dense0_weight"].shape == (6, 5)
    mt.weights.load_into_block(tnet, jnet.collect_params(), ctx=CPU)
    ty = tnet(mt.nd.array(x, ctx=CPU))
    _close(ty.asnumpy(), jy.asnumpy(), rtol=1e-5, atol=1e-6)
    with mt.autograd.record():
        tnet(mt.nd.array(x, ctx=CPU))
    with mx.autograd.record():
        jnet(mx.nd.array(x))
    assert len(tnet._cached_op._cache) == 2          # predict and train
    for k, p in tnet.collect_params().items():       # moving stats too
        _close(p.data().asnumpy(), jnet.collect_params()[k].data()
               .asnumpy(), rtol=1e-5, atol=1e-6)


def test_make_pure_fn_of_hybridized_net_equals_eager(monkeypatch):
    """``make_pure_fn`` (the raw step's entry point) gives the same
    outputs, gradients and moving stats whether the net's children are
    hybridized or not: a hybridized child reads the swapped-in parameter
    tensors and hands its BatchNorm updates to the aux collector."""
    from mxnet_tpu_torch.gluon.block import make_pure_fn
    _, net = _carried_resnet18(monkeypatch)
    x = torch.from_numpy(np.random.RandomState(8).uniform(
        -1, 1, (2, HW, HW, 3)).astype(np.float32))
    got = []
    for hyb in (False, True):
        net.hybridize(hyb)
        fn, raw, _ = make_pure_fn(net, train=True)
        full = [r.detach().clone().requires_grad_() for r in raw]
        (out,), aux = fn(full, [x])
        grads = torch.autograd.grad(out.square().sum(), full,
                                    allow_unused=True)
        got.append((out.detach(), grads, aux))
    (o1, g1, a1), (o2, g2, a2) = got
    torch.testing.assert_close(o2, o1, rtol=0, atol=0)
    assert sorted(a1) == sorted(a2) and a1
    for k in a1:
        torch.testing.assert_close(a2[k], a1[k], rtol=0, atol=0)
    for a, b in zip(g2, g1):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
