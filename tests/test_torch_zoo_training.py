"""Training the Gluon zoo's DenseNet in the PyTorch port against the JAX
package (beside ``tests/test_torch_zoo.py``, which holds the forwards).

A small DenseNet's gradients are within 1e-5 of each tensor's largest
of JAX's; ``densenet121`` trains 2 steps, eager and hybridized, step 1's
loss within 1e-5 of JAX's, step 2's within 1e-2 (ill-conditioned in fp32
at this size, see the test), and the port's hybridized within 1e-6 of
its eager. Step 1's parameters, tensor by tensor, are held in
``tests/test_torch_zoo_step1.py`` (a file of its own, so that
pytest-xdist runs the two JAX densenet121 computations, each minutes of
eager compiles, on two workers).
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_zoo import CPU, _nd, _scaled, _zoo_pair


def _train(pkg, net, x, y, steps=2):
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9,
                                 "wd": 1e-4})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, snaps = [], []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(_nd(pkg, x)), _nd(pkg, y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.asnumpy().mean()))
        snaps.append({k: p.data().asnumpy()
                      for k, p in net.collect_params().items()})
    return losses, snaps


def test_small_densenet_gradients_match_jax():
    """The DenseNet blocks (BN, ReLU, 1x1 and 3x3 convolutions, Concat,
    the transition's average pool) at widths where fp32 is well
    conditioned: every gradient within 1e-5 of its tensor's largest, or
    1e-7 absolute (the stem BN's gamma gradient is ~1e-7, a cancelling
    sum)."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, 4).astype(np.float32)
    nets = {}
    for pkg in (mx, mt):
        net = pkg.gluon.model_zoo.vision.DenseNet(8, 4, [2, 2], classes=10)
        net.initialize(ctx=CPU) if pkg is mt else net.initialize()
        net(_nd(pkg, x))
        nets[pkg] = net
    for (k, p), q in zip(nets[mx].collect_params().items(),
                         nets[mt].collect_params().values()):
        q.set_data(_nd(mt, p.data().asnumpy()))
    grads = {}
    for pkg, net in nets.items():
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = loss_fn(net(_nd(pkg, x)), _nd(pkg, y))
        loss.backward()
        grads[pkg] = [p.grad().asnumpy() for p in
                      net.collect_params().values()
                      if p.grad_req != "null"]
    for got, want in zip(grads[mt], grads[mx]):
        err = float(np.abs(got - want).max())
        assert err <= max(1e-5 * float(np.abs(want).max()), 1e-7), err


_JAX_DENSENET = {}


@pytest.mark.parametrize("hybridize", [False, True])
def test_densenet121_trains_like_jax(hybridize):
    """Two steps of the Gluon loop on densenet121 at 32x32, batch 4.
    Step 1's loss is within 1e-5 of JAX's. The gradients of this net at
    this size are ill-conditioned in fp32 (the last stages' BatchNorms
    see 4 values a channel): the port's fp32 gradients differ from its
    own fp64 ones by up to 1e-3 of a tensor's largest, and JAX's by more,
    so step 2's loss is held within 1e-2. Hybridized equals eager in the
    port (one sequence of operators)."""
    jnet, tnet, x = _zoo_pair("densenet121", 32, batch=4, seed=3)
    y = np.random.RandomState(3).randint(0, 10, 4).astype(np.float32)
    if not _JAX_DENSENET:
        _JAX_DENSENET["losses"] = _train(mx, jnet, x, y)[0]
    jl = _JAX_DENSENET["losses"]
    if hybridize:
        tnet.hybridize()
    tl, ts = _train(mt, tnet, x, y)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[1], jl[1], rtol=1e-2)
    assert all(np.isfinite(v).all() for v in ts[-1].values())
    if hybridize:
        _, enet, _ = _zoo_pair("densenet121", 32, batch=4, seed=3)
        el, es = _train(mt, enet, x, y)
        np.testing.assert_allclose(tl, el, rtol=1e-6)
        for k in es[-1]:
            assert _scaled(ts[-1][k], es[-1][k]) <= 1e-6, k
