"""Step 1 of the Gluon zoo's ``densenet121`` in the PyTorch port against
the JAX package, parameter by parameter (split from
``tests/test_torch_zoo_training.py``, which trains it for 2 steps, so
that pytest-xdist runs the two JAX densenet121 computations on two
workers).

fp32 is ill-conditioned at 32x32, batch 4, so both packages step in
fp64 (JAX under ``jax.enable_x64``), then the port's fp32 step is held
against its own fp64 one.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_zoo import CPU, _zoo_pair


def _step(pkg, net, x, y, dtype, ctx=None):
    """One step of the Gluon loop in ``dtype``: the weights after it."""
    kw = {"ctx": ctx} if ctx is not None else {}
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9,
                                 "wd": 1e-4})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        loss = loss_fn(net(pkg.nd.array(x, dtype=dtype, **kw)),
                       pkg.nd.array(y, dtype=dtype, **kw))
    loss.backward()
    trainer.step(x.shape[0])
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _off_update(got, want, w0, rel, ulps):
    """The tensors of ``got`` farther from ``want`` than ``rel`` of the
    step's update on that tensor (``want - w0``) plus ``ulps`` of its
    largest |value|."""
    bad = []
    for k, w in want.items():
        lim = rel * float(np.abs(w - w0[k]).max()) \
            + ulps * float(np.abs(w).max())
        if float(np.abs(got[k].astype(np.float64) - w).max()) > lim:
            bad.append(k)
    return bad


_JAX64_DENSENET = {}


@pytest.mark.parametrize("hybridize", [False, True])
def test_densenet121_step1_params_match_jax(hybridize):
    """Step 1 of densenet121 (32x32, batch 4) parameter by parameter,
    BN shifts and running statistics included. fp32 is ill-conditioned
    at this size (JAX's fp32 update on ``stage3_conv2d42_weight`` is 17%
    off the fp64 one), so both packages step in fp64: every tensor
    within 1e-6 of its own update of JAX's, plus 4 fp64 ulps of its
    largest |value|. The port's fp32 step is held to its own fp64 one:
    within 5e-2 of each tensor's update plus 4 fp32 ulps (at most 1.5e-2
    measured on the CPU). Control: on every tensor a dropped update, and
    one of the opposite sign, fails both limits."""
    eps32, eps64 = np.finfo(np.float32).eps, np.finfo(np.float64).eps
    jnet, tnet, x = _zoo_pair("densenet121", 32, batch=4, seed=3)
    y = np.random.RandomState(3).randint(0, 10, 4).astype(np.float32)
    w0 = {k: p.data().asnumpy().astype(np.float64)
          for k, p in tnet.collect_params().items()}
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    if not _JAX64_DENSENET:
        with jax.enable_x64(True):
            jnet.cast("float64")
            _JAX64_DENSENET.update(_step(mx, jnet, x64, y64, "float64"))
    want = _JAX64_DENSENET
    _, tnet32, _ = _zoo_pair("densenet121", 32, batch=4, seed=3)
    tnet.cast("float64")
    if hybridize:
        tnet.hybridize()
        tnet32.hybridize()
    got64 = _step(mt, tnet, x64, y64, "float64", CPU)
    assert all(v.dtype == np.float64 for v in got64.values())
    assert _off_update(got64, want, w0, 1e-6, 4 * eps64) == []
    got32 = _step(mt, tnet32, x, y, "float32", CPU)
    assert _off_update(got32, got64, w0, 5e-2, 4 * eps32) == []
    dropped = {k: w0[k] for k in want}
    flipped = {k: 2 * w0[k] - want[k] for k in want}
    for bad in (dropped, flipped):
        assert _off_update(bad, want, w0, 1e-6, 4 * eps64) == list(want)
        assert _off_update(bad, got64, w0, 5e-2, 4 * eps32) == list(want)
