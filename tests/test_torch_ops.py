"""Operators of the PyTorch port against the JAX package's registry ops.

Same numpy inputs through both op functions; fp32 throughout. The JAX
side runs with ``jax_default_matmul_precision="highest"`` (conftest).
Convolutions agree to rtol 1e-4: both sum in fp32 but in different
orders (oneDNN here, XLA there), and the JAX 7x7/s2 channels-last stem
runs its space-to-depth rewrite, exact only up to rounding.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.registry import get_op as jax_get_op

from mxnet_tpu_torch.ops.registry import get_op as port_get_op
from torch_threads import one_torch_thread  # noqa: F401


def _run(name, arrays, **params):
    want = jax_get_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    got = port_get_op(name).fn(*[torch.from_numpy(a) for a in arrays],
                               **params)
    if isinstance(want, tuple):
        want, got = want[0], got[0]
    return np.asarray(want), got.numpy()


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


CONV_CASES = [
    # (data shape, weight shape, params)
    ((2, 9, 9, 5), (8, 3, 3, 5),
     dict(kernel=(3, 3), pad=(1, 1), num_filter=8, no_bias=True,
          layout="NHWC")),
    ((2, 9, 9, 8), (16, 1, 1, 8),
     dict(kernel=(1, 1), stride=(2, 2), num_filter=16, no_bias=False,
          layout="NHWC")),
    ((2, 5, 9, 9), (6, 5, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=6,
          no_bias=False)),
    ((2, 8, 8, 4), (8, 3, 3, 2),
     dict(kernel=(3, 3), pad=(1, 1), num_filter=8, num_group=2,
          no_bias=True, layout="NHWC")),
    # the ResNet stem: 7x7/s2 with C=3 (JAX: space-to-depth rewrite)
    ((2, 32, 32, 3), (16, 7, 7, 3),
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=16,
          no_bias=True, layout="NHWC")),
]


@pytest.mark.parametrize("dshape,wshape,params", CONV_CASES)
def test_convolution(dshape, wshape, params):
    rs = np.random.RandomState(0)
    arrays = [_rand(rs, *dshape), _rand(rs, *wshape)]
    if not params["no_bias"]:
        arrays.append(_rand(rs, params["num_filter"]))
    want, got = _run("Convolution", arrays, **params)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


POOL_CASES = [
    ((2, 9, 9, 4), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max", layout="NHWC")),
    ((2, 4, 9, 9), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max")),
    ((2, 7, 7, 4), dict(kernel=(1, 1), global_pool=True, pool_type="avg",
                        layout="NHWC")),
    ((2, 4, 7, 7), dict(kernel=(1, 1), global_pool=True, pool_type="max")),
    ((2, 10, 10, 3), dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
                          pooling_convention="full", layout="NHWC")),
    ((2, 3, 10, 10), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="avg", pooling_convention="full")),
    ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2), pool_type="sum")),
    ((2, 8, 8, 3), dict(kernel=(5, 5), stride=(1, 1), pad=(3, 3),
                        pool_type="max", layout="NHWC")),
]


@pytest.mark.parametrize("dshape,params", POOL_CASES)
def test_pooling(dshape, params):
    rs = np.random.RandomState(1)
    want, got = _run("Pooling", [_rand(rs, *dshape)], **params)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis,shape", [(-1, (2, 5, 5, 6)), (1, (2, 6, 5, 5))])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_inference(axis, shape, fix_gamma):
    rs = np.random.RandomState(2)
    c = shape[axis]
    arrays = [_rand(rs, *shape), _rand(rs, c), _rand(rs, c), _rand(rs, c),
              (rs.rand(c) + 0.5).astype(np.float32)]
    want, got = _run("BatchNorm", arrays, eps=1e-5, axis=axis,
                     fix_gamma=fix_gamma, _train=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flatten,no_bias", [(True, False), (False, True),
                                             (True, True)])
def test_fully_connected(flatten, no_bias):
    rs = np.random.RandomState(3)
    data = _rand(rs, 3, 1, 1, 8)
    in_units = 8
    arrays = [data, _rand(rs, 5, in_units)]
    if not no_bias:
        arrays.append(_rand(rs, 5))
    want, got = _run("FullyConnected", arrays, num_hidden=5, flatten=flatten,
                     no_bias=no_bias)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    rs = np.random.RandomState(4)
    want, got = _run("Activation", [_rand(rs, 4, 7)], act_type=act)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_flatten_elemwise_add_softmax_output():
    rs = np.random.RandomState(5)
    x = _rand(rs, 2, 3, 3, 4)
    want, got = _run("Flatten", [x])
    np.testing.assert_array_equal(got, want)
    want, got = _run("elemwise_add", [x, _rand(rs, 2, 3, 3, 4)])
    np.testing.assert_array_equal(got, want)
    logits = _rand(rs, 4, 10)
    want, got = _run("SoftmaxOutput", [logits, np.zeros(4, np.float32)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_reverse_and_flip_without_axis_flip_every_axis():
    """ROADMAP Queue 3 fault 1 (PR 16): ``reverse``/``flip`` with no axis
    (or ``axis=()``) flip every axis, as the JAX package's
    ``jnp.flip(data, None)`` does; the port raised a TypeError."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as mt
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for fn in ("reverse", "flip"):
        want = getattr(mx.nd, fn)(mx.nd.array(x)).asnumpy()
        got = getattr(mt.nd, fn)(mt.nd.array(x, ctx=mt.cpu())).asnumpy()
        np.testing.assert_array_equal(got, want)
        got = getattr(mt.nd, fn)(mt.nd.array(x, ctx=mt.cpu()),
                                 axis=()).asnumpy()
        np.testing.assert_array_equal(got, want)
    want = mx.sym.reverse(mx.sym.Variable("x")).eval(
        x=mx.nd.array(x))[0].asnumpy()
    got = mt.sym.reverse(mt.sym.Variable("x")).eval(
        ctx=mt.cpu(), x=mt.nd.array(x, ctx=mt.cpu()))[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, x[::-1, ::-1, ::-1])
