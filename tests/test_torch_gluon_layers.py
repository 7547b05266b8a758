"""The port's new ``gluon.nn`` blocks against the JAX package's:
Conv1D/2D/3DTranspose, InstanceNorm, LayerNorm, LeakyReLU, Lambda and
HybridLambda, each unhybridized and hybridized.

Each block is built in both packages under the same prefix, its
parameters drawn once by the JAX package (deferred shapes filled by a
first call) and carried to the port by name
(``weights.load_into_block``); then the forward and the gradients of
``sum(out * cotangent)`` with respect to the input and every parameter
are compared: within 1e-5 of each array's largest |value| (measured
gaps up to 3.9e-7), bit-equal for the elementwise blocks.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()
TOL = 1e-5

_BLOCKS = [
    ("conv1d_transpose", lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="ct1_"),
     (2, 3, 7), False),
    ("conv2d_transpose", lambda nn: nn.Conv2DTranspose(
        5, (4, 3), strides=(2, 1), padding=(1, 0), prefix="ct2_"),
     (2, 3, 5, 6), False),
    ("conv2d_transpose_groups", lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, groups=2, use_bias=False, activation="relu",
        prefix="ct2g_"), (1, 4, 4, 4), False),
    ("conv3d_transpose", lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, dilation=1, in_channels=3, prefix="ct3_"),
     (1, 3, 3, 2, 3), False),
    ("instance_norm", lambda nn: nn.InstanceNorm(scale=True,
                                                 prefix="in_"),
     (2, 3, 4, 5), False),
    ("layer_norm", lambda nn: nn.LayerNorm(prefix="ln_"), (2, 5, 6),
     False),
    ("layer_norm_axis1", lambda nn: nn.LayerNorm(axis=1, center=False,
                                                 prefix="ln1_"),
     (2, 5, 6), False),
    ("leaky_relu", lambda nn: nn.LeakyReLU(0.15, prefix="lr_"), (3, 7),
     True),
    ("hybrid_lambda_name", lambda nn: nn.HybridLambda("tanh",
                                                       prefix="hl_"),
     (3, 4), False),
    ("hybrid_lambda_fn", lambda nn: nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x * 2, slope=0.3), prefix="hlf_"),
     (3, 4), True),
]


def _run(pkg, make, shape, params, hybridize, seed=0):
    ctx = {"ctx": CPU} if pkg is mt else {}
    rs = np.random.RandomState(seed)
    x0 = rs.uniform(-1, 1, shape).astype(np.float32)
    blk = make(pkg.gluon.nn)
    if params is None:              # the JAX side draws the parameters
        np.random.seed(1)
        blk.initialize(pkg.init.Xavier())
        blk(pkg.nd.array(x0))
    else:
        mt.weights.load_into_block(blk, params, ctx=CPU)
    if hybridize:
        blk.hybridize()
    x = pkg.nd.array(x0, **ctx)
    x.attach_grad()
    with pkg.autograd.record():
        out = blk(x)
    head = rs.uniform(-1, 1, out.shape).astype(np.float32)
    out.backward(pkg.nd.array(head, **ctx))
    ps = blk.collect_params()
    grads = {k: p.grad().asnumpy() for k, p in ps.items()
             if p.grad_req != "null"}
    return blk, out.asnumpy(), x.grad.asnumpy(), grads


def _gap(a, b):
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / (scale or 1.0)


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name,make,shape,exact", _BLOCKS,
                         ids=[b[0] for b in _BLOCKS])
def test_block_matches_jax(name, make, shape, exact, hybridize):
    jblk, jout, jdx, jgrads = _run(mx, make, shape, None, hybridize)
    params = {k: p.data().asnumpy()
              for k, p in jblk.collect_params().items()}
    _, tout, tdx, tgrads = _run(mt, make, shape, params, hybridize)
    assert sorted(tgrads) == sorted(jgrads)
    pairs = [(tout, jout), (tdx, jdx)] + [(tgrads[k], jgrads[k])
                                          for k in jgrads]
    for got, want in pairs:
        assert got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert _gap(got, want) <= TOL, _gap(got, want)


def test_lambda_blocks():
    """``nn.Lambda`` takes an ``mx.nd`` function name or a callable;
    an unknown name raises, as in the JAX package."""
    x0 = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    for fn in ("tanh", lambda x: x * 3 + 1):
        j = mx.gluon.nn.Lambda(fn)(mx.nd.array(x0)).asnumpy()
        t = mt.gluon.nn.Lambda(fn)(mt.nd.array(x0, ctx=CPU)).asnumpy()
        assert _gap(t, j) <= 1e-6
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.gluon.nn.Lambda("no_such_function")
    assert repr(mt.gluon.nn.HybridLambda("tanh")) == "HybridLambda(tanh)"


def test_transposed_conv_layout_and_shapes():
    """The weight is (in_channels, channels/groups, *kernel) and infers
    its in_channels at the first call; channels-last raises."""
    blk = mt.gluon.nn.Conv2DTranspose(6, 3, groups=3, prefix="t_")
    blk.initialize(ctx=CPU)
    out = blk(mt.nd.zeros((1, 9, 5, 5), ctx=CPU))
    assert out.shape == (1, 6, 7, 7)
    assert blk.weight.shape == (9, 2, 3, 3)
    with pytest.raises(mt.MXNetError, match="channels-first"):
        mt.gluon.nn.Conv2DTranspose(4, 3, layout="NHWC")
