"""``mx.operator`` of the PyTorch port against the JAX package's.

The same Python ops (``CustomOp``/``CustomOpProp`` pairs registered in
both packages, and the legacy ``NumpyOp``) run through ``nd.Custom``
eagerly, under ``autograd.record``, in ``sym`` graphs and in
``Module.fit`` (examples/numpy-ops/custom_softmax.py's model); outputs
within 1e-5 of the largest, gradients and trained weights within 1e-4.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()


def _ctx(pkg):
    return CPU if pkg is mt else mx.cpu()


def _register(pkg):
    """examples/numpy-ops/custom_softmax.py's op and a scaled square with
    two inputs and a parameter, in ``pkg``."""
    class Softmax(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], pkg.nd.array(y, ctx=_ctx(pkg)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], pkg.nd.array(y, ctx=_ctx(pkg)))

    @pkg.operator.register("test_softmax")
    class SoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class ScaledMul(pkg.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data[0].asnumpy(), in_data[1].asnumpy()
            self.assign(out_data[0], req[0], self.scale * a * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data[0].asnumpy(), in_data[1].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], self.scale * g * b)
            self.assign(in_grad[1], req[1], self.scale * g * a)

    @pkg.operator.register("test_scaled_mul")
    class ScaledMulProp(pkg.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, shapes, dtypes):
            return ScaledMul(self.scale)


_register(mx)
_register(mt)


def _close(got, want, tol=1e-5):
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def _pair(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(3, 4).astype(np.float32),
            rs.randn(3, 4).astype(np.float32))


def test_registry_and_surface():
    assert "test_softmax" in mt.operator.get_all_registered()
    for name in ("CustomOp", "CustomOpProp", "register",
                 "get_all_registered", "PythonOp", "NumpyOp", "NDArrayOp"):
        assert hasattr(mt.operator, name)
    with pytest.raises(mt.MXNetError):
        mt.nd.Custom(mt.nd.zeros((2, 2), ctx=CPU), op_type="no_such_op")


def test_nd_custom_eager():
    a, b = _pair(0)
    got = mt.nd.Custom(mt.nd.array(a, ctx=CPU), mt.nd.array(b, ctx=CPU),
                       op_type="test_scaled_mul", scale=2.5).asnumpy()
    want = mx.nd.Custom(mx.nd.array(a), mx.nd.array(b),
                        op_type="test_scaled_mul", scale=2.5).asnumpy()
    _close(got, want)


def _recorded(pkg, a, b):
    ctx = _ctx(pkg)
    xa, xb = pkg.nd.array(a, ctx=ctx), pkg.nd.array(b, ctx=ctx)
    xa.attach_grad()
    xb.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.Custom(xa, xb, op_type="test_scaled_mul", scale=0.5)
        z = (y * y).sum()
    z.backward()
    return y.asnumpy(), xa.grad.asnumpy(), xb.grad.asnumpy()


def test_custom_under_autograd_record():
    a, b = _pair(1)
    for g, w in zip(_recorded(mt, a, b), _recorded(mx, a, b)):
        _close(g, w, 1e-4)


def _sym_grads(pkg, a, b):
    ctx = _ctx(pkg)
    s = pkg.sym.Custom(pkg.sym.Variable("a"), pkg.sym.Variable("b"),
                       op_type="test_scaled_mul", scale=3.0, name="sm")
    exe = s.simple_bind(ctx, a=a.shape, b=b.shape)
    exe.arg_dict["a"][:] = a
    exe.arg_dict["b"][:] = b
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward(pkg.nd.array(np.ones_like(a), ctx=ctx))
    return out, exe.grad_dict["a"].asnumpy(), exe.grad_dict["b"].asnumpy()


def test_custom_in_a_symbol_graph():
    a, b = _pair(2)
    for g, w in zip(_sym_grads(mt, a, b), _sym_grads(mx, a, b)):
        _close(g, w, 1e-4)
    s = mt.sym.Custom(mt.sym.Variable("a"), mt.sym.Variable("b"),
                      op_type="test_scaled_mul", name="sm")
    assert s.list_outputs() == ["sm_output"]
    assert s.infer_shape(a=(3, 4), b=(3, 4))[1] == [(3, 4)]


def _fit(pkg, x, y, w0):
    ctx = _ctx(pkg)
    it = pkg.io.NDArrayIter(x, y, batch_size=16,
                            label_name="softmax_label")
    net = pkg.sym.Custom(pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                                num_hidden=3, name="fc"),
                         pkg.sym.Variable("softmax_label"),
                         op_type="test_softmax", name="softmax")
    mod = pkg.mod.Module(net, context=ctx)
    mod.fit(it, optimizer="sgd",
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in w0.items()},
            optimizer_params={"learning_rate": 0.2,
                              "rescale_grad": 1.0 / 16},
            num_epoch=2, eval_metric="acc")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_custom_softmax_example_trains_in_module():
    """custom_softmax.py's model: 2 epochs of 4 batches of 16 in both
    packages from the same weights."""
    rs = np.random.RandomState(0)
    centers = rs.uniform(-2, 2, size=(3, 10)).astype(np.float32)
    y = rs.randint(0, 3, 64)
    x = (centers[y] + 0.3 * rs.normal(size=(64, 10))).astype(np.float32)
    w0 = {"fc_weight": (rs.randn(3, 10) * 0.1).astype(np.float32),
          "fc_bias": np.zeros(3, np.float32)}
    got = _fit(mt, x, y.astype(np.float32), w0)
    want = _fit(mx, x, y.astype(np.float32), w0)
    for k in w0:
        _close(got[k], want[k], 1e-4)
    assert np.abs(got["fc_weight"] - w0["fc_weight"]).max() > 1e-3


class _Square:
    """A legacy NumpyOp: forward x**2, backward 2 x g."""

    @staticmethod
    def make(pkg):
        class Square(pkg.operator.NumpyOp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def forward(self, in_data, out_data):
                out_data[0][:] = in_data[0] ** 2

            def backward(self, out_grad, in_data, out_data, in_grad):
                in_grad[0][:] = 2 * in_data[0] * out_grad[0]
        return Square()


def test_legacy_numpy_op():
    x = np.random.RandomState(3).randn(2, 5).astype(np.float32)
    res = {}
    for pkg in (mx, mt):
        ctx = _ctx(pkg)
        s = _Square.make(pkg)(pkg.sym.Variable("x"), name="sq")
        exe = s.simple_bind(ctx, x=x.shape)
        exe.arg_dict["x"][:] = x
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(pkg.nd.array(np.full_like(x, 0.5), ctx=ctx))
        res[pkg] = out, exe.grad_dict["x"].asnumpy()
    for g, w in zip(res[mt], res[mx]):
        _close(g, w)
    _close(res[mt][1], x)
