"""The NDArray autograd tape of the PyTorch port against the JAX package's.

The cases of ``tests/test_autograd.py`` — basic and chained backward,
several variables, head gradients, ``pause`` and ``BlockGrad`` inside
``record``, train/predict mode, ``grad_req`` write/add/null,
``autograd.grad`` (also with ``create_graph`` to the second and third
order, and across two variables), a non-differentiable path, a custom
``Function`` and a deep chain — each run through both packages on the
same numpy inputs, gradients compared. Then what only the port has to
show: a second backward without ``retain_graph`` raises (and with it
succeeds), an op outside ``record`` on a leaf builds no graph, and
in-place writes to a leaf between two recorded steps leave the next
backward right.

Tolerance: gradients within 1e-6 relative (1e-5 for the chain of 50
multiplications and the higher orders, whose products round in another
order).
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()


def _arr(pkg, a):
    a = np.asarray(a, np.float32)
    return pkg.nd.array(a, ctx=CPU) if pkg is mt else pkg.nd.array(a)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def _basic(pkg):
    x = _arr(pkg, [[1.0, 2.0], [3.0, 4.0]])
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad]


def _chain_and_reuse(pkg):
    x = _arr(pkg, [2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x + x * 3
    y.backward()
    return [x.grad]


def _multi_variable(pkg):
    a, b = _arr(pkg, [1.0, 2.0]), _arr(pkg, [3.0, 4.0])
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        c = (a * b).sum()
    c.backward()
    return [a.grad, b.grad]


def _head_grad(pkg):
    x = _arr(pkg, [1.0, 2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = 2 * x
    y.backward(_arr(pkg, [10.0, 100.0]))
    return [x.grad]


def _pause_and_stop_gradient(pkg):
    x = _arr(pkg, [3.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x
        with pkg.autograd.pause():
            z = y * 2
        w = y + pkg.nd.BlockGrad(y)
    assert not pkg.autograd.is_recording()
    w.backward()
    return [x.grad, z]


def _grad_req_add(pkg):
    x = _arr(pkg, [1.0])
    grad = _arr(pkg, [0.0])
    pkg.autograd.mark_variables([x], [grad], grad_reqs="add")
    for _ in range(3):
        with pkg.autograd.record():
            y = x * 2
        y.backward()
    return [grad]


def _grad_req_null(pkg):
    x, w = _arr(pkg, [1.0, 2.0]), _arr(pkg, [3.0, -1.0])
    gx, gw = _arr(pkg, [5.0, 5.0]), _arr(pkg, [5.0, 5.0])
    pkg.autograd.mark_variables([x, w], [gx, gw], grad_reqs=["null",
                                                               "write"])
    with pkg.autograd.record():
        y = (x * w).sum()
    y.backward()
    return [gx, gw]


def _grad_api(pkg):
    x = _arr(pkg, [2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x
    return [pkg.autograd.grad(y, x), x.grad]


def _nondiff_path(pkg):
    x = _arr(pkg, [1.0, 5.0, 3.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * pkg.nd.argmax(x).reshape((1,))).sum()
    y.backward()
    return [x.grad]


def _custom_function(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = pkg.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    x = _arr(pkg, [0.0, 1.0, -2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = Sigmoid()(x) * 3
    y.backward()
    return [y, x.grad]


def _deep_chain(pkg):
    x = _arr(pkg, [1.001])
    x.attach_grad()
    with pkg.autograd.record():
        y = x
        for _ in range(50):
            y = y * 1.01
    y.backward()
    return [x.grad]


def _second_order(pkg):
    x = _arr(pkg, [1.0, 2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = (x ** 3).sum()
        g1 = pkg.autograd.grad(y, [x], create_graph=True)[0]
        z = (g1 * g1).sum()
    z.backward()
    return [g1, x.grad]


def _third_order(pkg):
    x = _arr(pkg, [2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = (x ** 4).sum()
        g1 = pkg.autograd.grad(y, [x], create_graph=True)[0]
        g2 = pkg.autograd.grad(g1.sum(), [x], create_graph=True)[0]
        w = g2.sum()
    w.backward()
    return [g2, x.grad]


def _mixed_partials(pkg):
    a, b = _arr(pkg, [1.5]), _arr(pkg, [0.5])
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        y = (a * a * b).sum()
        ga = pkg.autograd.grad(y, [a], create_graph=True)[0]
        s = ga.sum()
    s.backward()
    return [a.grad, b.grad]


def _retain_graph(pkg):
    x = _arr(pkg, [1.0, -2.0])
    x.attach_grad()
    with pkg.autograd.record():
        y = (pkg.nd.exp(x) * x).sum()
    y.backward(retain_graph=True)
    first = x.grad.copy()
    y.backward()
    return [first, x.grad]


def _indexing_and_ops(pkg):
    x = _arr(pkg, np.arange(12).reshape(3, 4) / 7.0)
    x.attach_grad()
    with pkg.autograd.record():
        rows = pkg.nd.slice_axis(x, axis=0, begin=1, end=3)
        first = pkg.nd.take(x, _arr(pkg, [0.0]))
        y = (pkg.nd.relu(rows - 0.5) * first).sum(axis=1)
        z = pkg.nd.softmax(y).max() + x.mean()
    z.backward()
    return [z, x.grad]


CASES = {"basic": _basic, "chain_and_reuse": _chain_and_reuse,
         "multi_variable": _multi_variable, "head_grad": _head_grad,
         "pause_and_stop_gradient": _pause_and_stop_gradient,
         "grad_req_add": _grad_req_add, "grad_req_null": _grad_req_null,
         "grad_api": _grad_api, "nondiff_path": _nondiff_path,
         "custom_function": _custom_function, "deep_chain": _deep_chain,
         "second_order": _second_order, "third_order": _third_order,
         "mixed_partials": _mixed_partials, "retain_graph": _retain_graph,
         "indexing_and_ops": _indexing_and_ops}
_LOOSE = {"deep_chain", "second_order", "third_order"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_case_matches_jax(name):
    jout = CASES[name](mx)
    tout = CASES[name](mt)
    for t, j in zip(tout, jout):
        _close(t.asnumpy(), j.asnumpy(), 1e-5 if name in _LOOSE else 1e-6)


def test_train_vs_predict_mode():
    ag = mt.autograd
    assert not ag.is_training() and not ag.is_recording()
    with ag.record(train_mode=True):
        assert ag.is_training() and ag.is_recording()
        with ag.predict_mode():
            assert not ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
    with ag.record(train_mode=False):
        assert not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()


def test_second_backward_without_retain_graph_raises():
    x = _arr(mt, [1.0, 2.0])
    x.attach_grad()
    with mt.autograd.record():
        y = (mt.nd.exp(x) * x).sum()
    y.backward()
    with pytest.raises(mt.MXNetError):
        y.backward()
    with pytest.raises(mt.MXNetError):
        _arr(mt, [1.0]).backward()      # never recorded


def test_grad_requires_attached_variables():
    x = _arr(mt, [1.0])
    with mt.autograd.record():
        y = x * 2
    with pytest.raises(mt.MXNetError):
        mt.autograd.grad(y, x)


def test_ops_outside_record_build_no_graph():
    """A leaf's own tensor never requires grad, so an op on it outside
    ``record`` keeps no graph; under ``pause`` the same; a recorded
    output used outside ``record`` is read detached."""
    x = _arr(mt, [1.0, 2.0])
    x.attach_grad()
    assert not x._data.requires_grad
    assert not (x * 2)._data.requires_grad
    with mt.autograd.record():
        y = x * 2
        with mt.autograd.pause():
            assert not (y + 1)._data.requires_grad
    assert y._data.requires_grad
    assert not (y * 3)._data.requires_grad


def test_inplace_writes_to_leaf_between_recorded_steps():
    """``w -= lr * grad`` and ``w[:] = ...`` between recorded steps write
    the leaf's storage in place (legal: its own tensor needs no grad);
    each next gradient is taken at the new value, as in the JAX package.
    (There ``w -= ...`` outside ``record`` would drop the leaf's tape
    mark, ROADMAP; its side writes through ``w[:]`` instead.)"""
    outs = []
    for pkg in (mx, mt):
        w = _arr(pkg, [1.0, -0.5, 2.0])
        w.attach_grad()
        grads = []
        for step in range(3):
            with pkg.autograd.record():
                loss = (w * w * w).sum()
            loss.backward()
            grads.append(w.grad.asnumpy().copy())
            if step == 0 and pkg is mt:
                w -= 0.1 * w.grad
            elif step == 0:
                w[:] = (w - 0.1 * w.grad).asnumpy()
            else:
                w[:] = w.asnumpy() * 0.5
        assert w._grad_req == "write" if pkg is mt else True
        outs.append(grads + [w.asnumpy()])
    for t, j in zip(outs[1], outs[0]):
        _close(t, j)
