"""CTC of the PyTorch port against the JAX package's.

The ``_ctc_loss`` op (aliases ``ctc_loss``, ``_contrib_ctc_loss``,
``_contrib_CTCLoss``) and ``gluon.loss.CTCLoss`` in both layouts, on the
same numpy activations and labels: labels padded with 0 and with -1,
``data_lengths`` and ``label_lengths``, repeated labels, and an
alignment that cannot exist (JAX's -1e30 stands for log 0, so its loss
is near 1e30, where ``F.ctc_loss`` gives inf). Losses within 1e-5 of the
largest, input gradients (``jax.grad`` against ``torch.autograd``) within
1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.ops.registry import get_op as port_op

CPU = mt.cpu()


def _inputs(seed, N=4, T=12, C=6, L=4, pad=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, T, C).astype(np.float32)
    lab = rs.randint(1, C, (N, L)).astype(np.float32)
    lab[1, L - 1] = pad
    lab[2, L - 2:] = pad
    lab[3, 1] = lab[3, 0]                     # a repeated label
    return x, lab


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def _both(arrays):
    """The loss and d(sum(loss * w))/d(data) of each package."""
    w = np.linspace(0.5, 1.5, arrays[0].shape[0]).astype(np.float32)

    def f(x):
        rest = [jnp.asarray(a) for a in arrays[1:]]
        return jnp.sum(jax_op("_ctc_loss").fn(x, *rest) * w)

    x = jnp.asarray(arrays[0])
    want = np.asarray(jax_op("_ctc_loss").fn(
        x, *[jnp.asarray(a) for a in arrays[1:]]))
    want_g = np.asarray(jax.grad(f)(x))
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0].requires_grad_(True)
    got = port_op("_ctc_loss").fn(*ts)
    (got * torch.from_numpy(w)).sum().backward()
    return (got.detach().numpy(), want), (ts[0].grad.numpy(), want_g)


@pytest.mark.parametrize("pad", [0, -1])
def test_ctc_loss_padding(pad):
    (got, want), (g, wg) = _both(list(_inputs(0, pad=pad)))
    _close(got, want, 1e-5)
    _close(g, wg, 1e-4)


def test_ctc_loss_with_lengths():
    x, lab = _inputs(1, T=15)
    data_len = np.array([15, 9, 12, 6], np.float32)
    lab_len = np.array([4, 3, 1, 2], np.float32)
    (got, want), (g, wg) = _both([x, lab, data_len, lab_len])
    _close(got, want, 1e-5)
    _close(g, wg, 1e-4)
    # frames past a sequence's end get no gradient
    assert np.abs(g[3, 6:]).max() == 0.0
    (got, want), (g, wg) = _both([x, lab, data_len])
    _close(got, want, 1e-5)
    _close(g, wg, 1e-4)


def test_ctc_infeasible_alignment_gives_jax_value():
    """Three labels with a repeat need 4 frames; 3 cannot align: the loss
    is JAX's ~1e30, not inf, and finite for the feasible rows."""
    x, lab = _inputs(2, T=3, L=3)
    lab[0] = [2, 2, 3]
    (got, want), _ = _both([x, lab])
    assert np.isfinite(got).all()
    assert want[0] > 1e29 and got[0] > 1e29
    assert (want[1:3] < 1e3).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ctc_aliases_share_the_op():
    for name in ("ctc_loss", "_contrib_ctc_loss", "_contrib_CTCLoss"):
        assert port_op(name) is port_op("_ctc_loss")
    x, lab = _inputs(3)
    got = mt.nd.contrib.ctc_loss(mt.nd.array(x, ctx=CPU),
                                 mt.nd.array(lab, ctx=CPU)).asnumpy()
    want = mx.nd.contrib.ctc_loss(mx.nd.array(x), mx.nd.array(lab)).asnumpy()
    _close(got, want, 1e-5)


def _gluon(pkg, layout, label_layout, x, lab, *lengths, hybridize=False):
    ctx = CPU if pkg is mt else mx.cpu()
    loss = pkg.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout)
    if hybridize:
        loss.hybridize()
    xs = pkg.nd.array(x, ctx=ctx)
    xs.attach_grad()
    args = [pkg.nd.array(a, ctx=ctx) if a is not None else None
            for a in lengths]
    with pkg.autograd.record():
        out = loss(xs, pkg.nd.array(lab, ctx=ctx), *args)
    out.backward()
    return out.asnumpy(), xs.grad.asnumpy()


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN"),
                                                 ("TNC", "NT")])
@pytest.mark.parametrize("hybridize", [False, True])
def test_gluon_ctc_loss_layouts(layout, label_layout, hybridize):
    x, lab = _inputs(4)
    if layout == "TNC":
        x = np.ascontiguousarray(x.swapaxes(0, 1))
    if label_layout == "TN":
        lab = np.ascontiguousarray(lab.swapaxes(0, 1))
    got, g = _gluon(mt, layout, label_layout, x, lab, hybridize=hybridize)
    want, wg = _gluon(mx, layout, label_layout, x, lab)
    _close(got, want, 1e-5)
    _close(g, wg, 1e-4)


def test_gluon_ctc_loss_lengths():
    """Both lengths as the JAX package's; ``label_lengths`` alone counts
    each label from its row over the whole sequence (the JAX package
    passes it where the op reads ``data_lengths``: held here against its
    op given every sequence's full length)."""
    x, lab = _inputs(5, T=10)
    dl = np.array([10, 7, 8, 9], np.float32)
    ll = np.array([4, 3, 2, 4], np.float32)
    got, g = _gluon(mt, "NTC", "NT", x, lab, dl, ll)
    want, wg = _gluon(mx, "NTC", "NT", x, lab, dl, ll)
    _close(got, want, 1e-5)
    _close(g, wg, 1e-4)
    got, _ = _gluon(mt, "NTC", "NT", x, lab, None, ll)
    full = np.full(4, 10, np.float32)
    want = np.asarray(jax_op("_ctc_loss").fn(*map(jnp.asarray,
                                                  (x, lab, full, ll))))
    _close(got, want, 1e-5)


def test_ctc_seq_train_model_step_matches_jax():
    """examples/warpctc/ctc_seq_train.py's graph at a narrow width (an
    LSTM of 12 over 8 frames, ``sym.contrib.ctc_loss`` under
    ``MakeLoss``): one Module step in both packages from the same
    weights."""
    T, L, C, F, H, B = 8, 3, 6, 5, 12, 4
    rs = np.random.RandomState(6)
    x = rs.randn(B, T, F).astype(np.float32)
    lab = rs.randint(1, C, (B, L)).astype(np.float32)

    def build(pkg):
        data, label = pkg.sym.Variable("data"), pkg.sym.Variable("label")
        cell = pkg.rnn.LSTMCell(num_hidden=H, prefix="lstm_")
        outs, _ = cell.unroll(T, data, layout="NTC", merge_outputs=True)
        h = pkg.sym.Reshape(outs, shape=(-1, H))
        h = pkg.sym.FullyConnected(h, num_hidden=C, name="fc_out")
        logits = pkg.sym.Reshape(h, shape=(-1, T, C), name="logits")
        return pkg.sym.MakeLoss(pkg.sym.contrib.ctc_loss(logits, label),
                                name="ctc")

    arg = None
    results = {}
    for pkg in (mx, mt):
        ctx = CPU if pkg is mt else mx.cpu()
        mod = pkg.mod.Module(build(pkg), data_names=["data", "label"],
                             label_names=[], context=ctx)
        mod.bind([("data", x.shape), ("label", lab.shape)], None)
        if arg is None:
            shapes = dict(zip(mod._symbol.list_arguments(),
                              mod._symbol.infer_shape(
                                  data=x.shape, label=lab.shape)[0]))
            arg = {k: (rs.randn(*s) * 0.3).astype(np.float32)
                   for k, s in shapes.items() if k not in ("data", "label")}
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                    for k, v in arg.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(x, ctx=ctx), pkg.nd.array(lab, ctx=ctx)], []))
        loss = mod.get_outputs()[0].asnumpy()
        mod.update()
        results[pkg] = loss, {k: v.asnumpy()
                              for k, v in mod.get_params()[0].items()}
    _close(results[mt][0], results[mx][0], 1e-5)
    for k in arg:
        _close(results[mt][1][k], results[mx][1][k], 1e-5)
