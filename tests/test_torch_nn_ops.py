"""The port's remaining ``ops/nn.py`` layers, ``Crop`` and the ``_v1``
aliases, and the ``linalg`` ops against the JAX package's.

Each case feeds the same numpy inputs (seeded) to ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd`` (on the CPU), in fp32, and compares the output
and, for the float inputs that take one, the gradient of ``sum(out *
cotangent)`` under both packages' ``autograd.record``. Tolerance: the
gap within 1e-5 of the largest |value| of each compared array, or
bit-equal where both are exact (copies, masks, selections, the loss
layers' fixed gradients). Each case's ``gap`` is the largest gap
measured on the CPU (relative to the largest |value|), kept beside it
as a record.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()
TOL = 1e-5


def _rs(seed=0):
    return np.random.RandomState(seed)


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    return float(np.abs(got - want).max()) / scale if scale else \
        float(np.abs(got - want).max())


def _run(pkg, op, inputs, kwargs, grad_idx, head, train=False):
    ctx = {"ctx": CPU} if pkg is mt else {}
    nds = [pkg.nd.array(a, dtype=a.dtype, **ctx) for a in inputs]
    for i in grad_idx:
        nds[i].attach_grad()
    fn = op(pkg) if callable(op) else getattr(pkg.nd, op)
    with pkg.autograd.record(train_mode=train):
        out = fn(*nds, **kwargs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    if grad_idx:
        hg = [pkg.nd.array(h, **ctx) for h in head(outs)]
        pkg.autograd.backward(outs, head_grads=hg)
    return [o.asnumpy() for o in outs], \
        [nds[i].grad.asnumpy() for i in grad_idx]


def _compare(op, inputs, kwargs=None, grad_idx=(0,), exact=False,
             train=False):
    kwargs = kwargs or {}
    rs = _rs(7)

    def head(outs):
        return [rs.uniform(-1, 1, o.shape).astype(np.float32)
                for o in outs]
    want = _run(mx, op, inputs, kwargs, grad_idx, head, train)
    rs = _rs(7)
    got = _run(mt, op, inputs, kwargs, grad_idx, head, train)
    worst = 0.0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            worst = max(worst, _gap(g, w))
    assert worst <= TOL, worst
    return worst


def _f(rs, *shape, lo=-2.0, hi=2.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


# (id, op, inputs builder, kwargs, grad_idx, exact, measured gap)
_CASES = [
    ("deconv1d", "Deconvolution",
     lambda r: [_f(r, 2, 3, 7), _f(r, 3, 4, 3)],
     dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=4), (0, 1), False,
     1.0e-07),
    ("deconv2d_bias", "Deconvolution",
     lambda r: [_f(r, 2, 3, 5, 6), _f(r, 3, 4, 4, 4), _f(r, 4)],
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=4,
          no_bias=False), (0, 1, 2), False, 2.5e-07),
    ("deconv2d_groups", "Deconvolution",
     lambda r: [_f(r, 2, 4, 5, 5), _f(r, 4, 3, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), num_filter=6, num_group=2),
     (0, 1), False, 1.7e-07),
    ("deconv2d_dilate", "Deconvolution",
     lambda r: [_f(r, 1, 3, 6, 5), _f(r, 3, 2, 3, 3)],
     dict(kernel=(3, 3), dilate=(2, 2), pad=(1, 2), num_filter=2), (0, 1),
     False, 1.7e-07),
    ("deconv2d_adj", "Deconvolution",
     lambda r: [_f(r, 2, 3, 4, 5), _f(r, 3, 2, 3, 3)],
     dict(kernel=(3, 3), stride=(3, 2), adj=(2, 1), pad=(1, 0),
          num_filter=2), (0, 1), False, 1.5e-07),
    ("deconv3d", "Deconvolution",
     lambda r: [_f(r, 1, 2, 3, 4, 3), _f(r, 2, 3, 2, 3, 2)],
     dict(kernel=(2, 3, 2), stride=(2, 1, 2), num_filter=3), (0, 1), False,
     2.8e-07),
    ("fcn_upscore", "Deconvolution",
     lambda r: [_f(r, 1, 5, 3, 3), _f(r, 5, 5, 32, 32)],
     dict(kernel=(32, 32), stride=(16, 16), num_filter=5), (0, 1), False,
     1.6e-06),
    ("leaky", "LeakyReLU", lambda r: [_f(r, 3, 4)],
     dict(act_type="leaky", slope=0.1), (0,), True, 0.0),
    ("elu", "LeakyReLU", lambda r: [_f(r, 3, 4)],
     dict(act_type="elu", slope=0.3), (0,), False, 9.4e-09),
    ("prelu", "LeakyReLU", lambda r: [_f(r, 2, 3, 4), _f(r, 3)],
     dict(act_type="prelu"), (0, 1), False, 7.5e-08),
    ("rrelu_eval", "LeakyReLU", lambda r: [_f(r, 3, 4)],
     dict(act_type="rrelu"), (0,), True, 0.0),
    ("l2norm_instance", "L2Normalization", lambda r: [_f(r, 2, 3, 4)],
     dict(mode="instance"), (0,), False, 9.8e-08),
    ("l2norm_channel", "L2Normalization", lambda r: [_f(r, 2, 3, 4)],
     dict(mode="channel"), (0,), False, 9.8e-08),
    ("l2norm_spatial", "L2Normalization", lambda r: [_f(r, 2, 3, 2, 2)],
     dict(mode="spatial"), (0,), False, 3.9e-08),
    ("instance_norm", "InstanceNorm",
     lambda r: [_f(r, 2, 3, 4, 5), _f(r, 3), _f(r, 3)],
     dict(eps=1e-3), (0, 1, 2), False, 2.0e-07),
    ("layer_norm", "LayerNorm",
     lambda r: [_f(r, 2, 3, 6), _f(r, 6), _f(r, 6)], {}, (0, 1, 2), False,
     1.5e-07),
    ("layer_norm_axis1", "LayerNorm",
     lambda r: [_f(r, 2, 3, 6), _f(r, 3), _f(r, 3)], dict(axis=1),
     (0, 1, 2), False, 2.7e-07),
    ("softmax_act_instance", "SoftmaxActivation",
     lambda r: [_f(r, 2, 3, 4)], {}, (0,), False, 8.7e-08),
    ("softmax_act_channel", "SoftmaxActivation",
     lambda r: [_f(r, 2, 3, 4)], dict(mode="channel"), (0,), False, 1.7e-07),
    ("softmax_cross_entropy", "softmax_cross_entropy",
     lambda r: [_f(r, 4, 5), r.randint(0, 5, (4,)).astype(np.float32)], {},
     (0,), False, 3.7e-08),
    ("linear_regression", "LinearRegressionOutput",
     lambda r: [_f(r, 4, 3), _f(r, 4, 3)], dict(grad_scale=0.5), (0,), True,
     0.0),
    ("mae_regression", "MAERegressionOutput",
     lambda r: [_f(r, 4, 3), _f(r, 4, 3)], {}, (0,), True, 0.0),
    ("logistic_regression", "LogisticRegressionOutput",
     lambda r: [_f(r, 4, 3), _f(r, 4, 3)], dict(grad_scale=2.0), (0,),
     False, 0.0),
    ("make_loss_null", "MakeLoss", lambda r: [_f(r, 4, 3)],
     dict(grad_scale=0.3), (0,), True, 0.0),
    ("make_loss_batch", "MakeLoss", lambda r: [_f(r, 4, 3)],
     dict(normalization="batch"), (0,), True, 0.0),
    ("make_loss_valid", "MakeLoss", lambda r: [_f(r, 4, 3)],
     dict(normalization="valid", valid_thresh=0.5), (0,), True, 0.0),
    ("svm_squared", "SVMOutput",
     lambda r: [_f(r, 4, 5), r.randint(0, 5, (4,)).astype(np.float32)],
     dict(margin=0.5), (0,), True, 0.0),
    ("svm_linear", "SVMOutput",
     lambda r: [_f(r, 4, 5), r.randint(0, 5, (4,)).astype(np.float32)],
     dict(use_linear=True, regularization_coefficient=0.7), (0,), True,
     0.0),
    ("upsampling_nearest", "UpSampling", lambda r: [_f(r, 2, 3, 3, 4)],
     dict(scale=2, sample_type="nearest"), (0,), True, 0.0),
    ("upsampling_concat", "UpSampling",
     lambda r: [_f(r, 1, 2, 4, 4), _f(r, 1, 3, 2, 2)],
     dict(scale=2, sample_type="nearest", num_args=2), (0, 1), True, 0.0),
    ("upsampling_sum", "UpSampling",
     lambda r: [_f(r, 1, 2, 4, 4), _f(r, 1, 2, 2, 2)],
     dict(scale=1, sample_type="nearest", multi_input_mode="sum",
          num_args=2), (0, 1), True, 0.0),
    ("upsampling_bilinear", "UpSampling",
     lambda r: [_f(r, 2, 3, 4, 4), _f(r, 3, 1, 4, 4)],
     dict(scale=2, sample_type="bilinear", num_filter=3, num_args=2),
     (0, 1), False, 1.2e-07),
    ("sequence_last", "SequenceLast", lambda r: [_f(r, 5, 3, 2)], {}, (0,),
     True, 0.0),
    ("sequence_last_len", "SequenceLast",
     lambda r: [_f(r, 5, 3, 2), np.array([2, 5, 1], np.float32)],
     dict(use_sequence_length=True), (0,), True, 0.0),
    ("sequence_last_axis1", "SequenceLast",
     lambda r: [_f(r, 3, 5, 2), np.array([4, 1, 5], np.float32)],
     dict(use_sequence_length=True, axis=1), (0,), True, 0.0),
    ("sequence_mask", "SequenceMask",
     lambda r: [_f(r, 5, 3, 2), np.array([2, 5, 1], np.float32)],
     dict(use_sequence_length=True, value=-1.5), (0,), True, 0.0),
    ("sequence_mask_axis1", "SequenceMask",
     lambda r: [_f(r, 3, 5), np.array([4, 1, 5], np.float32)],
     dict(use_sequence_length=True, axis=1), (0,), True, 0.0),
    ("sequence_reverse", "SequenceReverse",
     lambda r: [_f(r, 5, 3, 2), np.array([2, 5, 3], np.float32)],
     dict(use_sequence_length=True), (0,), True, 0.0),
    ("sequence_reverse_all", "SequenceReverse", lambda r: [_f(r, 4, 3)], {},
     (0,), True, 0.0),
    ("crop_offset", "Crop", lambda r: [_f(r, 2, 3, 6, 7)],
     dict(offset=(1, 2), h_w=(4, 3)), (0,), True, 0.0),
    ("crop_center", "Crop", lambda r: [_f(r, 2, 3, 6, 7)],
     dict(h_w=(3, 4), center_crop=True), (0,), True, 0.0),
    ("crop_like", "Crop", lambda r: [_f(r, 2, 3, 26, 26),
                                     _f(r, 2, 5, 24, 24)],
     dict(offset=(1, 1), num_args=2), (0,), True, 0.0),
    ("convolution_v1", "Convolution_v1",
     lambda r: [_f(r, 2, 3, 5, 5), _f(r, 4, 3, 3, 3), _f(r, 4)],
     dict(kernel=(3, 3), num_filter=4), (0, 1, 2), False, 1.5e-07),
    ("pooling_v1", "Pooling_v1", lambda r: [_f(r, 2, 3, 6, 6)],
     dict(kernel=(2, 2), stride=(2, 2)), (0,), True, 0.0),
    ("cudnn_batchnorm", "CuDNNBatchNorm",
     lambda r: [_f(r, 2, 3, 4), _f(r, 3), _f(r, 3), _f(r, 3),
                _f(r, 3, lo=0.5)],
     dict(fix_gamma=False), (0, 1, 2), False, 9.3e-08),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_nn_op_matches_jax(case):
    _, op, build, kwargs, grad_idx, exact, _measured = case
    _compare(op, build(_rs(3)), kwargs, grad_idx, exact)


def _lower(r, n, b=()):
    a = np.tril(r.uniform(-1, 1, b + (n, n))).astype(np.float32)
    idx = np.arange(n)
    a[..., idx, idx] = r.uniform(1.0, 2.0, b + (n,))
    return a


def _spd(r, n, b=()):
    m = r.uniform(-1, 1, b + (n, n)).astype(np.float32)
    return (m @ np.swapaxes(m, -1, -2) + n * np.eye(n)).astype(np.float32)


_LINALG = [
    ("gemm", "linalg_gemm",
     lambda r: [_f(r, 2, 3, 4), _f(r, 2, 3, 5), _f(r, 2, 4, 5)],
     dict(transpose_a=True, alpha=0.5, beta=2.0), (0, 1, 2), 1.1e-07),
    ("gemm2", "linalg_gemm2", lambda r: [_f(r, 3, 4), _f(r, 5, 4)],
     dict(transpose_b=True, alpha=1.5), (0, 1), 1.6e-07),
    ("potrf", "linalg_potrf", lambda r: [_spd(r, 4, (2,))], {}, (0,),
     7.4e-08),
    ("potri", "linalg_potri", lambda r: [_lower(r, 4)], {}, (0,), 4.7e-08),
    # (A's gradient: test_trmm_reads_only_the_lower_triangle)
    ("trmm", "linalg_trmm", lambda r: [_lower(r, 3), _f(r, 3, 4)],
     dict(alpha=2.0), (1,), 0.0),
    ("trmm_right_t", "linalg_trmm", lambda r: [_lower(r, 4), _f(r, 3, 4)],
     dict(rightside=True, transpose=True), (1,), 4.4e-08),
    ("trsm", "linalg_trsm", lambda r: [_lower(r, 3, (2,)),
                                       _f(r, 2, 3, 4)],
     dict(alpha=0.5), (0, 1), 2.0e-07),
    ("trsm_t", "linalg_trsm", lambda r: [_lower(r, 3), _f(r, 3, 2)],
     dict(transpose=True), (0, 1), 0.0),
    ("sumlogdiag", "linalg_sumlogdiag", lambda r: [_spd(r, 3, (2,))], {},
     (0,), 0.0),
    ("syrk", "linalg_syrk", lambda r: [_f(r, 3, 4)],
     dict(transpose=True, alpha=0.7), (0,), 7.4e-08),
]


@pytest.mark.parametrize("case", _LINALG, ids=[c[0] for c in _LINALG])
def test_linalg_op_matches_jax(case):
    _, op, build, kwargs, grad_idx, _measured = case
    _compare(op, build(_rs(4)), kwargs, grad_idx)


@pytest.mark.parametrize("name", ["gemm2", "potrf", "syrk", "sumlogdiag"])
def test_nd_linalg_namespace(name):
    r = _rs(5)
    a = _spd(r, 3)
    args = [a, a] if name == "gemm2" else [a]
    want = getattr(mx.nd.linalg, name)(*[mx.nd.array(x) for x in args])
    got = getattr(mt.nd.linalg, name)(*[mt.nd.array(x, ctx=CPU)
                                        for x in args])
    assert _gap(got.asnumpy(), want.asnumpy()) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_trsm_rightside_solves_the_system(transpose):
    """X op(A) = alpha B, held to numpy: the JAX package's rightside trsm
    tells its solver op(A)^T has A's triangle and so reads only the
    diagonal (ROADMAP Queue 3, faults of the reference met)."""
    r = _rs(6)
    a, b = _lower(r, 4), _f(r, 3, 4)
    x = mt.nd.linalg.trsm(mt.nd.array(a, ctx=CPU), mt.nd.array(b, ctx=CPU),
                          rightside=True, transpose=transpose, alpha=0.5)
    op_a = a.T if transpose else a
    np.testing.assert_allclose(x.asnumpy() @ op_a, 0.5 * b, rtol=1e-5,
                               atol=1e-5)
    j = mx.nd.linalg.trsm(mx.nd.array(a), mx.nd.array(b), rightside=True,
                          transpose=transpose, alpha=0.5).asnumpy()
    assert np.abs(j @ op_a - 0.5 * b).max() > 1e-2


def test_trmm_reads_only_the_lower_triangle():
    """trmm reads A's lower triangle only, so A's gradient is lower
    triangular: the JAX package's, masked (it multiplies by the whole
    A, a fault of the reference met)."""
    r = _rs(8)
    a, b = _lower(r, 3), _f(r, 3, 2)
    full = a + np.triu(_f(r, 3, 3), 1)
    ta = mt.nd.array(full, ctx=CPU)
    ta.attach_grad()
    with mt.autograd.record():
        got = mt.nd.linalg.trmm(ta, mt.nd.array(b, ctx=CPU))
    got.backward()
    np.testing.assert_allclose(got.asnumpy(), a @ b, rtol=1e-6, atol=1e-6)
    ja = mx.nd.array(a)
    ja.attach_grad()
    with mx.autograd.record():
        want = mx.nd.linalg.trmm(ja, mx.nd.array(b))
    want.backward()
    assert _gap(ta.grad.asnumpy(), np.tril(ja.grad.asnumpy())) <= TOL


def test_deconvolution_edges_raise():
    x = mt.nd.array(np.zeros((1, 2, 4, 4), np.float32), ctx=CPU)
    w = mt.nd.array(np.zeros((2, 3, 3, 3), np.float32), ctx=CPU)
    # the JAX package pads any adj; PyTorch's output_padding must stay
    # below max(stride, dilate)
    with pytest.raises(mt.MXNetError, match="adj"):
        mt.nd.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2), adj=(2, 0),
                            num_filter=3)
    # the JAX package ignores target_shape silently
    with pytest.raises(mt.MXNetError, match="target_shape"):
        mt.nd.Deconvolution(x, w, kernel=(3, 3), target_shape=(8, 8),
                            num_filter=3)
    with pytest.raises(mt.MXNetError, match="channels-first"):
        mt.nd.Deconvolution(x, w, kernel=(3, 3), num_filter=3,
                            layout="NHWC")
    out = mt.nd.Deconvolution(x, w, kernel=(3, 3), stride=(2, 2),
                              adj=(1, 1), num_filter=3)
    assert out.shape == (1, 3, 10, 10)


@pytest.mark.parametrize("kw", [dict(offset=(3, 0), h_w=(4, 4)),
                                dict(offset=(0, 2), h_w=(2, 5))])
def test_crop_past_the_edge_raises(kw):
    x = mt.nd.array(np.zeros((1, 1, 6, 6), np.float32), ctx=CPU)
    with pytest.raises(mt.MXNetError, match="exceeds"):
        mt.nd.Crop(x, **kw)
    with pytest.raises(Exception):
        mx.nd.Crop(mx.nd.array(np.zeros((1, 1, 6, 6), np.float32)), **kw)


def test_crop_like_input_gets_no_gradient():
    """The second input of Crop gives only its shape: no gradient flows
    into it, and a symbol that crops to ``data`` binds without
    ``inputs_need_grad``."""
    r = _rs(9)
    x = mt.nd.array(_f(r, 1, 2, 8, 8), ctx=CPU)
    like = mt.nd.array(_f(r, 1, 2, 5, 5), ctx=CPU)
    x.attach_grad()
    like.attach_grad()
    with mt.autograd.record():
        y = mt.nd.Crop(x, like, offset=(1, 2), num_args=2)
    y.backward()
    assert float(np.abs(like.grad.asnumpy()).max()) == 0.0
    g = np.zeros((1, 2, 8, 8), np.float32)
    g[:, :, 1:6, 2:7] = 1
    np.testing.assert_array_equal(x.grad.asnumpy(), g)


def test_rrelu_training_draws_slopes_in_range():
    x = mt.nd.array(-np.ones((64, 64), np.float32), ctx=CPU)
    with mt.autograd.record(train_mode=True):
        y = mt.nd.LeakyReLU(x, act_type="rrelu", lower_bound=0.1,
                            upper_bound=0.3)
    s = -y.asnumpy()
    assert s.min() >= 0.1 and s.max() <= 0.3
    assert abs(s.mean() - 0.2) < 0.01 and s.std() > 0.04


def test_symbol_arguments_match_jax():
    """The variables a symbol creates for the new ops (prelu's gamma,
    sequence lengths only when used, Deconvolution's bias only without
    ``no_bias``) and the parameter shapes bind infers."""
    for pkg in (mx, mt):
        pkg.name.NameManager.current = pkg.name.NameManager()
    shapes = {"data": (2, 3, 6, 6)}

    def build(pkg):
        x = pkg.sym.var("data")
        y = pkg.sym.LeakyReLU(x, act_type="prelu", name="p")
        y = pkg.sym.LeakyReLU(y, act_type="leaky", name="l")
        y = pkg.sym.Deconvolution(y, kernel=(4, 4), stride=(2, 2),
                                  num_filter=5, name="up")
        y = pkg.sym.Deconvolution(y, kernel=(3, 3), num_filter=2,
                                  no_bias=False, name="up2")
        y = pkg.sym.InstanceNorm(y, name="inorm")
        y = pkg.sym.LayerNorm(y, axis=1, name="ln")
        y = pkg.sym.Crop(y, x, offset=(2, 2), name="crop")
        y = pkg.sym.SequenceMask(y, name="sm")
        return pkg.sym.LinearRegressionOutput(y, name="lro")

    with mx.name.NameManager():
        js = build(mx)
    with mt.name.NameManager():
        ts = build(mt)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
