"""The detection operators of the PyTorch port against the JAX package's.

``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection``,
``ROIPooling``, ``PSROIPooling``, ``DeformablePSROIPooling``,
``Proposal`` and ``MultiProposal``: the same numpy inputs (from seeds,
with planted ties: equal scores, padded ground truths, anchors that
overlap no box) through both op functions on the CPU. Integer and
ordering outputs must be equal, float outputs within 1e-5, gradients
(``jax.vjp`` against ``torch.autograd``) within 1e-4. Then an SSD of the
card phase's structure (``chip_smoke.ssd_symbol``) at narrow widths on
64x64 images: one ``Module`` step in both packages from the same weights.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.ops import contrib as port_contrib
from mxnet_tpu_torch.ops.registry import get_op as port_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_ssd", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TOL = 1e-5
GTOL = 1e-4


def _run(name, arrays, **params):
    want = jax_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    got = port_op(name).fn(*[torch.from_numpy(np.array(a)) for a in arrays],
                           **params)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _grads(name, arrays, wrt, **params):
    """d(sum(out * cot))/d(arrays[i]) for i in ``wrt``, both packages."""
    rs = np.random.RandomState(7)
    out = jax_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    out = out[0] if isinstance(out, tuple) else out
    cot = rs.randn(*out.shape).astype(np.float32)

    def f(*xs):
        full = list(map(jnp.asarray, arrays))
        for i, x in zip(wrt, xs):
            full[i] = x
        o = jax_op(name).fn(*full, **params)
        o = o[0] if isinstance(o, tuple) else o
        return jnp.sum(o * cot)

    want = jax.grad(f, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(arrays[i]) for i in wrt])
    ts = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in wrt:
        ts[i].requires_grad_(True)
    o = port_op(name).fn(*ts, **params)
    o = o[0] if isinstance(o, tuple) else o
    (o * torch.from_numpy(cot)).sum().backward()
    return [np.asarray(w) for w in want], [ts[i].grad.numpy() for i in wrt]


def _close(got, want, tol=TOL):
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale, \
        float(np.abs(got - want).max())


# -- MultiBoxPrior ------------------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(sizes=(0.2, 0.3), ratios=(1, 2, 0.5)),
    dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5, 3, 1 / 3.),
         steps=(8 / 300., 8 / 300.), offsets=(0.5, 0.5)),
    dict(sizes="(0.5,)", ratios="(1.0, 2.0)", clip=True,
         steps=(0.2, 0.16), offsets=(0.5, 0.4)),
])
def test_multibox_prior(params):
    x = np.zeros((2, 3, 5, 6), np.float32)
    want, got = _run("_contrib_MultiBoxPrior", [x], **params)
    _close(got[0], want[0], 1e-6)


def test_multibox_prior_order():
    """(sizes[0], ratios[0]), (sizes[1], ratios[0]), (sizes[0],
    ratios[1]), ... at each cell, from the cell's top-left."""
    x = np.zeros((1, 1, 1, 1), np.float32)
    _, got = _run("_contrib_MultiBoxPrior", [x], sizes=(0.2, 0.4),
                  ratios=(1.0, 4.0))
    w = got[0][0, :, 2] - got[0][0, :, 0]
    h = got[0][0, :, 3] - got[0][0, :, 1]
    np.testing.assert_allclose(w, [0.2, 0.4, 0.4], rtol=1e-6)
    np.testing.assert_allclose(h, [0.2, 0.4, 0.1], rtol=1e-6)


# -- MultiBoxTarget -----------------------------------------------------------

def _anchors(h=6, w=7, sizes=(0.15, 0.3), ratios=(1, 2, 0.5)):
    x = np.zeros((1, 1, h, w), np.float32)
    return _run("_contrib_MultiBoxPrior", [x], sizes=sizes,
                ratios=ratios)[0][0]


def _labels(rs, B, M, classes):
    """1..M-1 boxes an image, padded with class -1; image 0 holds one box
    out of every anchor's reach (none overlaps it by 0.5)."""
    lab = np.full((B, M, 5), -1, np.float32)
    for i in range(B):
        for m in range(1 + i % (M - 1)):
            x0, y0 = rs.uniform(0, 0.6, 2)
            w, h = rs.uniform(0.05, 0.4, 2)
            lab[i, m] = [rs.randint(0, classes), x0, y0, x0 + w, y0 + h]
    lab[0, 1] = [2, 0.97, 0.97, 0.99, 0.995]
    return lab


@pytest.mark.parametrize("ratio,min_neg", [(-1.0, 0), (3.0, 0), (3.0, 40)])
def test_multibox_target(ratio, min_neg):
    rs = np.random.RandomState(1)
    anchor = _anchors()
    N = anchor.shape[1]
    lab = _labels(rs, 4, 5, 4)
    cls_pred = rs.randn(4, 5, N).astype(np.float32)
    cls_pred[:, 0, ::3] = 0.25          # tied background confidences
    want, got = _run("_contrib_MultiBoxTarget", [anchor, lab, cls_pred],
                     negative_mining_ratio=ratio,
                     minimum_negative_samples=min_neg)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (want[2] > 0).any() and (want[2] == 0).any()
    if ratio > 0:
        assert (want[2] == -1).any()


def test_multibox_target_padding_never_clears_a_forced_match():
    """A padded ground truth's IoU row is all -1, so its argmax is anchor
    0; a real box whose best anchor is also 0 must keep its forced
    match (a plain scatter would let the padding's 0 overwrite it)."""
    anchor = _anchors(2, 2, sizes=(0.3,), ratios=(1.0,))
    lab = np.full((1, 3, 5), -1, np.float32)
    lab[0, 0] = [1, 0.0, 0.0, 0.05, 0.05]      # tiny, best anchor 0
    cls_pred = np.zeros((1, 3, anchor.shape[1]), np.float32)
    want, got = _run("_contrib_MultiBoxTarget", [anchor, lab, cls_pred])
    assert want[2][0, 0] == 2.0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])


# -- MultiBoxDetection --------------------------------------------------------

def _det_inputs(seed, B=3, C=4, h=12, w=11):
    rs = np.random.RandomState(seed)
    anchor = _anchors(h, w)
    N = anchor.shape[1]
    prob = rs.rand(B, C, N).astype(np.float32)
    prob[:, :, ::5] = prob[:, :, :1]          # tied scores
    prob[:, 1:, 1::9] = 0.001                 # under the threshold
    loc = (rs.randn(B, N * 4) * 0.4).astype(np.float32)
    return prob, loc, anchor


@pytest.mark.parametrize("topk", [-1, 400, 37])
@pytest.mark.parametrize("force", [False, True])
def test_multibox_detection(topk, force):
    prob, loc, anchor = _det_inputs(2)
    assert anchor.shape[1] > 400
    want, got = _run("_contrib_MultiBoxDetection", [prob, loc, anchor],
                     nms_topk=topk, force_suppress=force,
                     nms_threshold=0.3)
    np.testing.assert_array_equal(got[0][..., 0], want[0][..., 0])
    _close(got[0][..., 1:], want[0][..., 1:])
    kept = (want[0][..., 0] >= 0).sum()
    assert 0 < kept < (want[0][..., 1] > 0.01).sum()


def test_multibox_detection_background_and_clip():
    prob, loc, anchor = _det_inputs(3, C=3, h=5, w=6)
    want, got = _run("_contrib_MultiBoxDetection", [prob, loc * 4, anchor],
                     background_id=1, clip=False, threshold=0.2,
                     variances=(0.2, 0.2, 0.3, 0.3))
    np.testing.assert_array_equal(got[0][..., 0], want[0][..., 0])
    _close(got[0][..., 1:], want[0][..., 1:])


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _op_count(name, arrays, **params):
    with _OpCount() as c:
        port_op(name).fn(*[torch.from_numpy(np.array(a)) for a in arrays],
                         **params)
    return c.n


def test_nms_launches_no_device_work_per_row():
    """The NMS's device work does not grow with the candidate rows: the
    same count of operations at 300 anchors as at 1200 (the greedy order
    is resolved on a host copy)."""
    small = _det_inputs(4, h=10, w=10)
    large = _det_inputs(4, h=20, w=20)
    assert large[2].shape[1] == 4 * small[2].shape[1]
    assert _op_count("_contrib_MultiBoxDetection", small) == \
        _op_count("_contrib_MultiBoxDetection", large)
    assert _op_count("_contrib_Proposal", _rpn_inputs(0, 8, 10),
                     rpn_pre_nms_top_n=100) == \
        _op_count("_contrib_Proposal", _rpn_inputs(0, 16, 20),
                  rpn_pre_nms_top_n=1000)


def test_nms_chunks_agree(monkeypatch):
    prob, loc, anchor = _det_inputs(5)
    whole = _run("_contrib_MultiBoxDetection", [prob, loc, anchor])[1][0]
    monkeypatch.setattr(port_contrib, "_NMS_CHUNK_ELEMS", 1)
    chunked = _run("_contrib_MultiBoxDetection", [prob, loc, anchor])[1][0]
    np.testing.assert_array_equal(chunked, whole)


# -- ROIPooling ---------------------------------------------------------------

def _rois():
    return np.array([[0, 1.3, 2.5, 9.5, 8.2], [1, 0, 0, 13, 11],
                     [0, 5, 5, 5, 5], [1, 3.5, 2.5, 6.5, 10.5],
                     [0, 12, 9, 20, 16]], np.float32)


@pytest.mark.parametrize("pooled,scale", [((3, 4), 0.8), ((2, 2), 1.0),
                                          ((4, 4), 0.5)])
def test_roi_pooling(pooled, scale):
    rs = np.random.RandomState(3)
    data = rs.randn(2, 3, 12, 14).astype(np.float32)
    want, got = _run("ROIPooling", [data, _rois()], pooled_size=pooled,
                     spatial_scale=scale)
    np.testing.assert_array_equal(got[0], want[0])
    want, got = _grads("ROIPooling", [data, _rois()], [0],
                       pooled_size=pooled, spatial_scale=scale)
    _close(got[0], want[0], GTOL)


def test_roi_pooling_chunks_agree(monkeypatch):
    rs = np.random.RandomState(4)
    data = rs.randn(2, 3, 12, 14).astype(np.float32)
    whole = _run("ROIPooling", [data, _rois()], pooled_size=(3, 3))[1][0]
    monkeypatch.setattr(port_contrib, "_ROI_CHUNK_ELEMS", 1)
    chunked = _run("ROIPooling", [data, _rois()], pooled_size=(3, 3))[1][0]
    np.testing.assert_array_equal(chunked, whole)


# -- PSROIPooling, DeformablePSROIPooling -------------------------------------

@pytest.mark.parametrize("P,G", [(3, 3), (4, 2)])
def test_psroi_pooling(P, G):
    rs = np.random.RandomState(5)
    od = 2
    data = rs.randn(2, od * G * G, 12, 14).astype(np.float32)
    params = dict(spatial_scale=0.7, output_dim=od, pooled_size=P,
                  group_size=G)
    want, got = _run("_contrib_PSROIPooling", [data, _rois()], **params)
    _close(got[0], want[0])
    want, got = _grads("_contrib_PSROIPooling", [data, _rois()], [0],
                       **params)
    _close(got[0], want[0], GTOL)


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling(no_trans):
    rs = np.random.RandomState(6)
    od, P, G, ps = 4, 3, 3, 3
    data = rs.randn(2, od * G * G, 12, 14).astype(np.float32)
    trans = (rs.randn(5, 4, ps, ps) * 0.5).astype(np.float32)
    params = dict(spatial_scale=0.7, output_dim=od, pooled_size=P,
                  group_size=G, part_size=ps, sample_per_part=2,
                  trans_std=0.1, no_trans=no_trans)
    want, got = _run("_contrib_DeformablePSROIPooling",
                     [data, _rois(), trans], **params)
    for g, w in zip(got, want):
        _close(g, w)
    wrt = [0] if no_trans else [0, 2]
    want, got = _grads("_contrib_DeformablePSROIPooling",
                       [data, _rois(), trans], wrt, **params)
    for g, w in zip(got, want):
        _close(g, w, GTOL)


# -- Proposal, MultiProposal --------------------------------------------------

def _rpn_inputs(seed, h, w, B=1, A=12):
    rs = np.random.RandomState(seed)
    cls = rs.rand(B, 2 * A, h, w).astype(np.float32)
    cls[:, A:, :, ::3] = cls[:, A:, :, :1]      # tied scores
    bbox = (rs.randn(B, 4 * A, h, w) * 0.2).astype(np.float32)
    info = np.array([[h * 16 - 20, w * 16 - 5, 1.0]] * B, np.float32)
    return cls, bbox, info


@pytest.mark.parametrize("pre,post,thr", [(300, 50, 0.7), (2000, 300, 0.5),
                                          (40, 60, 0.3)])
def test_proposal(pre, post, thr):
    cls, bbox, info = _rpn_inputs(8, 9, 11)
    params = dict(rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post,
                  threshold=thr, rpn_min_size=8)
    want, got = _run("_contrib_Proposal", [cls, bbox, info], **params)
    for g, w in zip(got, want):
        _close(g, w)
    # the boxes come out in JAX's order: the same scores row for row
    np.testing.assert_array_equal(got[1], want[1])


def test_multi_proposal():
    cls, bbox, info = _rpn_inputs(9, 6, 7, B=3)
    info[1] = [70, 90, 0.5]
    params = dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=20,
                  feature_stride=16, scales=(2.0, 4.0, 8.0, 16.0))
    want, got = _run("_contrib_MultiProposal", [cls, bbox, info], **params)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_array_equal(got[0][:, 0], np.repeat([0., 1., 2.], 20))


# -- the namespaces -----------------------------------------------------------

def test_contrib_namespaces_hold_every_contrib_op():
    from mxnet_tpu_torch.ops.registry import list_ops
    names = [n for n in list_ops() if n.startswith("_contrib_")]
    for ns in (mt.nd.contrib, mt.sym.contrib):
        for n in names:
            assert callable(getattr(ns, n))
            assert callable(getattr(ns, n[len("_contrib_"):]))
    for ns in ("nd", "sym"):
        assert sorted(n for n in dir(getattr(mx, ns).contrib)
                      if not n.startswith("__")) == sorted(
            n for n in dir(getattr(mt, ns).contrib)
            if not n.startswith("__"))
    x = mt.nd.array(np.zeros((1, 2, 3, 3), np.float32), ctx=mt.cpu())
    a = mt.nd.contrib.MultiBoxPrior(x, sizes=(0.5,))
    b = mx.nd.contrib.MultiBoxPrior(mx.nd.array(np.zeros((1, 2, 3, 3))),
                                    sizes=(0.5,))
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)


# -- an SSD of the card phase's structure -------------------------------------

SSD = cs._SSD[True]


def _ssd_module(pkg, arg, x, y):
    ctx = mt.cpu() if pkg is mt else mx.cpu()
    mod = pkg.mod.Module(cs.ssd_symbol(pkg, SSD), data_names=["data"],
                         label_names=["label"], context=ctx)
    mod.bind([("data", x.shape)], [("label", y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in arg.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=cs._SSD_OPT)
    return mod


def test_ssd_anchor_count_and_shapes():
    sym = cs.ssd_symbol(mt, cs._SSD[False])
    full = cs._SSD[False]
    b = full["batch"]
    _, out, _ = sym.infer_shape(data=(b, 3, 300, 300),
                                label=(b, full["max_boxes"], 5))
    n = full["anchors"]
    assert n == 8732
    assert out[0] == (b, 21, n) and out[3] == (b, n, 6)
    arg, _, _ = cs.ssd_symbol(mx, full).infer_shape(
        data=(b, 3, 300, 300), label=(b, full["max_boxes"], 5))
    assert [tuple(s) for s in arg] == [tuple(s) for s in sym.infer_shape(
        data=(b, 3, 300, 300), label=(b, full["max_boxes"], 5))[0]]


def test_ssd_module_step_matches_jax():
    """One ``forward_backward`` + ``update`` of the narrow SSD in both
    packages from the same weights and batch: every output and every
    updated parameter within 1e-5 of each tensor's largest value
    (``cls_target`` and the detection's class ids equal)."""
    x, y = cs.ssd_data(SSD, 2, seed=3)
    arg = cs.ssd_init(mt, SSD, x.shape, y.shape, seed=0)
    outs, params = {}, {}
    for pkg in (mx, mt):
        mod = _ssd_module(pkg, arg, x, y)
        ctx = mt.cpu() if pkg is mt else mx.cpu()
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)])
        mod.forward_backward(batch)
        outs[pkg] = [o.asnumpy() for o in mod.get_outputs()]
        mod.update()
        params[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    jo, to = outs[mx], outs[mt]
    np.testing.assert_array_equal(to[2], jo[2])
    assert (jo[2] > 0).any() and (jo[2] == -1).any()
    np.testing.assert_array_equal(to[3][..., 0], jo[3][..., 0])
    for g, w in zip(to, jo):
        _close(g, w)
    for k in arg:
        _close(params[mt][k], params[mx][k])
    moved = max(float(np.abs(params[mx][k] - arg[k]).max()) for k in arg)
    assert moved > 1e-6


def test_ssd_weights_carry_across_with_weights_py():
    """A JAX SSD Module's parameters and optimizer states (after one
    step) load into the port's through ``weights.load_into_module`` as
    they are (the ``relu4_3_scale`` variable and the 24 head
    convolutions included) and read back equal."""
    x, y = cs.ssd_data(SSD, 2, seed=4)
    arg = cs.ssd_init(mt, SSD, x.shape, y.shape, seed=1)
    jmod = _ssd_module(mx, arg, x, y)
    jmod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                          [mx.nd.array(y)]))
    jmod.update()
    jarg, jaux = jmod.get_params()
    import pickle
    states = pickle.loads(jmod._updater.get_states())
    tmod = _ssd_module(mt, arg, x, y)
    mt.weights.load_into_module(tmod, jarg, jaux, opt_states=states)
    targ, taux, tstates = mt.weights.module_to_numpy(tmod)
    assert sorted(targ) == sorted(jarg) and "relu4_3_scale" in targ
    for k, v in jarg.items():
        np.testing.assert_array_equal(targ[k], v.asnumpy())
    for i, st in states.items():
        np.testing.assert_array_equal(np.asarray(tstates[i]),
                                      np.asarray(st))
