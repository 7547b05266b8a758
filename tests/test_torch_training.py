"""Training ResNet v1 in the PyTorch port against the JAX package.

The same numpy inputs and weights go through ``mxnet_tpu`` and
``mxnet_tpu_torch`` on the CPU: the training-mode BatchNorm op and the
fused block tail (outputs, moving-stat updates, gradients), the
SoftmaxOutput gradient, the block-tail kernel's backward (the JAX side's
Pallas kernel in interpret mode under its custom VJP), and
``gluon.block.make_pure_fn`` driving three steps of ``bench.py``'s raw
multi-precision SGD-momentum step on a small bottleneck ResNet v1 (32x32
NHWC, fused tails), in fp32 and with bf16-resident weights.

Tolerances: fp32 op outputs and gradients 1e-5 of the largest magnitude
(sums over the batch in another order); fp32 losses 1e-5 relative,
parameters and momenta rtol 1e-4, atol 1e-5 after three steps (the error
grows through the steps); the bf16 path 2e-2 of the largest magnitude
(bf16 keeps 8 bits of mantissa and the two frameworks round at other
places).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.pallas import fused_bn as JK

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.block import make_pure_fn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.kernels import fused_bn as K
from mxnet_tpu_torch.ops.registry import get_op as port_get_op
from torch_threads import one_torch_thread, default_torch_threads  # noqa: F401

SHAPE = (4, 5, 5, 6)          # NHWC


def _scaled_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= tol * scale, (err, scale, tol)


def _bn_inputs(fused, seed=0):
    rs = np.random.RandomState(seed)
    c = SHAPE[-1]
    ins = [rs.randn(*SHAPE).astype(np.float32)]
    if fused:
        ins.append(rs.randn(*SHAPE).astype(np.float32))
    ins += [(rs.rand(c) + 0.5).astype(np.float32),
            rs.randn(c).astype(np.float32),
            rs.randn(c).astype(np.float32),
            (rs.rand(c) + 0.5).astype(np.float32)]
    return ins, rs.randn(*SHAPE).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_bn_training_op_matches_jax(fused, dtype, fix_gamma):
    """Training-mode BatchNorm and the fused block tail: outputs, batch
    statistics, the moving-stat updates and the gradients of data
    (and addend), gamma and beta."""
    name = "_contrib_BatchNormAddReLU" if fused else "BatchNorm"
    ins, cot = _bn_inputs(fused)
    n_act = 2 if fused else 1          # activations, then gamma, beta
    params = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=3,
                  _train=True)
    jop, top = jax_get_op(name), port_get_op(name)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jin = [jnp.asarray(a).astype(jdt) if i < n_act else jnp.asarray(a)
           for i, a in enumerate(ins)]
    tin = [torch.from_numpy(a).to(tdt) if i < n_act else torch.from_numpy(a)
           for i, a in enumerate(ins)]
    n_grad = n_act + 2

    def jf(*diff):
        return jop.fn(*diff, *jin[n_grad:], **params)

    jouts, vjp = jax.vjp(jf, *jin[:n_grad])
    jgrads = vjp((jnp.asarray(cot).astype(jdt),
                  jnp.zeros_like(jouts[1]), jnp.zeros_like(jouts[2])))
    leaves = [t.clone().requires_grad_() for t in tin[:n_grad]]
    touts = top.fn(*leaves, *tin[n_grad:], **params)
    tgrads = [g if g is not None else torch.zeros_like(l) for g, l in zip(
        torch.autograd.grad(touts[0], leaves, torch.from_numpy(cot).to(tdt),
                            allow_unused=True), leaves)]
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for j, t in zip(jouts, touts):
        _scaled_close(t.detach().float().numpy(),
                      np.asarray(j, np.float32), tol)
    jup = jop.stateful_update(jin, jouts, params)
    tup = top.stateful_update(tin, touts, params)
    assert sorted(jup) == sorted(tup) == ([4, 5] if fused else [3, 4])
    for k in jup:
        assert not tup[k].requires_grad
        _scaled_close(tup[k].numpy(), np.asarray(jup[k]), 1e-5)
    for j, t in zip(jgrads, tgrads):
        _scaled_close(t.float().numpy(), np.asarray(j, np.float32), tol)
    if fix_gamma:           # gamma replaced by ones: its gradient is zero
        assert float(tgrads[n_act].abs().max()) == 0.0


def test_relu_after_constant_bn_channel_matches_jax():
    """A channel that is constant over the batch normalises to exactly
    beta = 0, so its ReLU sits on the tie: the JAX package's
    ``jnp.maximum`` passes half the gradient there (``clamp_min`` would
    pass all of it, and BatchNorm's backward multiplies it by
    rsqrt(eps)); the port's BatchNorm + Activation gives JAX's
    gradients."""
    rs = np.random.RandomState(6)
    data = rs.randn(4, 3, 3, 5).astype(np.float32)
    data[..., 2] = 0.75                       # a dead channel
    gamma = (rs.rand(5) + 0.5).astype(np.float32)
    beta = np.zeros(5, np.float32)
    cot = rs.randn(4, 3, 3, 5).astype(np.float32)
    stats = [np.zeros(5, np.float32), np.ones(5, np.float32)]
    params = dict(eps=1e-5, fix_gamma=False, axis=3, _train=True)
    jbn, jact = jax_get_op("BatchNorm").fn, jax_get_op("Activation").fn

    def jf(d, g, b):
        return jact(jbn(d, g, b, *map(jnp.asarray, stats), **params)[0],
                    act_type="relu")
    _, vjp = jax.vjp(jf, *map(jnp.asarray, (data, gamma, beta)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (data, gamma, beta)]
    out = port_get_op("Activation").fn(port_get_op("BatchNorm").fn(
        *leaves, *map(torch.from_numpy, stats), **params)[0],
        act_type="relu")
    assert float(out[..., 2].detach().abs().max()) == 0.0
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for j, t in zip(vjp(jnp.asarray(cot)), grads):
        _scaled_close(t.numpy(), np.asarray(j), 1e-5)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
@pytest.mark.parametrize("multi_output", [False, True])
def test_softmax_output_grad_matches_jax(normalization, use_ignore,
                                         multi_output):
    """p - onehot(label) with grad_scale, use_ignore and each
    normalization; the incoming head gradient is ignored and the label
    gets a zero gradient."""
    rs = np.random.RandomState(1)
    if multi_output:
        data = rs.randn(3, 5, 4).astype(np.float32)
        label = rs.randint(0, 5, (3, 4)).astype(np.float32)
        label[0, 1] = label[2, 3] = -1
    else:
        data = rs.randn(6, 5).astype(np.float32)
        label = rs.randint(0, 5, 6).astype(np.float32)
        label[2] = label[4] = -1
    head = rs.randn(*data.shape).astype(np.float32)
    params = dict(grad_scale=0.7, use_ignore=use_ignore, ignore_label=-1,
                  normalization=normalization, multi_output=multi_output)
    jfn = jax_get_op("SoftmaxOutput").fn
    jout, vjp = jax.vjp(lambda d, l: jfn(d, l, **params), jnp.asarray(data),
                        jnp.asarray(label))
    jgd, jgl = vjp(jnp.asarray(head))
    d = torch.from_numpy(data).requires_grad_()
    lab = torch.from_numpy(label).requires_grad_()
    out = port_get_op("SoftmaxOutput").fn(d, lab, **params)
    gd, gl = torch.autograd.grad(out, (d, lab), torch.from_numpy(head))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-6,
                               atol=1e-6)
    assert float(gl.abs().max()) == 0.0 == float(jnp.abs(jgl).max())


def _tail_inputs(shape, seed, residual):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    return (rs.randn(*shape).astype(np.float32),
            (rs.rand(c) + 0.5).astype(np.float32),
            rs.randn(c).astype(np.float32),
            rs.randn(*shape).astype(np.float32) if residual else None,
            rs.randn(*shape).astype(np.float32))


def _jax_tail_grads(x, s, b, r, g, dtype):
    jx = jnp.asarray(x).astype(dtype)
    jr = None if r is None else jnp.asarray(r).astype(dtype)
    diff = (jx, jnp.asarray(s), jnp.asarray(b)) + \
        (() if jr is None else (jr,))

    def f(*a):
        return JK.scale_bias_add_relu(a[0], a[1], a[2],
                                      a[3] if len(a) > 3 else None,
                                      interpret=True)
    out, vjp = jax.vjp(f, *diff)
    return out, vjp(jnp.asarray(g).astype(dtype))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 7, 33), (3, 4, 4, 16)])
def test_block_tail_backward_matches_jax_custom_vjp(residual, dtype, shape):
    """The backward both routes run (``scale_bias_add_relu_backward``),
    called directly and through autograd on the CPU route, against the
    gradients of JAX's kernel under its custom VJP."""
    x, s, b, r, g = _tail_inputs(shape, 2, residual)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jout, jgrads = _jax_tail_grads(x, s, b, r, g, jdt)
    tx = torch.from_numpy(x).to(tdt)
    tr = None if r is None else torch.from_numpy(r).to(tdt)
    ts, tb = torch.from_numpy(s), torch.from_numpy(b)
    tg = torch.from_numpy(g).to(tdt)
    out = K.scale_bias_add_relu_reference(tx, ts, tb, tr)
    kernel_route = K.scale_bias_add_relu_backward(tg, tx, ts, tb, out,
                                                  residual)
    leaves = [t.clone().requires_grad_() for t in (tx, ts, tb) +
              (() if tr is None else (tr,))]
    routed = K.scale_bias_add_relu(*leaves[:3],
                                   leaves[3] if residual else None)
    assert type(routed.grad_fn).__name__ == "_ScaleBiasAddReLUBackward"
    plain = torch.autograd.grad(routed, leaves, tg)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    _scaled_close(out.float().numpy(), np.asarray(jout, np.float32), tol)
    got = [t for t in kernel_route if t is not None]
    assert kernel_route[1].dtype == kernel_route[2].dtype == torch.float32
    assert kernel_route[0].dtype == tdt
    for j, k, p in zip(jgrads, got, plain):
        want = np.asarray(j, np.float32)
        _scaled_close(k.float().numpy(), want, tol)
        _scaled_close(p.float().numpy(), want, tol)


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_kernel_route_gradients_reach_every_input(fix_gamma):
    """The fault repaired here: on a CUDA tensor the block tail returned
    a tensor with no ``grad_fn``, so every block tail's gradient was
    lost. Both routes now run under one ``torch.autograd.Function``
    (``tests/test_torch_gpu.py`` holds the CUDA one on the card): the
    channels-last ``_contrib_BatchNormAddReLU`` in training mode passes
    gradients to data, addend, gamma and beta, equal to the JAX op's."""
    ins, cot = _bn_inputs(True, seed=4)
    params = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=3,
                  _train=True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins[:4]]
    out = port_get_op("_contrib_BatchNormAddReLU").fn(
        *leaves, *[torch.from_numpy(a) for a in ins[4:]], **params)[0]
    assert out.grad_fn is not None
    assert any("_ScaleBiasAddReLUBackward" in type(f).__name__
               for f, _ in out.grad_fn.next_functions if f is not None) \
        or type(out.grad_fn).__name__ == "_ScaleBiasAddReLUBackward"
    grads = [g if g is not None else torch.zeros_like(l) for g, l in zip(
        torch.autograd.grad(out, leaves, torch.from_numpy(cot),
                            allow_unused=True), leaves)]

    def jf(*diff):
        return jax_get_op("_contrib_BatchNormAddReLU").fn(
            *diff, *[jnp.asarray(a) for a in ins[4:]], **params)[0]
    _, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in ins[:4]])
    for j, t, nm in zip(vjp(jnp.asarray(cot)), grads,
                        ("data", "addend", "gamma", "beta")):
        if nm != "gamma" or not fix_gamma:
            assert float(t.abs().max()) > 0, nm
        _scaled_close(t.numpy(), np.asarray(j), 1e-5)


# ---------------------------------------------------------------------------
# multi-precision SGD
# ---------------------------------------------------------------------------

def _bits(x):
    """A bf16 array as its fp32 values (exact), for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("clip", [None, 0.4])
def test_mp_sgd_ops_match_jax(momentum, clip):
    """``mp_sgd_update``/``mp_sgd_mom_update`` of both packages on the
    same bf16 weight, bf16 gradient, fp32 master and momentum, with wd,
    rescale_grad and (or without) clip_gradient, three chained steps: the
    bf16 weights bit-equal (the master rounded to nearest even on both
    sides), masters and momenta rtol 1e-6."""
    from mxnet_tpu.ops import optimizer_ops as JO
    from mxnet_tpu_torch.ops import optimizer_ops as TO
    rs = np.random.RandomState(12)
    w32 = rs.randn(9, 33).astype(np.float32)
    mom = (rs.randn(9, 33) * 0.1).astype(np.float32)
    kw = dict(lr=0.05, wd=1e-3, rescale_grad=1.0 / 8,
              clip_gradient=-1.0 if clip is None else clip)
    jw, jm, jp = (jnp.asarray(w32).astype(jnp.bfloat16), jnp.asarray(mom),
                  jnp.asarray(w32))
    tw, tm, tp = (torch.from_numpy(w32).to(torch.bfloat16),
                  torch.from_numpy(mom), torch.from_numpy(w32))
    for _ in range(3):
        g = (rs.randn(9, 33) * 4).astype(np.float32)
        jg, tg = jnp.asarray(g).astype(jnp.bfloat16), \
            torch.from_numpy(g).to(torch.bfloat16)
        if momentum:
            jw, jm, jp = JO.mp_sgd_mom_update(jw, jg, jm, jp,
                                              momentum=momentum, **kw)
            tw, tm, tp = TO.mp_sgd_mom_update(tw, tg, tm, tp,
                                              momentum=momentum, **kw)
        else:
            jw, jp = JO.mp_sgd_update(jw, jg, jp, **kw)
            tw, tp = TO.mp_sgd_update(tw, tg, tp, **kw)
        assert tw.dtype == torch.bfloat16 and tp.dtype == torch.float32
        np.testing.assert_array_equal(_bits(tw), _bits(jw))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=0)
    if clip is not None:      # the clip took effect: 4 * randn / 8 > 0.4
        assert float(np.abs(g / 8).max()) > clip


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_multi_precision_matches_jax(momentum):
    """``optimizer.SGD(multi_precision=True)`` of both packages: the state
    layout ``(momentum or None, fp32 master)`` for a bf16 weight and a
    plain state for an fp32 one, then three updates each with wd (a
    weight's wd_mult 1, a bias's 0), rescale_grad and clip_gradient: bf16
    weights bit-equal, masters, fp32 weights and momenta rtol 1e-6."""
    rs = np.random.RandomState(13)
    shapes = {0: (6, 10), 1: (10,), 2: (10,)}
    names = {0: "fc_weight", 1: "fc_bias", 2: "bn_gamma"}
    bf16 = {0: True, 1: True, 2: False}
    init = {i: rs.randn(*sh).astype(np.float32) for i, sh in shapes.items()}
    grads = [{i: (rs.randn(*sh) * 3).astype(np.float32)
              for i, sh in shapes.items()} for _ in range(3)]
    kw = dict(learning_rate=0.05, momentum=momentum, wd=1e-2,
              rescale_grad=1.0 / 8, clip_gradient=0.3, multi_precision=True,
              param_idx2name=names)
    out = {}
    for pkg, ctx in ((mx, {}), (mt, {"ctx": mt.cpu()})):
        opt = pkg.optimizer.SGD(**kw)
        ws = {i: pkg.nd.array(init[i], dtype="bfloat16" if bf16[i]
                              else "float32", **ctx) for i in shapes}
        states = {i: opt.create_state_multi_precision(i, ws[i])
                  for i in shapes}
        for i in shapes:
            if bf16[i]:
                mom, master = states[i]
                assert isinstance(states[i], tuple)
                assert (mom is None) == (momentum == 0.0)
                assert str(master.dtype).endswith("float32")
            else:
                assert not isinstance(states[i], tuple)
                assert (states[i] is None) == (momentum == 0.0)
        for step in grads:
            for i in shapes:
                g = pkg.nd.array(step[i], dtype="bfloat16" if bf16[i]
                                 else "float32", **ctx)
                opt.update_multi_precision(i, ws[i], g, states[i])

        def host(x):
            return None if x is None else \
                np.asarray(x.asnumpy()).astype(np.float32)
        out[pkg.__name__] = (
            {i: host(w) for i, w in ws.items()},
            {i: tuple(map(host, s)) if isinstance(s, tuple) else host(s)
             for i, s in states.items()})
    (jw, js), (tw, ts) = out["mxnet_tpu"], out["mxnet_tpu_torch"]
    for i in shapes:
        if bf16[i]:
            np.testing.assert_array_equal(tw[i], jw[i], err_msg=names[i])
            for a, b in zip(ts[i], js[i]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(tw[i], jw[i], rtol=1e-6, atol=0)
            if momentum:
                np.testing.assert_allclose(ts[i], js[i], rtol=1e-6, atol=0)
        assert not np.array_equal(tw[i], init[i])


# ---------------------------------------------------------------------------
# make_pure_fn + bench.py's raw step
# ---------------------------------------------------------------------------

CHANNELS = [8, 16, 32, 64, 128]
HW, BATCH, CLASSES, LR, MOMENTUM = 32, 8, 10, 0.05, 0.9


def _small_resnet(pkg, res, ctx_kw):
    """The small bottleneck ResNet v1 with fused tails, NHWC, its deferred
    shapes completed by one forward."""
    os.environ["MXNET_FUSED_BN_ADD_RELU"] = "1"
    pkg.layout.set_default_layout("NHWC")
    try:
        with pkg.name.NameManager():
            net = res.ResNetV1(res.BottleneckV1, [1, 1, 1, 1], CHANNELS,
                               classes=CLASSES, thumbnail=True)
        net.initialize(pkg.init.Xavier(), **ctx_kw)
        net(pkg.nd.zeros((1, HW, HW, 3), **ctx_kw))
    finally:
        pkg.layout.set_default_layout(None)
        os.environ.pop("MXNET_FUSED_BN_ADD_RELU", None)
    return net


def _carried_nets():
    """Both packages' nets with the same weights: JAX's Xavier draws (and
    random BN statistics) carried into the port by name."""
    np.random.seed(0)
    jnet = _small_resnet(mx, jres, {})
    rs = np.random.RandomState(9)
    blob = {}
    for name, p in jnet.collect_params().items():
        a = p.data().asnumpy()
        if name.endswith(("gamma", "running_var")):
            a = (rs.rand(*a.shape) + 0.5).astype(np.float32)
        elif name.endswith(("beta", "running_mean")):
            a = (rs.randn(*a.shape) * 0.1).astype(np.float32)
        p.set_data(mx.nd.array(a))
        blob[name] = a
    tnet = _small_resnet(mt, tres, {"ctx": mt.cpu()})
    mt.weights.load_into_block(tnet, blob, ctx=mt.cpu())
    return jnet, tnet, blob


def _jax_pure_fn(block):
    """The JAX package's make_pure_fn with the aux map keyed by the
    parameter's NDArray (its own keys by the raw array and comes back
    empty), so the moving stats can be compared too."""
    from mxnet_tpu.gluon.block import _aux_collect
    from mxnet_tpu.ndarray.ndarray import _wrap
    params = list(block.collect_params().values())
    idx = {id(p._data): i for i, p in enumerate(params)}

    def fn(raw_params, raw_inputs):
        collector = []
        originals = [p._data._data for p in params]
        try:
            with mx.autograd.pause(train_mode=True), _aux_collect(collector):
                for p, r in zip(params, raw_params):
                    p._data._set_data(r)
                out = block._forward_eager(*[_wrap(r) for r in raw_inputs])
        finally:
            for p, o in zip(params, originals):
                p._data._set_data(o)
        return (out._data,), {idx[id(t)]: v for t, v in collector
                              if id(t) in idx}
    return fn


def _relu_factor(pre):
    """The gradient of ``max(x, 0)`` at ``pre``: 1 above 0, 1/2 at the
    tie (``jnp.maximum``/``torch.maximum``), 0 below."""
    return (pre > 0).astype(np.float32) + 0.5 * (pre == 0)


class _ReluMasks:
    """The branch masks of the port's ReLU units — each ``Activation`` ReLU
    and each block tail's — recorded in call order during the port's
    forward of a step and replayed in the JAX package's forward of the
    same step, as each unit's gradient factor (``x * factor`` replays
    both the value and the gradient). A unit whose input lies within
    rounding of zero can take the other branch in the other framework
    and move a whole batch's gradient; over three steps on one batch
    each fp32 side takes such branches where the other does not. With
    the factors shared both sides compute the same piecewise-linear
    function; the JAX tail then runs as its composed chain (its kernel
    and custom VJP are held to the port's above), and the units whose
    own factor differs are counted. With ``shared=False`` the JAX
    package runs as it is (``jnp.maximum``, the tail's Pallas kernel in
    interpret mode under its custom VJP) and the flips are only
    counted, per step in ``step_flips``."""

    def __init__(self, monkeypatch, shared=True):
        self.masks, self.flips, self._replay = [], 0, None
        self.step_masks, self.step_flips = [], []
        top, jop = port_get_op("Activation"), jax_get_op("Activation")
        port_fn, jax_fn, port_tail = top.fn, jop.fn, K.scale_bias_add_relu
        jax_tail_fn = JK.scale_bias_add_relu

        def port_relu(data, act_type="relu"):
            if act_type == "relu":
                self.masks.append(("relu", _relu_factor(
                    data.detach().float().numpy())))
            return port_fn(data, act_type)

        def port_tail_rec(x, scale, bias, residual=None):
            out = port_tail(x, scale, bias, residual)
            self.masks.append(("tail", (out > 0).detach().float()
                               .numpy()))
            return out

        def count(kind, pre, own):
            got, mask = self._replay.pop(0)
            assert got == kind, (got, kind)
            if not isinstance(pre, jax.core.Tracer):
                self.flips += int((own(np.asarray(pre, np.float32))
                                   != mask).sum())
            return mask

        def replayed(kind, pre, own):
            return pre * jnp.asarray(count(kind, pre, own), pre.dtype)

        def jax_relu(data, act_type="relu"):
            if act_type != "relu":
                return jax_fn(data, act_type)
            if shared:
                return replayed("relu", data, _relu_factor)
            if self._replay:
                count("relu", data, _relu_factor)
            return jax_fn(data, act_type)

        def jax_tail(x, scale, bias, residual=None, interpret=None):
            if not shared:
                out = jax_tail_fn(x, scale, bias, residual, interpret)
                if self._replay:
                    count("tail", out, lambda a: (a > 0).astype(np.float32))
                return out
            y = x * scale.astype(x.dtype) + bias.astype(x.dtype)
            if residual is not None:
                y = y + residual.astype(x.dtype)
            return replayed("tail", y, lambda a: (a > 0).astype(np.float32))

        monkeypatch.setattr(top, "fn", port_relu)
        monkeypatch.setattr(K, "scale_bias_add_relu", port_tail_rec)
        monkeypatch.setattr(jop, "fn", jax_relu)
        monkeypatch.setattr(JK, "scale_bias_add_relu", jax_tail)
        # the fused op is jitted per signature: run it eagerly so every
        # call takes its own mask
        monkeypatch.setattr(jax_get_op("_contrib_BatchNormAddReLU"),
                            "jit_cache", False)

    def replay(self, masks):
        self._replay = list(masks)


def _keep_fp32(names):
    return [any(t in n for t in ("gamma", "beta", "running_mean",
                                 "running_var")) for n in names]


def _jax_raw_steps(jnet, names, xs, ys, bf16, relu, shared=True):
    """``bench.py``'s train_step (``bench.py:244-270``), run eagerly, each
    step's ReLUs on the masks the port recorded for it (``relu``; with
    ``shared=False`` on its own); an untraced forward first counts the
    units whose own sign differs."""
    fn = _jax_pure_fn(jnet)
    keep = _keep_fp32(names)
    master = [jnp.asarray(p.data().asnumpy())
              for p in jnet.collect_params().values()]
    mom = [jnp.zeros_like(m) for m in master]
    lowp = [bf16 and not k for k in keep]
    losses, snaps = [], []
    for x, y, masks in zip(xs, ys, relu.step_masks):
        full = [m.astype(jnp.bfloat16) if lp else m
                for m, lp in zip(master, lowp)]
        xin = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
        before = relu.flips
        relu.replay(masks)
        fn(full, [xin])
        relu.step_flips.append(relu.flips - before)
        relu.replay(masks if shared else [])

        def loss_f(ps):
            (logits,), aux = fn(ps, [xin])
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            return -jnp.mean(jnp.take_along_axis(
                logp, jnp.asarray(y)[:, None], axis=1)), aux

        (loss, aux), grads = jax.value_and_grad(loss_f, has_aux=True)(full)
        losses.append(float(loss))
        for i in range(len(master)):
            if i in aux:
                master[i] = aux[i].astype(jnp.float32)
                continue
            mom[i] = MOMENTUM * mom[i] - LR * grads[i].astype(jnp.float32)
            master[i] = master[i] + mom[i]
        snaps.append(([np.asarray(m) for m in master],
                      [np.asarray(m) for m in mom]))
    return losses, snaps


def _port_raw_steps(tnet, xs, ys, bf16, relu=None):
    """The same step through the port: ``make_pure_fn`` under
    ``torch.autograd``, then ``mp_sgd_mom_update`` (bf16-resident weights)
    or ``sgd_mom_update`` (fp32), BN running stats from the aux map.
    Each step's snapshot: masters, momenta, gradients and the weights the
    next step reads (bf16-resident ones as their fp32 values)."""
    from mxnet_tpu_torch.ops import optimizer_ops as O
    fn, raw, names = make_pure_fn(tnet, train=True)
    keep = _keep_fp32(names)
    lowp = [bf16 and not k for k in keep]
    master = [r.detach().clone().float() for r in raw]
    mom = [torch.zeros_like(m) for m in master]
    pbf = [m.to(torch.bfloat16) if lp else None
           for m, lp in zip(master, lowp)]
    losses, snaps = [], []
    for x, y in zip(xs, ys):
        full = [(pbf[i] if lowp[i] else master[i]).detach()
                .requires_grad_() for i in range(len(master))]
        xin = torch.from_numpy(x).to(torch.bfloat16 if bf16
                                     else torch.float32)
        if relu is not None:
            relu.masks = []
        (logits,), aux = fn(full, [xin])
        if relu is not None:
            relu.step_masks.append(relu.masks)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(1, torch.from_numpy(y).long()[:, None]).mean()
        grads = torch.autograd.grad(loss, full, allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for i in range(len(master)):
                if i in aux:
                    master[i] = aux[i].float()
                    continue
                g = grads[i] if grads[i] is not None \
                    else torch.zeros_like(full[i])
                if lowp[i]:
                    pbf[i], mom[i], master[i] = O.mp_sgd_mom_update(
                        pbf[i], g, mom[i], master[i], lr=LR,
                        momentum=MOMENTUM)
                else:
                    master[i], mom[i] = O.sgd_mom_update(
                        master[i], g, mom[i], lr=LR, momentum=MOMENTUM)
        snaps.append(([m.numpy() for m in master],
                      [m.numpy() for m in mom],
                      [None if g is None else g.float().numpy()
                       for g in grads],
                      [(pbf[i] if lowp[i] else master[i]).float().numpy()
                       for i in range(len(master))]))
    # the block's own parameters are untouched by make_pure_fn
    for p, r in zip(tnet.collect_params().values(), raw):
        assert p.data()._data is r
    return losses, names, aux, snaps


def _raw_data(steps):
    """bench.py's synthetic batch, the same one every step."""
    rs = np.random.RandomState(3)
    return ([rs.uniform(-1, 1, (BATCH, HW, HW, 3)).astype(np.float32)]
            * steps, [rs.randint(0, CLASSES, BATCH).astype(np.int32)] * steps)


def _mp_update_matches_jax_op(names, w0, snap, lowp):
    """The port's step-1 update, tensor by tensor, against the JAX
    package's own update op applied to the port's step-1 gradient from
    the same weight, fp32 master and (zero) momentum: bf16 weights bit
    for bit, masters and momenta rtol 1e-6."""
    from mxnet_tpu.ops import optimizer_ops as JO
    masters, moms, grads, weights = snap
    for i, n in enumerate(names):
        if n.endswith(("running_mean", "running_var")):
            continue
        w32, m0 = jnp.asarray(w0[i]), jnp.zeros_like(jnp.asarray(w0[i]))
        g = jnp.asarray(grads[i])
        if lowp[i]:
            w, m, p = JO.mp_sgd_mom_update(
                w32.astype(jnp.bfloat16), g.astype(jnp.bfloat16), m0, w32,
                lr=LR, momentum=MOMENTUM)
            np.testing.assert_array_equal(
                weights[i], np.asarray(w.astype(jnp.float32)), err_msg=n)
        else:
            p, m = JO.sgd_mom_update(w32, g, m0, lr=LR, momentum=MOMENTUM)
        np.testing.assert_allclose(masters[i], np.asarray(p), rtol=1e-6,
                                   atol=0, err_msg=n)
        np.testing.assert_allclose(moms[i], np.asarray(m), rtol=1e-6,
                                   atol=0, err_msg=n)


@pytest.mark.parametrize("bf16", [False, True])
def test_make_pure_fn_raw_step_matches_jax(bf16, monkeypatch):
    """Three steps of bench.py's raw step from the same carried weights on
    one fixed batch (bench.py's synthetic batch), ReLU masks shared (see
    ``_ReluMasks``; in fp32 fewer than 0.1% of the units differ in sign;
    ``test_raw_step_matches_jax_as_it_is`` runs without them).

    fp32: the losses, and after every step every weight and momentum
    (the BatchNorm running stats written back from the aux map among
    them). bf16-resident weights with fp32 masters: the three losses, the
    weights after step 1 scaled by the largest magnitude of all weights,
    and the step-1 update tensor by tensor, twice: (a) against the JAX
    package's ``mp_sgd_mom_update``/``sgd_mom_update`` applied to the
    port's own gradient (bf16 weights bit-equal, masters and momenta
    rtol 1e-6), and (b) against JAX's fp32 update on the same branches:
    the port's bf16 update lies no further from it than JAX's bf16
    update does, plus 2e-2 of its norm. The bf16 updates are not held to
    each other at 2e-2: JAX's bf16 BatchNorm backward sums gamma's and
    beta's gradients in bf16 on the CPU while the port's sums run in
    fp32, so in the unfused BatchNorms JAX's bf16 update lies up to 41%
    from its fp32 one and the port's within 7.5% (the conv biases ahead
    of a BatchNorm have a zero gradient in exact arithmetic, so theirs is
    rounding noise on both sides). Later bf16 steps drift apart in both
    frameworks alike."""
    jnet, tnet, _ = _carried_nets()
    w0 = [p.data().asnumpy() for p in jnet.collect_params().values()]
    relu = _ReluMasks(monkeypatch)
    xs, ys = _raw_data(3)
    t_losses, names, aux, t_snaps = _port_raw_steps(tnet, xs, ys, bf16, relu)
    assert sorted(names[i] for i in aux) == sorted(
        n for n in names if n.endswith(("running_mean", "running_var")))
    j_losses, j_snaps = _jax_raw_steps(jnet, names, xs, ys, bf16, relu)
    n_units = sum(m.size for ms in relu.step_masks for _, m in ms)
    assert len(relu.step_masks) == 3
    assert bf16 or relu.flips <= 1e-3 * n_units, (relu.flips, n_units)
    lowp = [bf16 and not k for k in _keep_fp32(names)]
    _mp_update_matches_jax_op(names, w0, t_snaps[0], lowp)
    if bf16:
        _scaled_close(t_losses, j_losses, 2e-2)
        _scaled_close(np.concatenate([a.ravel() for a in t_snaps[0][0]]),
                      np.concatenate([b.ravel() for b in j_snaps[0][0]]),
                      2e-2)
        _, f_snaps = _jax_raw_steps(jnet, names, xs[:1], ys[:1], False,
                                    relu)
        for n, w, t, j, f in zip(names, w0, t_snaps[0][0], j_snaps[0][0],
                                 f_snaps[0][0]):
            if n.endswith(("running_mean", "running_var")):
                continue
            dt, dj, df = t - w, j - w, f - w
            port_gap = float(np.linalg.norm(dt - df))
            jax_gap = float(np.linalg.norm(dj - df))
            assert port_gap <= jax_gap + 2e-2 * np.linalg.norm(df), \
                (n, port_gap, jax_gap, float(np.linalg.norm(df)))
    else:
        np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
        for (tm, tmo, _, _), (jm, jmo) in zip(t_snaps, j_snaps):
            for n, a, b in zip(names + names, tm + tmo, jm + jmo):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=n)
    assert t_losses[-1] < t_losses[0]


def test_raw_step_matches_jax_as_it_is(monkeypatch, default_torch_threads):
    """The fp32 raw step with nothing shared: the JAX package runs as it
    is (its ReLUs, the block tail's Pallas kernel in interpret mode under
    its custom VJP), the units whose sign differs between the two
    frameworks are counted per step. A step on which every unit agrees
    matches at the stated tolerances (losses 1e-5 relative, weights and
    momenta rtol 1e-4, atol 1e-5): step 1 does. From step 2 on units
    within rounding of zero take the other branch (measured: 1 at step 2,
    after which the weights lie up to 70x the tolerance apart, 527 at
    step 3, whose loss lies 1.9e-3 relative apart), which is why the
    three-step comparison above shares the masks."""
    jnet, tnet, _ = _carried_nets()
    relu = _ReluMasks(monkeypatch, shared=False)
    xs, ys = _raw_data(3)
    t_losses, names, _, t_snaps = _port_raw_steps(tnet, xs, ys, False, relu)
    j_losses, j_snaps = _jax_raw_steps(jnet, names, xs, ys, False, relu,
                                       shared=False)
    assert relu.step_flips[0] == 0, relu.step_flips
    assert sum(relu.step_flips) > 0, relu.step_flips
    for step, flips in enumerate(relu.step_flips):
        if flips:
            continue
        np.testing.assert_allclose(t_losses[step], j_losses[step],
                                   rtol=1e-5)
        (tm, tmo, _, _), (jm, jmo) = t_snaps[step], j_snaps[step]
        for n, a, b in zip(names + names, tm + tmo, jm + jmo):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=n)


def test_jax_make_pure_fn_aux_map_is_empty():
    """The reference's make_pure_fn keys its aux map by the raw array's
    id, so the map comes back empty and bench.py's raw step never writes
    BN running stats back; the port's (above) carries every one."""
    from mxnet_tpu.gluon.block import make_pure_fn as jax_make_pure_fn
    np.random.seed(0)
    jnet = _small_resnet(mx, jres, {})
    fn, raw, _ = jax_make_pure_fn(jnet, train=True)
    _, aux = fn(raw, [jnp.zeros((2, HW, HW, 3))], jax.random.key(0))
    assert aux == {}


@pytest.mark.parametrize("extra", [{}, {"wd": 0.01}, {"clip_gradient": 0.5}],
                         ids=["plain", "wd", "clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nag_per_parameter_updater_matches_jax(extra, dtype):
    """NAG through the per-parameter ``Updater`` path (``get_updater(nag)(i,
    g, w)``, multi-precision for bf16): 4 steps at lr 0.1, momentum 0.9 on
    a 4x3 weight, against the JAX package's. ROADMAP Queue 3, fault 3:
    the port ran SGD's momentum rule there (max error 0.845). fp32 within
    1e-6 of the largest magnitude; bf16 weights equal, their fp32 masters
    within 1e-6."""
    rs = np.random.RandomState(0)
    w0 = rs.randn(4, 3).astype(np.float32)
    grads = [rs.randn(4, 3).astype(np.float32) for _ in range(4)]
    kw = dict(learning_rate=0.1, momentum=0.9, multi_precision=True, **extra)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jw = mx.nd.array(jnp.asarray(w0).astype(jdt))
    tw = mt.nd.array(w0, ctx=mt.cpu(), dtype=dtype)
    jup = mx.optimizer.get_updater(mx.optimizer.create("nag", **kw))
    tup = mt.optimizer.get_updater(mt.optimizer.create("nag", **kw))
    for g in grads:
        jup(0, mx.nd.array(jnp.asarray(g).astype(jdt)), jw)
        tup(0, mt.nd.array(g, ctx=mt.cpu(), dtype=dtype), tw)
    want = np.asarray(jw.asnumpy(), np.float32)
    _scaled_close(tw.asnumpy(), want, 1e-6)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(tw.asnumpy(), want)
        _scaled_close(tup.states[0][1].asnumpy(),
                      np.asarray(jup.states[0][1].asnumpy()), 1e-6)
