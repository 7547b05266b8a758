"""The port's optimizers beyond SGD, NAG and Adam, their update ops and
fused kernels against the JAX package's.

Each new optimizer takes 4 updates of two parameters (a (6, 5) weight
and a (5,) bias, so the wd rule for 1-D parameters shows) from the same
numpy gradients, with and without wd, clip_gradient and rescale_grad:
per parameter (``Updater``) and through ``FusedUpdater.update_batch``
(the kernel of ``parallel/opt_kernels.py`` where the optimizer has one,
the per-parameter path otherwise), against the JAX package's
``Updater`` and ``FusedUpdater``. Tolerance: the JAX package's own
optimizer tests' ``rtol=1e-5`` (with ``atol=1e-6`` for elements near
zero); XLA may contract a multiply-add into one FMA, 1-2 fp32 ulps
apart from PyTorch's two roundings. SGLD's noise is compared by its
mean and variance. Multi-precision (a bf16 weight with an fp32 master)
is held to the JAX package's fp32 update of the master, which its
classes other than SGD have no multi-precision path for.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401

CPU = mt.cpu()
RTOL, ATOL = 1e-5, 1e-6

_OPTS = [
    ("adagrad", dict(learning_rate=0.1, eps=1e-7)),
    ("rmsprop", dict(learning_rate=0.01, gamma1=0.8)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, gamma2=0.7)),
    ("rmsprop", dict(learning_rate=0.01, clip_weights=0.3)),
    ("adadelta", dict(rho=0.8, epsilon=1e-4)),
    ("ftrl", dict(learning_rate=0.2, lamda1=0.05, beta=0.5)),
    ("dcasgd", dict(learning_rate=0.1, lamda=0.1)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, lamda=0.1)),
    ("test", dict(rescale_grad=0.5)),
    ("ccsgd", dict(learning_rate=0.1, momentum=0.9)),
    ("adamax", dict(learning_rate=0.02, beta1=0.8, beta2=0.9)),
    ("nadam", dict(learning_rate=0.01, schedule_decay=0.01)),
]
_EXTRA = [dict(), dict(wd=0.01, clip_gradient=0.4, rescale_grad=0.7)]
_IDS = ["%s%d" % (n, i) for i, (n, _) in enumerate(_OPTS)]


def _data(seed=0):
    rs = np.random.RandomState(seed)
    ws = [rs.uniform(-1, 1, (6, 5)).astype(np.float32),
          rs.uniform(-1, 1, (5,)).astype(np.float32)]
    grads = [[rs.uniform(-1, 1, w.shape).astype(np.float32) for w in ws]
             for _ in range(4)]
    return ws, grads


def _create(pkg, name, kwargs):
    return pkg.optimizer.create(name, param_idx2name={0: "fc_weight",
                                                      1: "fc_bias"},
                                **kwargs)


def _steps(pkg, name, kwargs, fused, dtype="float32", mp=False):
    ctx = {"ctx": CPU} if pkg is mt else {}
    ws0, grads = _data()
    opt = _create(pkg, name, dict(kwargs, multi_precision=mp))
    upd = pkg.optimizer.get_updater(opt) if fused \
        else pkg.optimizer.Updater(opt)
    ws = [pkg.nd.array(w, dtype=dtype, **ctx) for w in ws0]
    for gs in grads:
        nds = [pkg.nd.array(g, dtype=dtype, **ctx) for g in gs]
        if fused:
            upd.update_batch([0, 1], nds, ws)
        else:
            for i, (g, w) in enumerate(zip(nds, ws)):
                upd(i, g, w)
    return ws, upd


def _np(x):
    return x.asnumpy().astype(np.float32)


@pytest.mark.parametrize("extra", _EXTRA, ids=["plain", "wd_clip_rescale"])
@pytest.mark.parametrize("name,kwargs", _OPTS, ids=_IDS)
@pytest.mark.parametrize("fused", [False, True], ids=["updater", "fused"])
def test_optimizer_matches_jax(name, kwargs, extra, fused):
    kw = dict(kwargs, **extra)
    # the JAX package's fused rmsprop kernel drops clip_weights (ROADMAP
    # Queue 3); the port keeps such an optimizer per parameter, which
    # clips, so the reference there is the JAX per-parameter path
    jw, jupd = _steps(mx, name, kw, fused and not kw.get("clip_weights"))
    tw, tupd = _steps(mt, name, kw, fused)
    for j, t in zip(jw, tw):
        np.testing.assert_allclose(_np(t), _np(j), rtol=RTOL, atol=ATOL)
    # the states, pickled as the JAX package pickles them
    js = pickle.loads(jupd.get_states())
    ts = pickle.loads(tupd.get_states())
    assert sorted(js) == sorted(ts)
    for k in js:
        jl = js[k] if isinstance(js[k], tuple) else (js[k],)
        tl = ts[k] if isinstance(ts[k], tuple) else (ts[k],)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kwargs", [
    ("adagrad", dict(learning_rate=0.1)),
    ("rmsprop", dict(learning_rate=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("adadelta", dict(rho=0.8)),
    ("ftrl", dict(learning_rate=0.2)),
    ("adamax", dict(learning_rate=0.02)),
    ("nadam", dict(learning_rate=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
], ids=lambda v: v if isinstance(v, str) else "")
@pytest.mark.parametrize("fused", [False, True], ids=["updater", "fused"])
def test_multi_precision_master_matches_jax_fp32(name, kwargs, fused):
    """A bf16 weight with ``multi_precision``: the fp32 master follows the
    JAX package's fp32 update from the bf16-rounded start and gradients,
    and the weight is the master rounded to bf16."""
    ws0, grads = _data()

    def bf16(a):
        return mt.nd.array(a, ctx=CPU, dtype="bfloat16").asnumpy()
    jupd = mx.optimizer.Updater(_create(mx, name, kwargs))
    jw = [mx.nd.array(bf16(w)) for w in ws0]
    for gs in grads:
        for i, g in enumerate(gs):
            jupd(i, mx.nd.array(bf16(g)), jw[i])
    tw, tupd = _steps(mt, name, kwargs, fused, dtype="bfloat16", mp=True)
    for i, (j, t) in enumerate(zip(jw, tw)):
        master = _np(tupd.states[i][-1])
        np.testing.assert_allclose(master, _np(j), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(_np(t), bf16(master))


def test_sgld_noise_statistics_match_jax():
    """SGLD: ``w - lr/2 (g + wd w) + N(0, lr)``; the draws differ between
    packages, so each run's noise is held to mean 0 and variance lr."""
    rs = np.random.RandomState(1)
    w0 = rs.uniform(-1, 1, (200, 200)).astype(np.float32)
    g = rs.uniform(-1, 1, w0.shape).astype(np.float32)
    lr, wd = 0.01, 0.1
    det = w0 - lr / 2 * (g + wd * w0)
    for pkg in (mx, mt):
        ctx = {"ctx": CPU} if pkg is mt else {}
        opt = pkg.optimizer.create("sgld", learning_rate=lr, wd=wd,
                                   param_idx2name={0: "w_weight"})
        w = pkg.nd.array(w0, **ctx)
        opt.update(0, w, pkg.nd.array(g, **ctx), None)
        noise = w.asnumpy() - det
        assert abs(noise.mean()) < 4 * np.sqrt(lr / noise.size)
        assert abs(noise.var() / lr - 1) < 0.03, noise.var() / lr


@pytest.mark.parametrize("op,inputs,kwargs", [
    ("rmsprop_update", 3, dict(lr=0.01, gamma1=0.9, wd=0.01,
                               clip_gradient=0.5, clip_weights=0.4)),
    ("rmspropalex_update", 5, dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                   rescale_grad=0.5)),
    ("ftrl_update", 4, dict(lr=0.1, lamda1=0.02, beta=0.5, wd=0.01)),
])
def test_update_ops_match_jax(op, inputs, kwargs):
    """The ``mx.nd`` update ops write the new weight and states into
    their inputs, as the JAX package's do."""
    rs = np.random.RandomState(2)
    arrays = [rs.uniform(-1, 1, (4, 3)).astype(np.float32)
              for _ in range(inputs)]
    arrays[2] = np.abs(arrays[2]) + 1.0     # n: a running square
    jn = [mx.nd.array(a) for a in arrays]
    tn = [mt.nd.array(a, ctx=CPU) for a in arrays]
    for _ in range(3):
        getattr(mx.nd, op)(*jn, **kwargs)
        getattr(mt.nd, op)(*tn, **kwargs)
    for j, t in zip(jn, tn):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name,kwargs", [
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("ftrl", dict(learning_rate=0.2)),
    ("adadelta", dict(rho=0.8)),
    ("dcasgd", dict(learning_rate=0.1)),
    ("adamax", dict(learning_rate=0.02)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_states_carry_both_ways(name, kwargs):
    """Two updates in one package, the pickled states into the other
    (its own ``set_states``), two more there: equal to four in one."""
    jw, jupd = _steps(mx, name, kwargs, fused=False)
    ws0, grads = _data()
    for first, second in ((mx, mt), (mt, mx)):
        ctx1 = {"ctx": CPU} if first is mt else {}
        ctx2 = {"ctx": CPU} if second is mt else {}
        o1 = _create(first, name, kwargs)
        u1 = first.optimizer.Updater(o1)
        w1 = [first.nd.array(w, **ctx1) for w in ws0]
        for gs in grads[:2]:
            for i, g in enumerate(gs):
                u1(i, first.nd.array(g, **ctx1), w1[i])
        o2 = _create(second, name, kwargs)
        u2 = second.optimizer.Updater(o2)
        u2.set_states(u1.get_states())
        o2._index_update_count = dict(o1._index_update_count)
        o2.num_update = o1.num_update
        if hasattr(o1, "m_schedule"):
            o2.m_schedule = o1.m_schedule
        w2 = [second.nd.array(w.asnumpy(), **ctx2) for w in w1]
        for gs in grads[2:]:
            for i, g in enumerate(gs):
                u2(i, second.nd.array(g, **ctx2), w2[i])
        for a, b in zip(w2, jw):
            np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


def test_fused_rmsprop_keeps_clip_weights():
    """The JAX package's fused step forgets ``clip_weights`` (its kernel
    never reads it): a fault of the reference met. The port's fused
    updater clips, as both packages' per-parameter paths do."""
    kw = dict(learning_rate=0.5, clip_weights=0.05)
    jw, _ = _steps(mx, "rmsprop", kw, fused=True)
    tw, _ = _steps(mt, "rmsprop", kw, fused=True)
    assert np.abs(_np(tw[0])).max() <= 0.05 + 1e-7
    assert np.abs(_np(jw[0])).max() > 0.05


def test_fused_kernel_hyperparameters_match_jax():
    from mxnet_tpu.parallel import opt_kernels as jk
    for name, kw in [("rmsprop", dict(gamma1=0.8)), ("adagrad", {}),
                     ("adadelta", dict(rho=0.7)), ("ftrl", dict(beta=2.0))]:
        want = jk.hyper_from_optimizer(mx.optimizer.create(name, **kw))
        got = mt.parallel.opt_kernels.hyper_from_optimizer(
            mt.optimizer.create(name, **kw))
        assert got == want
    # without a kernel the fused updater runs the per-parameter path
    for name in ("sgld", "dcasgd", "adamax", "nadam", "test"):
        with pytest.raises(mt.MXNetError, match="per-parameter"):
            mt.parallel.opt_kernels.hyper_from_optimizer(
                mt.optimizer.create(name))
    with pytest.raises(mt.MXNetError, match="per-parameter"):
        mt.parallel.opt_kernels.hyper_from_optimizer(
            mt.optimizer.create("rmsprop", centered=True))


@pytest.mark.parametrize("name,kwargs", [
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("ftrl", dict(learning_rate=0.2)),
    ("adadelta", dict(rho=0.8)),
    ("adagrad", dict(learning_rate=0.1)),
    ("adamax", dict(learning_rate=0.02)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_load_into_module_carries_jax_states(name, kwargs):
    """A JAX ``Module`` trained 2 batches, carried with
    ``weights.load_into_module`` (parameters, the unpickled optimizer
    states — three per parameter for centered RMSProp, a pair for Ftrl
    and AdaDelta — and the update counts), then 2 more batches in each
    package: the same weights."""
    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (4, 8, 5)).astype(np.float32)
    y = rs.uniform(-1, 1, (4, 8, 3)).astype(np.float32)

    def module(pkg, ctx):
        data = pkg.sym.var("data")
        out = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
        mod = pkg.mod.Module(pkg.sym.LinearRegressionOutput(out, name="lro"),
                             label_names=["lro_label"], context=ctx)
        mod.bind([("data", (8, 5))], [("lro_label", (8, 3))])
        return mod

    def step(pkg, mod, ctx, i):
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(x[i], ctx=ctx)], [pkg.nd.array(y[i], ctx=ctx)]))
        mod.update()
    np.random.seed(2)
    jmod = module(mx, mx.cpu())
    jmod.init_params(mx.init.Xavier())
    jmod.init_optimizer(optimizer=name, optimizer_params=dict(
        kwargs, wd=0.01))
    for i in range(2):
        step(mx, jmod, mx.cpu(), i)
    arg, aux = jmod.get_params()
    states = pickle.loads(jmod._updater.get_states())
    if name == "rmsprop":
        assert all(len(s) == 3 for s in states.values())
    if name in ("ftrl", "adadelta"):
        assert all(len(s) == 2 for s in states.values())
    tmod = module(mt, CPU)
    tmod.init_params()
    tmod.init_optimizer(optimizer=name, optimizer_params=dict(kwargs,
                                                              wd=0.01))
    mt.weights.load_into_module(
        tmod, arg, aux, opt_states=states,
        update_counts=jmod._optimizer._index_update_count)
    for i in range(2, 4):
        step(mx, jmod, mx.cpu(), i)
        step(mt, tmod, CPU, i)
    for k, v in jmod.get_params()[0].items():
        np.testing.assert_allclose(tmod.get_params()[0][k].asnumpy(),
                                   v.asnumpy(), rtol=RTOL, atol=ATOL)
    back = mt.weights.module_to_numpy(tmod)[2]
    assert sorted(back) == sorted(states)
