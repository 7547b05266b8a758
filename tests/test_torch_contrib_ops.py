"""The spatial ops and the rest of the contrib long tail of the PyTorch
port against the JAX package's.

``BilinearSampler``, ``GridGenerator`` (affine and warp),
``SpatialTransformer``, ``Correlation``, ``fft``/``ifft``,
``quantize``/``dequantize``, ``BatchNorm_v1``,
``IdentityAttachKLSparseReg``, ``DeformableConvolution``,
``count_sketch``, ``linalg_gelqf``/``linalg_syevd``,
``_slice_assign``/``_slice_assign_scalar`` and ``_CrossDeviceCopy``,
with their aliases: the same numpy inputs through both op functions on
the CPU. Forward within 1e-5 of the largest value, gradients
(``jax.grad`` against ``torch.autograd``) within 1e-4, integer and
assignment outputs equal.
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


def _run(name, arrays, **params):
    want = jax_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    got = port_op(name).fn(*[torch.from_numpy(np.array(a)) for a in arrays],
                           **params)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w) for w in want], [g.detach().numpy() for g in got]


def _grads(name, arrays, wrt, **params):
    out = jax_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    out = out[0] if isinstance(out, tuple) else out
    cot = np.random.RandomState(9).randn(*out.shape).astype(np.float32)

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


def _close(got, want, tol=1e-5):
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        float(np.abs(got - want).max())


def _check(name, arrays, wrt=(), **params):
    want, got = _run(name, arrays, **params)
    for g, w in zip(got, want):
        _close(g, w)
    if wrt:
        want, got = _grads(name, arrays, list(wrt), **params)
        for g, w in zip(got, want):
            _close(g, w, 1e-4)


# -- spatial ------------------------------------------------------------------

def _grid(rs, B, Ho, Wo, spread=1.2):
    """Sampling points in [-spread, spread]: some outside the map, some
    exactly on its last row and column."""
    g = rs.uniform(-spread, spread, (B, 2, Ho, Wo)).astype(np.float32)
    g[:, :, 0, 0] = 1.0
    g[:, :, 0, 1] = -1.0
    return g


def test_bilinear_sampler():
    rs = np.random.RandomState(0)
    data = rs.randn(2, 3, 7, 9).astype(np.float32)
    _check("BilinearSampler", [data, _grid(rs, 2, 5, 6)], wrt=(0, 1))


@pytest.mark.parametrize("shape", [(6, 8), (1, 5)])
def test_grid_generator_affine(shape):
    rs = np.random.RandomState(1)
    theta = rs.randn(3, 6).astype(np.float32)
    _check("GridGenerator", [theta], wrt=(0,), transform_type="affine",
           target_shape=shape)


def test_grid_generator_warp():
    rs = np.random.RandomState(2)
    flow = rs.randn(2, 2, 5, 7).astype(np.float32)
    _check("GridGenerator", [flow], wrt=(0,), transform_type="warp")


def test_spatial_transformer():
    rs = np.random.RandomState(3)
    data = rs.randn(2, 3, 10, 12).astype(np.float32)
    loc = (np.tile([0.9, 0.1, 0.05, -0.1, 0.8, -0.05], (2, 1))
           + 0.1 * rs.randn(2, 6)).astype(np.float32)
    _check("SpatialTransformer", [data, loc], wrt=(0, 1),
           target_shape=(6, 7))


def test_spatial_through_nd_and_sym():
    rs = np.random.RandomState(4)
    data = rs.randn(1, 2, 6, 6).astype(np.float32)
    loc = np.array([[1, 0, 0, 0, 1, 0]], np.float32)
    got = mt.nd.SpatialTransformer(mt.nd.array(data, ctx=CPU),
                                   mt.nd.array(loc, ctx=CPU),
                                   target_shape=(6, 6)).asnumpy()
    np.testing.assert_allclose(got, data, atol=1e-6)   # the identity map
    s = mt.sym.BilinearSampler(mt.sym.Variable("d"), mt.sym.GridGenerator(
        mt.sym.Variable("t"), transform_type="affine", target_shape=(3, 4)))
    assert s.infer_shape(d=(1, 2, 6, 6), t=(1, 6))[1] == [(1, 2, 3, 4)]


# -- Correlation --------------------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1),
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
         pad_size=2),
    dict(kernel_size=2, max_displacement=1, stride1=1, stride2=1,
         pad_size=1, is_multiply=False),
])
def test_correlation(params):
    rs = np.random.RandomState(5)
    a = rs.randn(2, 3, 9, 10).astype(np.float32)
    b = rs.randn(2, 3, 9, 10).astype(np.float32)
    _check("Correlation", [a, b], wrt=(0, 1), **params)


# -- fft / ifft ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_fft_ifft(dtype):
    rs = np.random.RandomState(6)
    x = rs.randn(3, 8).astype(dtype)
    tol = 1e-3 if dtype == np.float16 else 1e-5
    for name in ("_contrib_fft", "fft", "_contrib_Fft"):
        want, got = _run(name, [x])
        assert got[0].dtype == dtype       # JAX here has no float64
        _close(got[0].astype(np.float32), want[0].astype(np.float32), tol)
    y = rs.randn(3, 16).astype(dtype)
    for name in ("_contrib_ifft", "ifft", "_contrib_Ifft"):
        want, got = _run(name, [y])
        _close(got[0].astype(np.float32), want[0].astype(np.float32), tol)
    # unnormalised: ifft(fft(x)) is n x
    back = port_op("ifft").fn(port_op("fft").fn(torch.from_numpy(
        x.astype(np.float32))))
    np.testing.assert_allclose(back.numpy(), 8 * x.astype(np.float32),
                               rtol=1e-4, atol=1e-4)


def test_fft_gradient():
    x = np.random.RandomState(7).randn(2, 6).astype(np.float32)
    _check("_contrib_fft", [x], wrt=(0,))
    _check("_contrib_ifft", [np.random.RandomState(8).randn(
        2, 12).astype(np.float32)], wrt=(0,))


# -- quantize / dequantize ----------------------------------------------------

def test_quantize_dequantize():
    rs = np.random.RandomState(9)
    x = rs.uniform(-1.5, 2.5, (4, 7)).astype(np.float32)
    x[0, :3] = [-1.0, 2.0, 0.5]       # the range's ends and a half step
    lo, hi = np.array([-1.0], np.float32), np.array([2.0], np.float32)
    for name in ("_contrib_quantize", "quantize"):
        want, got = _run(name, [x, lo, hi])
        assert got[0].dtype == np.uint8
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    q = want[0]
    for name in ("_contrib_dequantize", "dequantize"):
        want, got = _run(name, [q, lo, hi])
        assert got[0].dtype == np.float32
        _close(got[0], want[0])
    with pytest.raises(mt.MXNetError):
        port_op("quantize").fn(torch.from_numpy(x), torch.from_numpy(lo),
                               torch.from_numpy(hi), out_type="int8")


# -- BatchNorm_v1 -------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_v1(train):
    rs = np.random.RandomState(10)
    x = rs.randn(4, 3, 5, 5).astype(np.float32)
    g, b = rs.rand(3).astype(np.float32) + 0.5, rs.randn(3).astype(np.float32)
    mm, mv = rs.randn(3).astype(np.float32), rs.rand(3).astype(np.float32)
    _check("BatchNorm_v1", [x, g, b, mm, mv], wrt=(0, 1, 2), fix_gamma=False,
           _train=train)
    # the moving statistics through nd in training mode
    res = {}
    for pkg in (mx, mt):
        ctx = CPU if pkg is mt else mx.cpu()
        arrs = [pkg.nd.array(a, ctx=ctx) for a in (x, g, b, mm, mv)]
        with pkg.autograd.train_mode() if train else pkg.autograd.pause():
            out = pkg.nd.BatchNorm_v1(*arrs, fix_gamma=False, momentum=0.8)
        res[pkg] = [out.asnumpy(), arrs[3].asnumpy(), arrs[4].asnumpy()]
    for gt, w in zip(res[mt], res[mx]):
        _close(gt, w)
    assert train != np.array_equal(res[mt][1], mm)


# -- IdentityAttachKLSparseReg ------------------------------------------------

def test_kl_sparse_reg():
    rs = np.random.RandomState(11)
    x = rs.uniform(0.05, 0.95, (6, 4)).astype(np.float32)
    mov = rs.uniform(0.2, 0.8, 4).astype(np.float32)
    params = dict(sparseness_target=0.2, penalty=0.01, momentum=0.7)
    _check("IdentityAttachKLSparseReg", [x, mov], wrt=(0,), **params)
    res = {}
    for pkg in (mx, mt):
        ctx = CPU if pkg is mt else mx.cpu()
        d, m = pkg.nd.array(x, ctx=ctx), pkg.nd.array(mov, ctx=ctx)
        d.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.IdentityAttachKLSparseReg(d, m, **params)
        y.backward()
        res[pkg] = [y.asnumpy(), d.grad.asnumpy(), m.asnumpy()]
    for gt, w in zip(res[mt], res[mx]):
        _close(gt, w)
    np.testing.assert_allclose(res[mt][2], 0.7 * mov + 0.3 * x.mean(0),
                               rtol=1e-6)


def test_kl_sparse_reg_in_module_updates_its_aux():
    """In a symbol graph the moving average is an aux state the train
    step updates (the registry's stateful update), in both packages."""
    x = np.random.RandomState(12).uniform(0.1, 0.9, (8, 5)) \
        .astype(np.float32)
    res = {}
    for pkg in (mx, mt):
        ctx = CPU if pkg is mt else mx.cpu()
        s = pkg.sym.IdentityAttachKLSparseReg(
            pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=5,
                                   name="fc"), name="kl")
        s = pkg.sym.MakeLoss(pkg.sym.sum(s), name="loss")
        mod = pkg.mod.Module(s, label_names=[], context=ctx)
        mod.bind([("data", x.shape)], None)
        assert mod._symbol.list_auxiliary_states() == ["kl_moving_avg"]
        w = np.eye(5, dtype=np.float32) * 0.5
        mod.init_params(arg_params={
            "fc_weight": pkg.nd.array(w, ctx=ctx),
            "fc_bias": pkg.nd.array(np.full(5, 0.2, np.float32), ctx=ctx)},
            aux_params={"kl_moving_avg": pkg.nd.array(
                np.full(5, 0.5, np.float32), ctx=ctx)})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                              []))
        mod.update()
        arg, aux = mod.get_params()
        res[pkg] = [arg["fc_weight"].asnumpy(),
                    aux["kl_moving_avg"].asnumpy()]
    for gt, w in zip(res[mt], res[mx]):
        _close(gt, w)
    assert not np.allclose(res[mt][1], 0.5)


# -- DeformableConvolution ----------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(kernel=(3, 3), pad=(1, 1), num_filter=4),
    dict(kernel=(3, 3), stride=(2, 2), dilate=(2, 2), pad=(2, 2),
         num_filter=6, num_group=2, num_deformable_group=2),
    dict(kernel=(1, 3), num_filter=2, no_bias=True),
])
def test_deformable_convolution(params):
    rs = np.random.RandomState(13)
    C, H, W = 4, 7, 8
    kh, kw = params["kernel"]
    sh, sw = params.get("stride", (1, 1))
    dh, dw = params.get("dilate", (1, 1))
    ph, pw = params.get("pad", (0, 0))
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = params.get("num_deformable_group", 1)
    g = params.get("num_group", 1)
    F = params["num_filter"]
    data = rs.randn(2, C, H, W).astype(np.float32)
    off = (rs.randn(2, 2 * dg * kh * kw, Ho, Wo) * 1.5).astype(np.float32)
    w = rs.randn(F, C // g, kh, kw).astype(np.float32) * 0.3
    arrays = [data, off, w]
    if not params.get("no_bias"):
        arrays.append(rs.randn(F).astype(np.float32))
    for name in ("_contrib_DeformableConvolution", "DeformableConvolution"):
        _check(name, arrays, wrt=range(len(arrays)), **params)
    s = mt.sym.contrib.DeformableConvolution(
        mt.sym.Variable("data"), mt.sym.Variable("offset"), name="dc",
        **params)
    arg, out, _ = s.infer_shape(data=data.shape, offset=off.shape)
    assert out == [(2, F, Ho, Wo)]
    assert tuple(arg[2]) == w.shape


# -- count_sketch -------------------------------------------------------------

def test_count_sketch():
    rs = np.random.RandomState(14)
    x = rs.randn(2, 3, 10).astype(np.float32)
    h = rs.randint(0, 6, 10).astype(np.float32)
    s = rs.choice([-1.0, 1.0], 10).astype(np.float32)
    _check("_contrib_count_sketch", [x, h, s], wrt=(0,), out_dim=6)


# -- linalg -------------------------------------------------------------------

def test_linalg_gelqf():
    """LAPACK's sign convention on the CPU in both packages: L and Q
    equal, not only up to the sign of each row."""
    rs = np.random.RandomState(15)
    a = rs.randn(2, 3, 5).astype(np.float32)
    for name in ("_linalg_gelqf", "linalg_gelqf"):
        want, got = _run(name, [a])
        for g, w in zip(got, want):
            _close(g, w)
    q, l_ = got
    np.testing.assert_allclose(l_ @ q, a, rtol=1e-5, atol=1e-5)
    assert np.allclose(np.triu(l_, 1), 0)


def _largest_positive(u):
    """Each row of ``u`` signed so that its entry of largest magnitude
    (the first of equals) is positive: the port's convention."""
    i = np.abs(u).argmax(-1)[..., None]
    return u * np.sign(np.take_along_axis(u, i, -1))


def test_linalg_syevd():
    """The eigenvectors' signs are LAPACK's choice, and the port's CPU
    and the JAX package's differ on some rows: the port signs each
    eigenvector so that its largest entry is positive (on any device),
    and equals the JAX package's once that is signed the same way."""
    rs = np.random.RandomState(16)
    a = rs.randn(2, 4, 4).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    for name in ("_linalg_syevd", "linalg_syevd"):
        want, got = _run(name, [a])
        _close(got[1], want[1])
        np.testing.assert_array_equal(got[0], _largest_positive(got[0]))
        _close(got[0], _largest_positive(want[0]), 1e-4)
    u, lam = got
    np.testing.assert_allclose(
        u.transpose(0, 2, 1) @ (lam[..., None] * u), a, rtol=1e-4, atol=1e-4)


# -- the slice-assign internals and the cross-device copy ---------------------

@pytest.mark.parametrize("begin,end,step", [((1, 0), (3, 4), ()),
                                            ((0, 1), (4, 5), (2, 2)),
                                            ((-3, 2), (4, -1), ())])
def test_slice_assign(begin, end, step):
    rs = np.random.RandomState(17)
    lhs = rs.randn(4, 6).astype(np.float32)
    view = lhs[tuple(slice(b, e, (step[i] if step else 1))
                     for i, (b, e) in enumerate(zip(begin, end)))]
    rhs = rs.randn(*view.shape).astype(np.float32)
    for name in ("_slice_assign", "_crop_assign"):
        want, got = _run(name, [lhs, rhs], begin=begin, end=end, step=step)
        np.testing.assert_array_equal(got[0], want[0])
        want, got = _grads(name, [lhs, rhs], [0, 1], begin=begin, end=end,
                           step=step)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for name in ("_slice_assign_scalar", "_crop_assign_scalar"):
        want, got = _run(name, [lhs], scalar=2.5, begin=begin, end=end,
                         step=step)
        np.testing.assert_array_equal(got[0], want[0])


def test_cross_device_copy():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for name in ("_CrossDeviceCopy", "_copyto"):
        want, got = _run(name, [x])
        np.testing.assert_array_equal(got[0], want[0])
    s = mt.sym._CrossDeviceCopy(mt.sym.Variable("x"))
    assert s.infer_shape(x=(2, 3))[1] == [(2, 3)]


def test_every_item_6_1_name_is_registered_in_both():
    """The 52 names of ROADMAP Queue 1 item 6.1 (27 ops and their
    aliases): each in both registries, aliases sharing one op."""
    from mxnet_tpu.ops.registry import list_ops as jax_list
    from mxnet_tpu_torch.ops.registry import list_ops as port_list
    assert set(jax_list()) <= set(port_list())
    for a, b in (("MultiBoxPrior", "_contrib_multibox_prior"),
                 ("Proposal", "_contrib_proposal"), ("fft", "_contrib_Fft"),
                 ("ctc_loss", "_contrib_CTCLoss"), ("_copyto",
                                                    "_CrossDeviceCopy")):
        assert port_op(a) is port_op(b)
