"""Block-tail kernel (BN-apply + residual-add + ReLU) of the PyTorch port
against the JAX package.

The port's plain version (what its wrapper runs on a CPU tensor) is held
against the JAX ``scale_bias_add_relu`` (Pallas, interpret mode on the
CPU) at the shapes ``tests/test_pallas.py`` uses, including a partial
row block and a partial column block of the TPU tiling; the fused
``_contrib_BatchNormAddReLU`` op against the JAX op. The CUDA kernel
itself only runs on a card: ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.pallas.fused_bn import scale_bias_add_relu as jax_sbar

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.kernels import fused_bn as K
from mxnet_tpu_torch.ops.registry import get_op as port_get_op

SHAPES = [(3, 5, 7, 33), (2, 20, 7, 33), (2, 2, 2, 600)]


def _inputs(shape, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    return (rs.randn(*shape).astype(dtype), rs.randn(*shape).astype(dtype),
            rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [True, False])
def test_plain_version_matches_jax_fp32(shape, residual):
    x, r, s, b = _inputs(shape, 0)
    want = np.asarray(jax_sbar(jnp.asarray(x), jnp.asarray(s),
                               jnp.asarray(b),
                               jnp.asarray(r) if residual else None))
    args = [torch.from_numpy(a) for a in (x, s, b)]
    rt = torch.from_numpy(r) if residual else None
    for fn in (K.scale_bias_add_relu_reference, K.scale_bias_add_relu):
        got = fn(*args, rt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 8, 8, 16)] + SHAPES)
@pytest.mark.parametrize("residual", [True, False])
def test_plain_version_matches_jax_bf16(shape, residual):
    x, r, s, b = _inputs(shape, 1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jr = jnp.asarray(r).astype(jnp.bfloat16) if residual else None
    want = np.asarray(jax_sbar(jx, jnp.asarray(s), jnp.asarray(b), jr),
                      np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tr = torch.from_numpy(r).to(torch.bfloat16) if residual else None
    got = K.scale_bias_add_relu(tx, torch.from_numpy(s),
                                torch.from_numpy(b), tr)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("axis,shape", [(3, (2, 4, 4, 6)), (1, (2, 6, 4, 4))])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_add_relu_op_matches_jax(axis, shape, fix_gamma):
    rs = np.random.RandomState(3)
    c = shape[axis]
    data = rs.randn(*shape).astype(np.float32)
    addend = rs.randn(*shape).astype(np.float32)
    gamma = (rs.rand(c) + 0.5).astype(np.float32)
    beta = rs.randn(c).astype(np.float32)
    mean = rs.randn(c).astype(np.float32)
    var = (rs.rand(c) + 0.5).astype(np.float32)
    params = dict(eps=1e-5, fix_gamma=fix_gamma, axis=axis)
    ins = (data, addend, gamma, beta, mean, var)
    want = jax_get_op("_contrib_BatchNormAddReLU").fn(
        *[jnp.asarray(a) for a in ins], _train=False, **params)[0]
    got = port_get_op("_contrib_BatchNormAddReLU").fn(
        *[torch.from_numpy(a) for a in ins], _train=False, **params)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_checks_and_dispatch():
    x = torch.randn(2, 3, 3, 8)
    s, b = torch.randn(8), torch.randn(8)
    before = K.launches
    # CPU tensors take the plain version and count no launch
    out = K.scale_bias_add_relu(x, s, b, x.clone())
    assert K.launches == before
    torch.testing.assert_close(out, K.scale_bias_add_relu_reference(
        x, s, b, x.clone()), rtol=0, atol=0)
    # meta tensors only propagate the shape (shape inference)
    m = K.scale_bias_add_relu(x.to("meta"), s.to("meta"), b.to("meta"))
    assert m.device.type == "meta" and m.shape == x.shape
    with pytest.raises(mt.MXNetError, match="channels-last contiguous"):
        K.scale_bias_add_relu(x.permute(0, 2, 1, 3), s, b)
    with pytest.raises(mt.MXNetError, match="residual"):
        K.scale_bias_add_relu(x, s, b, x.double())
    with pytest.raises(mt.MXNetError, match="scale shape"):
        K.scale_bias_add_relu(x, torch.randn(7), b)
    with pytest.raises(mt.MXNetError, match="dtype"):
        K.scale_bias_add_relu(x.double(), s, b)


# -- the CUDA kernels' host-side rules, held on the CPU ----------------------

# ResNet-50's block tails at batch 32 and 1 (H = W, C), and the ragged cases
_TAILS = [(b, hw, hw, c) for b in (32, 1)
          for hw, c in ((56, 256), (28, 512), (14, 1024), (7, 2048))]


@pytest.mark.parametrize("shape", _TAILS + SHAPES)
def test_bwd_partition_covers_every_row_once(shape):
    """The backward's blocks take contiguous row ranges that cover every
    row exactly once, none empty, at most ``_BWD_BLOCKS`` of them; the
    partition is a function of the shape alone (the same on every
    call)."""
    rows = int(np.prod(shape[:-1]))
    blocks, per = K.bwd_partition(rows)
    assert (blocks, per) == K.bwd_partition(rows)
    assert 1 <= blocks <= K._BWD_BLOCKS
    seen = np.zeros(rows, np.int64)
    for b in range(blocks):
        lo, hi = b * per, min(rows, (b + 1) * per)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("residual", [True, False])
def test_cpu_backward_is_the_plain_one_and_counts_nothing(residual):
    """On CPU tensors the autograd backward is the plain version: the
    gradients equal the JAX package's custom VJP (interpret mode) within
    1e-5 of the largest magnitude, with a strided incoming gradient, and
    no launch counter moves."""
    import jax
    x, r, s, b = _inputs((2, 5, 3, 33), 4)
    s = s + 1.5
    cot = np.random.RandomState(5).randn(2, 33, 5, 3).astype(np.float32) \
        .transpose(0, 2, 3, 1)
    jres = jnp.asarray(r) if residual else None
    _, vjp = jax.vjp(lambda *a: jax_sbar(*a) if residual
                     else jax_sbar(*a, None), jnp.asarray(x), jnp.asarray(s),
                     jnp.asarray(b), *([jres] if residual else []))
    want = vjp(jnp.asarray(np.ascontiguousarray(cot)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, s, b) + ((r,) if residual else ())]
    counts = (K.launches, K.bwd_launches, K.strided_grads)
    out = K.scale_bias_add_relu(*leaves[:3],
                                leaves[3] if residual else None)
    g = torch.from_numpy(cot)
    assert not g.is_contiguous()
    got = torch.autograd.grad(out, leaves, g)
    assert counts == (K.launches, K.bwd_launches, K.strided_grads)
    plain = K.scale_bias_add_relu_backward(g.contiguous(), *leaves[:3],
                                           out.detach(), residual)
    for a, p in zip(got, plain):
        assert torch.equal(a, p)
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.float64,
                                        torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16)] + SHAPES)
def test_fp32_coefficients_with_bf16_x_match_jax(shape, coef_dtype):
    """The kernels read fp32 coefficients and round them to the
    activation's type in-register: the wrapper's ``_coef`` gives fp32
    values whose bf16 rounding is ``scale.to(bfloat16)`` (no cast launch
    for fp32 coefficients: the same tensor), and the kernel's arithmetic
    on them (fp32, one rounding on store), written out here in PyTorch,
    agrees with the JAX package's bf16 ``scale_bias_add_relu`` within
    2e-2."""
    x, r, s, b = _inputs(shape, 6)
    ts, tb = (torch.from_numpy(a).to(coef_dtype) for a in (s, b))
    cs, cb = (K._coef(t, torch.bfloat16) for t in (ts, tb))
    assert cs.dtype == torch.float32 and cs.is_contiguous()
    if coef_dtype == torch.float32:
        assert cs.data_ptr() == ts.data_ptr()
    for c_, t in ((cs, ts), (cb, tb)):
        assert torch.equal(c_.to(torch.bfloat16), t.to(torch.bfloat16))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tr = torch.from_numpy(r).to(torch.bfloat16)
    rs_, rb_ = (c_.to(torch.bfloat16).float() for c_ in (cs, cb))
    got = torch.clamp_min(tx.float() * rs_ + rb_ + tr.float(), 0) \
        .to(torch.bfloat16)
    want = np.asarray(jax_sbar(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(np.asarray(ts.float())),
                               jnp.asarray(np.asarray(tb.float())),
                               jnp.asarray(r).astype(jnp.bfloat16)),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_lean_path_builds_no_autograd_node_without_grad():
    """Nothing to differentiate (serving, ``torch.no_grad``): the wrapper
    builds no autograd node and gives the same values; with an input that
    requires grad it runs under the autograd Function."""
    x, r, s, b = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 16), 7))
    want = K.scale_bias_add_relu_reference(x, s, b, r)
    out = K.scale_bias_add_relu(x, s, b, r)
    assert out.grad_fn is None and torch.equal(out, want)
    sg = s.clone().requires_grad_()
    out = K.scale_bias_add_relu(x, sg, b, r)
    assert type(out.grad_fn).__name__ == "_ScaleBiasAddReLUBackward"
    with torch.no_grad():
        assert K.scale_bias_add_relu(x, sg, b, r).grad_fn is None
