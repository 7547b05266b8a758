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

