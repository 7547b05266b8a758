"""The port's gradient compression against ``mxnet_tpu.gradient_compression``.

2-bit: for sizes 1, 15, 16, 17 and 1000 (a last word part-filled or
not) and thresholds 0.5 and 1.0, the packed words, the residuals and the
dequantised values are bit-equal to the JAX package's for the same
input; error feedback over steps; the fp16 wire; the compressor's
argument checks; a compressed push on an in-process store equal to
``tests/test_gradient_compression.py::test_kvstore_compressed_push``'s
(each device shard quantised with its own residual, then summed) and to
the JAX store's; a one-worker ``dist_sync`` store quantises toward the
wire as the JAX package's does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gradient_compression as J

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import gradient_compression as T

CPU = mt.cpu()


def _words(packed):
    assert packed.dtype == torch.uint32
    return packed.to(torch.int64).numpy().astype(np.uint32)


@pytest.mark.parametrize("thr", [0.5, 1.0])
@pytest.mark.parametrize("size", [1, 15, 16, 17, 1000])
def test_2bit_bit_equal_to_jax(size, thr):
    rs = np.random.RandomState(size)
    g = (rs.randn(size) * thr * 1.5).astype(np.float32)
    r = (rs.randn(size) * 0.3 * thr).astype(np.float32)
    jp, jr = J.quantize_2bit(jnp.asarray(g), jnp.asarray(r), thr)
    tp, tr = T.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r), thr)
    assert tp.shape == (-(-size // 16),) == tuple(jp.shape)
    assert T._num_words(size) == J._num_words(size)
    np.testing.assert_array_equal(_words(tp), np.asarray(jp))
    np.testing.assert_array_equal(tr.numpy().view(np.uint32),
                                  np.asarray(jr).view(np.uint32))
    jd = J.dequantize_2bit(jp, (size,), thr)
    td = T.dequantize_2bit(tp, (size,), thr)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the words read back the same through their int32 wire bits
    np.testing.assert_array_equal(
        T.dequantize_2bit(tp.view(torch.int32), (size,), thr).numpy(),
        td.numpy())


def test_2bit_shapes_and_error_feedback():
    g = torch.from_numpy(np.random.RandomState(1).normal(size=(3, 7))
                         .astype(np.float32))
    packed, res = T.quantize_2bit(g, torch.zeros_like(g), 0.25)
    assert packed.shape == (2,) and res.shape == g.shape
    deq = T.dequantize_2bit(packed, g.shape, 0.25)
    assert set(np.unique(deq.numpy())) <= {0.0, 0.25, -0.25}
    torch.testing.assert_close(deq + res, g, rtol=0, atol=1e-7)
    # the residual keeps the signal: the mean transmitted value converges
    small = torch.from_numpy(np.random.RandomState(0).uniform(-0.2, 0.2, 64)
                             .astype(np.float32))
    res, total = torch.zeros_like(small), torch.zeros_like(small)
    for _ in range(50):
        p, res = T.quantize_2bit(small, res, 0.5)
        total += T.dequantize_2bit(p, small.shape, 0.5)
    np.testing.assert_allclose(total.numpy() / 50, small.numpy(),
                               atol=0.5 / 50 + 1e-5)


def test_fp16_wire_and_compressor_checks():
    c, jc = T.GradientCompression(type="fp16"), J.GradientCompression("fp16")
    g = np.linspace(-2, 2, 37, dtype=np.float32)
    packed = c.compress("k", torch.from_numpy(g))
    assert packed.dtype == torch.float16 and packed.shape == (37,)
    back = c.decompress(packed, g.shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jc.decompress(jc.compress("k",
                                                           jnp.asarray(g)),
                                               g.shape)))
    assert T.GradientCompression("2bit").compress(
        "k", torch.zeros(17)).shape == (2,)
    assert T.GradientCompression("2bit", threshold="0.25").threshold == 0.25
    for bad in ({"type": "1bit"}, {"threshold": 0}, {"threshold": "x"}):
        with pytest.raises(mt.MXNetError):
            T.GradientCompression(**bad)


def test_kvstore_compressed_push_matches_jax():
    """``tests/test_gradient_compression.py::test_kvstore_compressed_push``
    in both packages: two device shards, two pushes."""
    shards = [[0.9, -0.9, 0.1, 0.0], [0.6, 0.3, -0.7, 0.0]]
    got = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        kv = pkg.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(3, pkg.nd.zeros((4,), **kw))
        out = pkg.nd.zeros((4,), **kw)
        vals = []
        for _ in range(2):
            kv.push(3, [pkg.nd.array(s, **kw) for s in shards])
            kv.pull(3, out=out)
            vals.append(out.asnumpy())
        got.append(vals)
    np.testing.assert_array_equal(got[1][0], [1.0, -0.5, -0.5, 0.0])
    np.testing.assert_array_equal(got[1][1], [1.0, 0.0, -0.5, 0.0])
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("ctype", ["2bit", "fp16"])
def test_one_worker_dist_store_quantises_toward_the_wire(ctype):
    g1 = np.array([0.3, 0.7, -0.9, 0.30001], np.float32)
    g2 = np.array([0.4, -0.2, 0.6, 0.2], np.float32)
    got = []
    for pkg, kw in ((mx, {}), (mt, {"ctx": CPU})):
        kv = pkg.kv.create("dist_sync")
        kv.set_gradient_compression({"type": ctype, "threshold": 0.5}
                                    if ctype == "2bit" else {"type": ctype})
        kv.init("w", pkg.nd.zeros((4,), **kw))
        out = pkg.nd.zeros((4,), **kw)
        vals = []
        for g in (g1, g2):
            kv.push("w", pkg.nd.array(g, **kw))
            kv.pull("w", out=out)
            vals.append(out.asnumpy())
        assert kv.wire_bytes_last_push == 0     # one worker: no wire
        got.append(vals)
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)
