"""Serving in the PyTorch port: parity with the JAX package's engine on a
small fused-tail ResNet v1, and the engine's batching contract.

(a) A ResNet v1 with a downsample block in every stage and a fused
    BN+add+ReLU tail in every block is built, initialised and exported
    by the JAX package; its weights (BN statistics randomised so the
    folded coefficients matter) carry across with ``params_from_numpy``
    and the same requests go through both ``InferenceEngine``s. They
    agree to rtol 1e-4 / atol 1e-5: both sides are fp32, but XLA and
    oneDNN sum the convolutions in different orders and the JAX stem
    runs its space-to-depth rewrite.
(b) The port's own Gluon build with the carried weights gives the same
    logits.
(c) The engine's batching contract within the port, mirroring
    ``tests/test_serving.py``: bucket sizes, bit-exactness at a fixed
    bucket shape (full bucket, padded slice, multi-request packing),
    the cross-bucket tolerance, bucket boundaries, deadline and fill
    flushes, clean shutdown, request validation, shedding and
    per-request deadlines.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.serving import InferenceEngine as JaxEngine

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (InferenceEngine, bucket_sizes,
                                     CircuitOpen, DeadlineExceeded,
                                     QueueOverflow)
from mxnet_tpu_torch.weights import params_from_numpy, load_into_block

HW = 32
ROWS = (1, 3, 2, 4, 1)
CPU = mt.cpu()


def _small(pkg, resnet):
    with pkg.name.NameManager():
        return resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                               [16, 32, 64, 128, 256], classes=10)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX-exported small fused ResNet, its carried weights, the port's
    Gluon build of the same model, and one set of requests."""
    path = str(tmp_path_factory.mktemp("resnet") / "net")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_FUSED_BN_ADD_RELU", "1")
        mj.layout.set_default_layout("NHWC")
        mt.layout.set_default_layout("NHWC")
        try:
            jnet = _small(mj, jresnet)
            jnet.initialize(mj.init.Xavier())
            jnet(mj.nd.zeros((1, HW, HW, 3)))
            with mj.name.NameManager():
                jnet.export(path)
            tnet = _small(mt, tresnet)
        finally:
            mj.layout.set_default_layout(None)
            mt.layout.set_default_layout(None)
    rs = np.random.RandomState(0)
    with np.load(path + "-0000.params") as f:
        blob = {k: f[k] for k in f.keys()}
    for k, v in blob.items():
        if k.endswith(("gamma", "running_var")):
            blob[k] = (rs.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith(("beta", "running_mean")):
            blob[k] = (rs.randn(*v.shape) * 0.2).astype(np.float32)
    reqs = [rs.uniform(-1, 1, (r, HW, HW, 3)).astype(np.float32)
            for r in ROWS]
    return {"json": path + "-symbol.json", "blob": blob, "tnet": tnet,
            "reqs": reqs}


def _serve(engine, reqs):
    with engine:
        futs = [engine.submit(data=x) for x in reqs]
        return [f.result(timeout=120)[0] for f in futs]


def _port_engine(carried, **kw):
    sym = mt.sym.load(carried["json"])
    shapes = {"data": (1, HW, HW, 3)}
    params = params_from_numpy(carried["blob"], ctx=CPU, symbol=sym,
                               input_shapes=shapes)
    return InferenceEngine(sym, params, shapes, ctx=CPU, **kw)


def test_engine_matches_jax_engine(carried):
    jsym = mj.sym.load(carried["json"])
    jparams = {k: mj.nd.array(v) for k, v in carried["blob"].items()}
    want = _serve(JaxEngine(jsym, jparams, {"data": (1, HW, HW, 3)},
                            max_batch=4, max_wait_ms=5.0), carried["reqs"])
    got = _serve(_port_engine(carried, max_batch=4, max_wait_ms=5.0),
                 carried["reqs"])
    for x, g, w in zip(carried["reqs"], got, want):
        assert g.shape == (x.shape[0], 10)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert np.abs(np.concatenate(want)).max() > 1e-2   # not a zero model


def test_gluon_build_with_carried_weights(carried):
    tnet = carried["tnet"]
    load_into_block(tnet, carried["blob"], ctx=CPU)
    got = _serve(_port_engine(carried, max_batch=4, max_wait_ms=5.0),
                 carried["reqs"])
    for x, g in zip(carried["reqs"], got):
        eager = tnet(mt.nd.array(x, ctx=CPU)).asnumpy()
        np.testing.assert_allclose(eager, g, rtol=1e-5, atol=1e-6)


def test_carried_weights_are_checked(carried):
    sym = mt.sym.load(carried["json"])
    blob = dict(carried["blob"])
    name = next(k for k in blob if k.endswith("conv2d0_weight"))
    with pytest.raises(mt.MXNetError, match="shape"):
        params_from_numpy({**blob, name: blob[name][:1]}, ctx=CPU,
                          symbol=sym, input_shapes={"data": (1, HW, HW, 3)})
    with pytest.raises(mt.MXNetError, match="missing"):
        params_from_numpy({k: v for k, v in blob.items() if k != name},
                          ctx=CPU, symbol=sym)
    with pytest.raises(mt.MXNetError, match="extra"):
        params_from_numpy({**blob, "arg:bogus_weight": blob[name]},
                          ctx=CPU, symbol=sym)
    with pytest.raises(mt.MXNetError, match="extra"):
        load_into_block(carried["tnet"], {**blob, "bogus_bias": blob[name]})


# ---------------------------------------------------------------------------
# (c) the batching contract, on a small MLP (mirrors tests/test_serving.py)
# ---------------------------------------------------------------------------

D, C = 5, 3


def _mlp():
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mt.sym.Activation(net, act_type="relu", name="relu1")
    net = mt.sym.FullyConnected(net, num_hidden=C, name="fc2")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def _params(symbol, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    shapes, _, _ = symbol.infer_shape_partial(data=(2, D))
    return {"arg:" + name: mt.nd.array(
        rng.normal(0, 0.5, shape).astype(np.float32), ctx=CPU, dtype=dtype)
        for name, shape in zip(symbol.list_arguments(), shapes)
        if name not in ("data", "softmax_label")}


def _engine(params=None, dtype=None, **kw):
    sym = _mlp()
    params = params if params is not None else _params(sym)
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 20.0)
    return sym, params, InferenceEngine(sym, params, {"data": (1, D)},
                                        dtype=dtype, ctx=CPU, **kw)


def test_bucket_sizes():
    assert bucket_sizes(8) == [1, 2, 4, 8]
    assert bucket_sizes(1) == [1]
    assert bucket_sizes(12) == [1, 2, 4, 8, 12]
    with pytest.raises(mt.MXNetError):
        bucket_sizes(0)


def test_full_bucket_bit_exact_vs_unbatched():
    sym, params, eng = _engine(max_wait_ms=500.0)
    rng = np.random.RandomState(1)
    xs = [rng.normal(size=(1, D)).astype(np.float32) for _ in range(4)]
    with eng:
        outs = [f.result(timeout=60)
                for f in [eng.submit(data=x) for x in xs]]
    assert eng.stats()["buckets"] == {"4": 1}
    oracle = Predictor(sym, params, {"data": (4, D)}, ctx=CPU)
    oracle.forward(data=np.concatenate(xs, axis=0))
    ref = oracle.get_output(0).asnumpy()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o[0], ref[i:i + 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_slice_bit_exact(dtype):
    sym = _mlp()
    params = _params(sym, dtype=dtype)
    eng = InferenceEngine(sym, params, {"data": (1, D)}, dtype=dtype,
                          max_batch=8, max_wait_ms=10_000.0, ctx=CPU)
    x = np.random.RandomState(2).normal(size=(5, D)).astype(np.float32)
    with eng:
        fut = eng.submit(data=x)
        eng.flush()
        out = fut.result(timeout=60)
    st = eng.stats()
    assert st["buckets"] == {"8": 1} and st["pad_rows"] == 3
    assert st["pad_bytes"] == 3 * D * torch.empty((), dtype=dtype).itemsize
    padded = np.zeros((8, D), np.float32)
    padded[:5] = x
    oracle = Predictor(sym, params, {"data": (8, D)}, dtype=dtype, ctx=CPU)
    oracle.forward(data=padded)
    np.testing.assert_array_equal(out[0], oracle.get_output(0).asnumpy()[:5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_request_packing_bit_exact(dtype):
    sym = _mlp()
    params = _params(sym, dtype=dtype)
    eng = InferenceEngine(sym, params, {"data": (1, D)}, dtype=dtype,
                          max_batch=4, max_wait_ms=10_000.0, ctx=CPU)
    rng = np.random.RandomState(3)
    parts = [rng.normal(size=(r, D)).astype(np.float32) for r in (1, 2, 1)]
    with eng:
        futs = [eng.submit(data=p) for p in parts]
        eng.flush()
        outs = [f.result(timeout=60) for f in futs]
    assert eng.stats()["batches"] == 1
    oracle = Predictor(sym, params, {"data": (4, D)}, dtype=dtype, ctx=CPU)
    oracle.forward(data=np.concatenate(parts, axis=0))
    ref = oracle.get_output(0).asnumpy()
    off = 0
    for p, o in zip(parts, outs):
        np.testing.assert_array_equal(o[0], ref[off:off + len(p)])
        off += len(p)


def test_cross_bucket_shape_ulp_tolerance():
    """Bucket 4 against a per-request batch-1 forward crosses program
    shapes: ULP-level agreement, not bitwise."""
    sym, params, eng = _engine(max_wait_ms=500.0)
    rng = np.random.RandomState(4)
    xs = [rng.normal(size=(1, D)).astype(np.float32) for _ in range(4)]
    with eng:
        outs = [f.result(timeout=60)
                for f in [eng.submit(data=x) for x in xs]]
    oracle = Predictor(sym, params, {"data": (1, D)}, ctx=CPU)
    for x, o in zip(xs, outs):
        oracle.forward(data=x)
        np.testing.assert_allclose(o[0], oracle.get_output(0).asnumpy(),
                                   rtol=0, atol=1e-6)


def test_bucket_selection_boundaries():
    sym, params, eng = _engine(max_batch=16, max_wait_ms=10_000.0)
    with eng:
        assert [eng.bucket_for(r) for r in (1, 2, 3, 4, 5, 8, 9, 16)] == \
            [1, 2, 4, 4, 8, 8, 16, 16]
        with pytest.raises(mt.MXNetError):
            eng.bucket_for(17)
        rng = np.random.RandomState(5)
        f4 = eng.submit(data=rng.normal(size=(4, D)).astype(np.float32))
        eng.flush()
        f4.result(timeout=60)
        st = eng.stats()
        assert st["buckets"] == {"4": 1} and st["pad_rows"] == 0
        f5 = eng.submit(data=rng.normal(size=(5, D)).astype(np.float32))
        eng.flush()
        f5.result(timeout=60)
        st = eng.stats()
        assert st["buckets"] == {"4": 1, "8": 1} and st["pad_rows"] == 3
        assert st["batch_fill"] == pytest.approx(9.0 / 12.0)


def test_deadline_flush_under_trickle_load():
    sym, params, eng = _engine(max_batch=8, max_wait_ms=30.0)
    with eng:
        t0 = time.perf_counter()
        out = eng.submit(data=np.random.RandomState(6).normal(
            size=(1, D)).astype(np.float32)).result(timeout=60)
        dt = time.perf_counter() - t0
    assert out[0].shape == (1, C)
    st = eng.stats()
    assert st["batches"] == 1 and st["buckets"] == {"1": 1}
    assert dt < 30.0


def test_fill_flush_coalesces_bursts():
    sym, params, eng = _engine(max_batch=8, max_wait_ms=5_000.0)
    rng = np.random.RandomState(7)
    xs = [rng.normal(size=(1, D)).astype(np.float32) for _ in range(16)]
    with eng:
        for f in [eng.submit(data=x) for x in xs]:
            f.result(timeout=60)
    st = eng.stats()
    assert st["batches"] == 2 and st["buckets"] == {"8": 2}
    assert st["batch_fill"] == 1.0 and st["pad_rows"] == 0


def test_clean_shutdown_with_inflight_requests():
    sym, params, eng = _engine(max_batch=4, max_wait_ms=10_000.0,
                               max_inflight=2)
    rng = np.random.RandomState(8)
    futs = [eng.submit(data=rng.normal(size=(1, D)).astype(np.float32))
            for _ in range(11)]
    eng.close()
    for f in futs:
        assert f.result(timeout=60)[0].shape == (1, C)
    st = eng.stats()
    assert st["resolved"] == 11 and st["queue_depth"] == 0
    assert st["latency_ms"]["p95_ms"] >= st["latency_ms"]["p50_ms"] >= 0.0
    with pytest.raises(mt.MXNetError):
        eng.submit(data=rng.normal(size=(1, D)).astype(np.float32))
    eng.close()  # idempotent


def test_request_validation():
    sym, params, eng = _engine(max_batch=4)
    rng = np.random.RandomState(11)
    with eng:
        with pytest.raises(mt.MXNetError, match="max_batch"):
            eng.submit(data=rng.normal(size=(5, D)).astype(np.float32))
        with pytest.raises(mt.MXNetError, match="shape"):
            eng.submit(data=rng.normal(size=(1, D + 1)).astype(np.float32))
        with pytest.raises(mt.MXNetError, match="inputs"):
            eng.submit(bogus=rng.normal(size=(1, D)).astype(np.float32))
        out = eng.predict(np.zeros((D,), np.float32))
        assert out[0].shape == (1, C)


def test_admission_shed_when_queue_full():
    sym, params, eng = _engine(max_batch=8, max_wait_ms=10_000.0,
                               max_queue_rows=2, overload="shed")
    rng = np.random.RandomState(12)
    xs = [rng.normal(size=(1, D)).astype(np.float32) for _ in range(3)]
    with eng:
        futs = [eng.submit(data=xs[0]), eng.submit(data=xs[1])]
        with pytest.raises(QueueOverflow):
            eng.submit(data=xs[2])
        eng.flush()
        for f in futs:
            assert f.result(timeout=60)[0].shape == (1, C)
    st = eng.stats()
    assert st["shed_by_cause"] == {"admission": 1}
    assert st["requests"] == 2 and st["resolved"] == 2
    assert st["queue_depth"] == 0


def test_block_policy_gives_up_at_deadline():
    sym, params, eng = _engine(max_batch=8, max_wait_ms=10_000.0,
                               max_queue_rows=1, overload="block")
    rng = np.random.RandomState(14)
    x = rng.normal(size=(1, D)).astype(np.float32)
    with eng:
        f0 = eng.submit(data=x)
        t0 = time.perf_counter()
        with pytest.raises(DeadlineExceeded):
            eng.submit(data=x, deadline_ms=50)
        assert time.perf_counter() - t0 >= 0.04
        eng.flush()
        assert f0.result(timeout=60)[0].shape == (1, C)
    assert eng.stats()["shed_by_cause"] == {"admission": 1}


def _failing_forward(eng, exc, times=None):
    """Make the engine's forward raise ``exc`` (``times`` times, or
    always); returns the call count."""
    real, calls = eng._forward, [0]

    def forward(*a):
        calls[0] += 1
        if times is None or calls[0] <= times:
            raise exc
        return real(*a)

    eng._forward = forward
    return calls


def _transient(msg):
    err = MXNetError(msg)
    err.transient = True
    return err


def test_transient_launch_failure_retried_within_budget():
    sym, params, eng = _engine(retry_budget=2, retry_backoff_ms=1.0)
    x = np.random.RandomState(15).normal(size=(1, D)).astype(np.float32)
    with eng:
        calls = _failing_forward(eng, _transient("device busy"), times=1)
        assert eng.submit(data=x).result(timeout=60)[0].shape == (1, C)
    st = eng.stats()
    assert calls[0] == 2
    assert st["retries"] == 1 and st["dispatch_failures"] == 0


def test_program_errors_never_retry():
    sym, params, eng = _engine(retry_budget=3, breaker_threshold=0)
    x = np.random.RandomState(16).normal(size=(1, D)).astype(np.float32)
    with eng:
        calls = _failing_forward(eng, ValueError("a program error"), times=1)
        with pytest.raises(ValueError):
            eng.submit(data=x).result(timeout=60)
        assert calls[0] == 1 and eng.stats()["retries"] == 0
        assert eng.submit(data=x).result(timeout=60)[0].shape == (1, C)


def test_breaker_trips_fast_fails_and_recovers():
    sym, params, eng = _engine(retry_budget=0, breaker_threshold=2,
                               breaker_reset_s=0.15)
    x = np.random.RandomState(17).normal(size=(1, D)).astype(np.float32)
    with eng:
        real = eng._forward
        calls = _failing_forward(eng, _transient("device lost"))
        for _ in range(2):
            with pytest.raises(MXNetError, match="device lost"):
                eng.submit(data=x).result(timeout=60)
        st = eng.stats()["breaker"]
        assert st["open"] and st["trips"] == 1
        assert st["consecutive_failures"] == 2
        with pytest.raises(CircuitOpen):        # no forward is attempted
            eng.submit(data=x)
        assert calls[0] == 2 and eng.stats()["breaker"]["fastfail"] == 1
        # after the cooldown one half-open trial closes the breaker again
        eng._forward = real
        time.sleep(0.2)
        assert eng.submit(data=x).result(timeout=60)[0].shape == (1, C)
        assert not eng.stats()["breaker"]["open"]
        # an operator can close a tripped breaker at once
        _failing_forward(eng, _transient("device lost"), times=2)
        for _ in range(2):
            with pytest.raises(MXNetError):
                eng.submit(data=x).result(timeout=60)
        assert eng.stats()["breaker"]["open"]
        eng.reset_breaker()
        assert eng.submit(data=x).result(timeout=60)[0].shape == (1, C)
        assert eng.stats()["breaker"]["consecutive_failures"] == 0


def test_per_request_deadline_sheds_stale_request():
    sym, params, eng = _engine(max_batch=8, max_wait_ms=10_000.0)
    rng = np.random.RandomState(13)
    with eng:
        stale = eng.submit(data=rng.normal(size=(1, D)).astype(np.float32),
                           deadline_ms=1.0)
        fresh = eng.submit(data=rng.normal(size=(2, D)).astype(np.float32))
        time.sleep(0.05)
        eng.flush()
        with pytest.raises(DeadlineExceeded):
            stale.result(timeout=60)
        assert fresh.result(timeout=60)[0].shape == (2, C)
    st = eng.stats()
    assert st["shed_by_cause"] == {"coalesce": 1}
    assert st["buckets"] == {"2": 1} and st["queue_depth"] == 0


_LAT_SAMPLES = [5.0, 1.0, 2.25, 3.0, 4.0, 10.123456, 7.0, 2.0, 6.5, 9.0, 8.0]


def test_latency_percentiles_take_the_jax_rule():
    """``stats()['latency_ms']`` by the nearest rank, rounded to 4
    decimals, as the JAX package's telemetry computes it (ROADMAP Queue 3,
    fault 5: the port interpolated with ``np.percentile``)."""
    from mxnet_tpu import telemetry
    _, _, eng = _engine()
    try:
        eng._latencies.extend(_LAT_SAMPLES)
        got = eng.stats()["latency_ms"]
    finally:
        eng.close()
    s = sorted(_LAT_SAMPLES)
    assert got == {"p%d_ms" % q: round(telemetry._percentile(s, q), 4)
                   for q in (50, 95, 99)}
    assert got["p95_ms"] == got["p99_ms"] == 10.1235
