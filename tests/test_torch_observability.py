"""The instruments and controls on the port's serving, decode and training
paths, against the JAX package on the same inputs.

(a) Serving, on the same request stream (``max_wait_ms`` large, bursts
    that fill each bucket, then ``flush()``, so the batching is
    deterministic): the telemetry counters, the span names and counts,
    ``stats()`` counts and the bucket cards with their dispatch counts
    equal the JAX engine's; the outputs agree at the serving tolerance
    of ``tests/test_torch_serving.py`` (rtol 1e-4, atol 1e-5); the
    engine accepts every constructor argument of the JAX engine (the
    meshes' own tests are ``tests/test_torch_engine_mesh.py``).
(b) The overload and failure behaviour of ``tests/test_serving_faults.py``
    on the port's engine, with the ``dispatch`` and ``d2h`` fault sites,
    the flight recorder's dumps and ``TelemetryLogger.log_serving``.
(c) Autotune: the same corpus records give equal ``plan_serving`` plans
    in both packages; an ``autotune=True`` engine takes the plan's
    buckets and stamps it on every card; an empty corpus leaves the
    pow-2 default.
(d) Decode: the ``DECODE_SPANS`` counts and ``decode.*`` counters equal
    the JAX engine's on the same prompts; tokens are bit-equal with
    telemetry on and off; the cards, ``corpus_record`` and the
    scheduler-death postmortem.
(e) ``mx.profiler``: ``dump()`` after a CPU forward writes one JSON that
    loads, with the aten events and the host spans merged on one
    timebase (a host span encloses the operators it launched).
(f) ``mx.monitor``: an executor's op outputs reach the monitor.

Not ported, with the ROADMAP item that brings it:
``test_profiler_autostart_env`` (``config.py``'s
``MXNET_PROFILER_AUTOSTART``, item 6), ``test_print_summary`` and
``test_plot_network_graphviz_or_skip`` (``visualization.py``, item 6).
"""
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.decode as jdec
from mxnet_tpu import telemetry as jt, faults as jfaults
from mxnet_tpu.serving import InferenceEngine as JEngine
from mxnet_tpu.tuner import plan_serving as jplan

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import telemetry as tt, faults, flight
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.decode import (DecodeEngine, AttentionDecodeCell,
                                    LSTMDecodeCell)
from mxnet_tpu_torch.serving import (InferenceEngine, DeadlineExceeded,
                                     QueueOverflow, CircuitOpen,
                                     EngineClosed, bucket_sizes,
                                     validate_buckets, _Request)
from mxnet_tpu_torch.tuner import plan_serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import flight_view  # noqa: E402  (stdlib-only CLI module)

CPU = mt.cpu()
D, HID, C = 4, 8, 2


@pytest.fixture(autouse=True)
def _clean():
    hooks = (sys.excepthook, threading.excepthook)
    for t in (tt, jt):
        t.enable()
        t.reset()
    for f in (faults, jfaults):
        f.clear()
    yield
    for f in (faults, jfaults):
        f.clear()
    flight.sampler_stop()
    flight.metrics_http_stop()
    flight.series_clear()
    flight.configure(None)
    flight.uninstall()
    for t in (tt, jt):
        t.enable()
        t.reset()
    assert (sys.excepthook, threading.excepthook) == hooks


def _mlp(m):
    with m.name.NameManager():
        data = m.sym.Variable("data")
        net = m.sym.FullyConnected(data, num_hidden=HID, name="fc1")
        net = m.sym.Activation(net, act_type="relu", name="relu1")
        net = m.sym.FullyConnected(net, num_hidden=C, name="fc2")
        return m.sym.SoftmaxOutput(net, name="softmax")


def _weights():
    rng = np.random.RandomState(0)
    shapes, _, _ = _mlp(mt).infer_shape_partial(data=(2, D))
    return {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(_mlp(mt).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _engine(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 1.0)
    params = {"arg:" + n: mt.nd.array(v, ctx=CPU)
              for n, v in _weights().items()}
    return InferenceEngine(_mlp(mt), params, {"data": (1, D)}, ctx=CPU,
                           **kw)


def _jengine(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 1.0)
    params = {"arg:" + n: mx.nd.array(v) for n, v in _weights().items()}
    return JEngine(_mlp(mx), params, {"data": (1, D)}, **kw)


def _req(rows=1, seed=1):
    return np.random.RandomState(seed).normal(size=(rows, D)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# (a) serving parity on one request stream
# ---------------------------------------------------------------------------

# bursts of row counts: each fills a bucket (8) or is flushed as it is
BURSTS = ([1] * 8, [3, 1], [2], [1], [4, 4], [3, 2, 1], [5])


def _stream(eng):
    outs = []
    seed = 0
    for burst in BURSTS:
        futs = []
        for rows in burst:
            seed += 1
            futs.append(eng.submit(data=_req(rows, seed)))
        if sum(burst) < eng.max_batch:
            eng.flush()
        outs += [f.result(timeout=60)[0] for f in futs]
    return outs


def _bucket_dispatches(cards):
    """{bucket: dispatches} from a card set: the batch dim of the data
    argument in each card's signature."""
    out = {}
    for c in cards.values():
        data = next(e for e in c["signature"] if "'data'" in e[0])
        out[data[1][0]] = c["dispatches"]
    return out


def test_serving_telemetry_matches_the_jax_engine():
    got, want = {}, {}
    for make, t, res in ((_engine, tt, got), (_jengine, jt, want)):
        eng = make(max_wait_ms=10000)
        t.reset()
        try:
            res["outs"] = _stream(eng)
            res["counters"] = t.counters()
            res["spans"] = {n: t.span_count(n) for n in t.SERVE_SPANS}
            res["cards"] = _bucket_dispatches(eng.program_cards())
            st = eng.stats()
        finally:
            eng.close()
        res["stats"] = {k: st[k] for k in (
            "requests", "resolved", "batches", "rows", "pad_rows",
            "pad_bytes", "batch_fill", "queue_depth", "buckets",
            "rows_hist", "shed_requests", "failed_requests")}
        res["events"] = sorted(
            (e["kind"], json.dumps(e["data"], sort_keys=True))
            for e in t.events())
        res["span_names"] = sorted(
            {s["name"] for s in t.recent_spans()})
    assert got["counters"] == want["counters"]
    assert got["spans"] == want["spans"]
    assert got["stats"] == want["stats"]
    assert got["cards"] == want["cards"] == {1: 1, 2: 1, 4: 1, 8: 4}
    assert got["span_names"] == want["span_names"]
    # the events carry process-unique req_ids: compare kinds and shapes
    assert [k for k, _ in got["events"]] == [k for k, _ in want["events"]]
    n = sum(len(b) for b in BURSTS)
    assert got["counters"]["serving.requests"] == n
    assert got["spans"]["serve_request"] == n
    for g, w in zip(got["outs"], want["outs"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_bucket_card_flops_are_the_analytic_count():
    eng = _engine()
    try:
        cards = eng.program_cards()
        assert len(cards) == len(eng.buckets)
        for c in cards.values():
            b = next(e for e in c["signature"] if "'data'" in e[0])[1][0]
            assert c["flops"] == 2 * b * (D * HID + HID * C)
            assert c["dispatches"] == 0          # warm-up counts none
    finally:
        eng.close()


def test_engine_takes_every_jax_constructor_argument():
    import inspect
    want = inspect.signature(JEngine.__init__).parameters
    got = inspect.signature(InferenceEngine.__init__).parameters
    assert list(got) == list(want)
    want = inspect.signature(jdec.DecodeEngine.__init__).parameters
    got = inspect.signature(DecodeEngine.__init__).parameters
    assert list(got) == list(want)


@pytest.mark.parametrize("kw", [{"partition_rules": object()},
                                {"mesh_axes": {"dp": 1, "mp": -1}},
                                {"contexts": [CPU]}])
def test_mesh_arguments_raise_naming_the_roadmap_item(kw):
    """The serving meshes are ported (``tests/test_torch_engine_mesh.py``).
    Of these arguments only a rule tree that is not one raises; a mesh of
    one device, and ``contexts=`` alone (which the JAX package ignores
    without rules or axes), serve what the plain engine serves."""
    if "partition_rules" in kw:
        with pytest.raises(MXNetError, match="partition_rules must be"):
            _engine(**kw)
        return
    with _engine(**kw) as eng, _engine() as plain:
        x = _req(3)
        assert np.array_equal(eng.predict(data=x)[0],
                              plain.predict(data=x)[0])
        assert (eng.partition_summary() is None) == ("contexts" in kw)


def test_stats_surface_and_device_bytes():
    with _engine() as eng:
        eng.predict(data=_req(3))
        st = eng.stats()
        ov = eng.overload_state()
        db = eng.device_bytes()
    with _jengine() as jeng:
        jeng.predict(data=_req(3))
        jst = jeng.stats()
        jov = jeng.overload_state()
        jdb = jeng.device_bytes()
    assert set(st) == set(jst)
    assert set(ov) == set(jov) and set(db) == set(jdb)
    assert db["context"] == str(CPU) and db["total"] > 0
    assert st["process"]["rank"] == 0 and eng.partition_summary() is None


# ---------------------------------------------------------------------------
# (b) overload and failures (tests/test_serving_faults.py)
# ---------------------------------------------------------------------------

def test_deadline_shed_at_coalesce_time():
    eng = _engine(max_wait_ms=10000)
    try:
        f = eng.submit(data=_req(), deadline_ms=10)
        time.sleep(0.05)
        eng.flush()
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=10)
        st = eng.stats()
        assert st["shed_requests"] == 1 and st["shed_rows"] == 1
        assert st["shed_by_cause"] == {"coalesce": 1}
        assert st["queue_depth"] == 0
        c = tt.counters()
        assert c["serving.shed.coalesce"] == 1
        assert c["serving.deadline_exceeded"] == 1
    finally:
        eng.close()


def test_deadline_shed_at_resolve_time():
    eng = _engine()
    try:
        faults.configure("d2h:delay=120")
        with pytest.raises(DeadlineExceeded):
            eng.submit(data=_req(), deadline_ms=30).result(timeout=10)
        assert eng.stats()["shed_by_cause"] == {"resolve": 1}
    finally:
        eng.close()


def test_engine_default_deadline_applies():
    eng = _engine(max_wait_ms=10000, deadline_ms=10)
    try:
        f = eng.submit(data=_req())
        time.sleep(0.05)
        eng.flush()
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=10)
    finally:
        eng.close()


def test_no_deadline_means_no_shedding():
    eng = _engine(max_wait_ms=10000)
    try:
        f = eng.submit(data=_req())
        time.sleep(0.05)
        eng.flush()
        assert f.result(timeout=10)[0].shape == (1, C)
        assert eng.stats()["shed_requests"] == 0
    finally:
        eng.close()


def test_block_policy_backpressures_until_space():
    eng = _engine(max_wait_ms=10000, max_queue_rows=2, overload="block")
    try:
        fs = [eng.submit(data=_req()) for _ in range(2)]
        done = threading.Event()
        holder = {}

        def blocked_submit():
            holder["future"] = eng.submit(data=_req())
            done.set()

        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        assert not done.wait(0.1)
        eng.flush()
        assert done.wait(5)
        eng.flush()
        assert holder["future"].result(timeout=10)[0].shape == (1, C)
        for f in fs:
            assert f.result(timeout=10)[0].shape == (1, C)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        eng.close()


def test_retry_budget_exhausts_then_fails_structured():
    eng = _engine(retry_budget=1, retry_backoff_ms=1.0, breaker_threshold=0)
    try:
        faults.configure("dispatch:raise")
        with pytest.raises(faults.InjectedFault):
            eng.submit(data=_req()).result(timeout=10)
        st = eng.stats()
        assert st["retries"] == 1 and st["dispatch_failures"] == 1
        c = tt.counters()
        assert c["serving.retries"] == 1 == c["serving.dispatch_failures"]
        assert c["faults.injected.dispatch"] == 2
        faults.clear()
        assert eng.submit(data=_req()).result(timeout=10)[0].shape == (1, C)
    finally:
        eng.close()


def test_breaker_fast_fails_queued_requests():
    eng = _engine(max_wait_ms=10000, retry_budget=0, breaker_threshold=1,
                  breaker_reset_s=30.0)
    try:
        faults.configure("dispatch:raise")
        f0 = eng.submit(data=_req())
        eng.flush()
        with pytest.raises(faults.InjectedFault):
            f0.result(timeout=10)
        faults.clear()
        assert eng._breaker_tripped()
        with pytest.raises(CircuitOpen):
            eng.submit(data=_req())
        raced = _Request({"data": _req()}, 1)
        eng._dispatch([raced])
        with pytest.raises(CircuitOpen):
            raced.future.result(timeout=10)
        assert eng.stats()["breaker"]["fastfail"] >= 2
        assert tt.counters()["serving.breaker_fastfail"] >= 2
    finally:
        eng.close()


def test_midflight_failure_resolves_every_pending_future():
    eng = _engine(max_wait_ms=10000, retry_budget=0, breaker_threshold=0)
    try:
        faults.configure("dispatch:raise")
        futs = [eng.submit(data=_req()) for _ in range(5)]
        eng.flush()
        for f in futs:
            with pytest.raises(faults.InjectedFault):
                f.result(timeout=10)
        faults.clear()
        f = eng.submit(data=_req())
        eng.flush()
        assert f.result(timeout=10)[0].shape == (1, C)
    finally:
        eng.close()


def test_d2h_failure_resolves_every_pending_future():
    eng = _engine(max_wait_ms=10000, breaker_threshold=0)
    try:
        faults.configure("d2h:raise:n=1")
        futs = [eng.submit(data=_req()) for _ in range(3)]
        eng.flush()
        for f in futs:
            with pytest.raises(faults.InjectedFault):
                f.result(timeout=10)
        faults.clear()
        f = eng.submit(data=_req())
        eng.flush()
        assert f.result(timeout=10)[0].shape == (1, C)
    finally:
        eng.close()


def test_d2h_nan_corruption_reaches_the_client_as_in_jax():
    got = {}
    for make, f in ((_engine, faults), (_jengine, jfaults)):
        with make() as eng:
            f.configure("d2h:nan:n=1")
            out = eng.submit(data=_req(2)).result(timeout=10)[0]
            got[make] = np.asarray(out)
            assert np.isfinite(np.asarray(
                eng.submit(data=_req()).result(timeout=10)[0])).all()
    assert np.isnan(got[_engine].reshape(-1)[0])
    assert np.array_equal(np.isnan(got[_engine]), np.isnan(got[_jengine]))


def test_dispatch_nan_fills_the_batch_outputs():
    """``dispatch:nan`` poisons that batch's outputs in the port (the JAX
    engine ignores ``nan`` at the dispatch site: ROADMAP Queue 3)."""
    with _engine(max_wait_ms=10000) as eng:
        faults.configure("dispatch:nan:n=1")
        futs = [eng.submit(data=_req(r)) for r in (1, 2)]
        eng.flush()
        for f in futs:
            assert np.isnan(f.result(timeout=10)[0]).all()
        f = eng.submit(data=_req())
        eng.flush()
        assert np.isfinite(f.result(timeout=10)[0]).all()


def test_d2h_retry_as_a_client_and_counts():
    """One injected fetch failure: the client retries once, every request
    is answered, and the site fired exactly once."""
    with _engine(breaker_threshold=3) as eng:
        faults.configure("d2h:raise:n=1")
        answered = 0
        for i in range(8):
            try:
                eng.submit(data=_req(seed=i)).result(timeout=10)
            except faults.InjectedFault:
                eng.submit(data=_req(seed=i)).result(timeout=10)
            answered += 1
        assert answered == 8
        assert tt.counters()["faults.injected.d2h"] == 1


def test_queue_depth_stays_consistent_under_sheds_and_failures():
    eng = _engine(max_wait_ms=10000, max_queue_rows=2, retry_budget=0,
                  breaker_threshold=0)
    try:
        fs = [eng.submit(data=_req()) for _ in range(2)]
        for _ in range(3):
            with pytest.raises(QueueOverflow):
                eng.submit(data=_req())
        assert eng.stats()["queue_depth"] == 2
        faults.configure("dispatch:raise")
        eng.flush()
        for f in fs:
            with pytest.raises(faults.InjectedFault):
                f.result(timeout=10)
        st = eng.stats()
        assert st["failed_requests"] == 2 and st["queue_depth"] == 0
        assert st["shed_by_cause"] == {"admission": 3}
        assert tt.serving_queue_depth(tt.counters()) == 0
    finally:
        eng.close()


def test_fetch_failure_feeds_the_breaker():
    eng = _engine(retry_budget=0, breaker_threshold=2, breaker_reset_s=30.0)
    try:
        faults.configure("d2h:raise")
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                eng.submit(data=_req()).result(timeout=10)
        st = eng.stats()
        assert st["breaker"]["open"] is True
        assert st["dispatch_failures"] == 2
        with pytest.raises(CircuitOpen):
            eng.submit(data=_req())
    finally:
        eng.close()


def test_admission_shed_still_lands_a_latency_sample():
    eng = _engine(max_wait_ms=10000, max_queue_rows=1)
    try:
        base = tt.span_count("serve_request")
        f0 = eng.submit(data=_req())
        with pytest.raises(QueueOverflow):
            eng.submit(data=_req())
        assert tt.span_count("serve_request") == base + 1
        eng.flush()
        f0.result(timeout=10)
    finally:
        eng.close()


def test_close_resolves_inflight_then_fails_fast():
    eng = _engine(max_wait_ms=10000)
    futs = [eng.submit(data=_req()) for _ in range(3)]
    eng.close()
    for f in futs:
        assert f.result(timeout=10)[0].shape == (1, C)
    with pytest.raises(EngineClosed):
        eng.submit(data=_req())
    with pytest.raises(EngineClosed):
        eng.flush()
    for cls in (EngineClosed, DeadlineExceeded, QueueOverflow, CircuitOpen):
        assert issubclass(cls, MXNetError)


def test_failed_batch_still_records_request_spans():
    eng = _engine(max_wait_ms=10000, retry_budget=0, breaker_threshold=0)
    try:
        faults.configure("dispatch:raise")
        futs = [eng.submit(data=_req()) for _ in range(4)]
        eng.flush()
        for f in futs:
            with pytest.raises(faults.InjectedFault):
                f.result(timeout=10)
        assert tt.span_count("serve_request") == 4
        assert tt.span_count("serve_wait") == 4
        assert tt.counters()["serving.failed_requests"] == 4
    finally:
        eng.close()


def test_coalescer_death_fails_queued_futures_and_dumps(tmp_path):
    flight.configure(str(tmp_path))
    eng = _engine(max_wait_ms=10000)
    try:
        def _boom(batch):
            raise RuntimeError("seeded coalescer bug")

        eng._launch = _boom
        f = eng.submit(data=_req())
        eng.flush()
        with pytest.raises(MXNetError) as ei:
            f.result(timeout=10)
        assert "coalescer" in str(ei.value)
        with pytest.raises(EngineClosed):
            eng.submit(data=_req())
        st = eng.stats()
        assert st["shed_by_cause"].get("coalescer_death") == 1
        assert st["queued_rows"] == 0
        eng._thread.join(timeout=10)
        dumps = [p for p in os.listdir(str(tmp_path))
                 if "coalescer_death" in p]
        assert dumps
        rec = flight_view.load_dump(os.path.join(str(tmp_path), dumps[0]))
        assert rec["extra"]["failed_requests"] == 1
        assert rec["extra"]["engine"]["closed"] is True
        eng.close()
        assert eng._pool._shutdown
    finally:
        eng.close()


def test_coalescer_death_mid_launch_keeps_queue_accounting():
    eng = _engine(max_wait_ms=10000)
    try:
        def _boom(reqs):
            raise RuntimeError("seeded dispatch bug")

        eng._dispatch = _boom
        f = eng.submit(data=_req())
        eng.flush()
        with pytest.raises(MXNetError):
            f.result(timeout=10)
        st = eng.stats()
        assert st["queued_rows"] == 0, st
        assert st["shed_by_cause"].get("coalescer_death") == 1
    finally:
        eng.close()


def test_breaker_trip_dumps_a_postmortem_naming_the_batch(tmp_path):
    flight.configure(str(tmp_path))
    eng = _engine(max_wait_ms=10000, retry_budget=0, breaker_threshold=3)
    try:
        faults.configure("dispatch:raise:every=1")
        ids = []
        for _ in range(3):
            f = eng.submit(data=_req())
            ids.append(f.req_id)
            eng.flush()
            with pytest.raises(faults.InjectedFault):
                f.result(timeout=10)
        with pytest.raises(CircuitOpen):
            eng.submit(data=_req())
        names = os.listdir(str(tmp_path))
        trip = [p for p in names if "breaker_trip" in p]
        failure = sorted(p for p in names if "serving_dispatch_failure" in p)
        assert trip and failure
        rec = flight_view.load_dump(os.path.join(str(tmp_path), failure[0]))
        assert rec["extra"]["req_ids"] == [ids[0]]
        assert rec["exception"]["fault_site"] == "dispatch"
        assert flight_view.summarize(rec)["reason"] == \
            "serving_dispatch_failure"
        faults.clear()
        eng.reset_breaker()
        futs = [eng.submit(data=_req()) for _ in range(8)]
        for f in futs:
            assert f.result(timeout=10)[0].shape == (1, C)
    finally:
        eng.close()


def test_telemetry_logger_log_serving(caplog):
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.telemetry"):
        eng = _engine(telemetry_logger=mt.callback.TelemetryLogger(2))
        with eng:
            for i in range(6):
                eng.predict(data=_req(seed=i))
    lines = [r.message for r in caplog.records
             if r.message.startswith("serving:")]
    assert lines
    assert any("queue_depth=" in ln for ln in lines)
    assert any("p50/p95/p99=" in ln for ln in lines)
    assert any("batch_fill=" in ln for ln in lines)


def test_outputs_bit_equal_with_telemetry_on_and_off():
    outs = []
    for on in (True, False):
        (tt.enable if on else tt.disable)()
        with _engine(max_wait_ms=10000) as eng:
            outs.append(_stream(eng))
    tt.enable()
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (c) autotune
# ---------------------------------------------------------------------------

def test_custom_bucket_set():
    assert validate_buckets([3, 10], 16) == [3, 10, 16]
    assert validate_buckets([16, 3, 3, 10], 16) == [3, 10, 16]
    assert validate_buckets([99, -2], 16) == [16]
    with pytest.raises(MXNetError):
        validate_buckets(["x"], 16)
    with _engine(max_batch=16, buckets=[3, 10]) as eng:
        assert eng.buckets == [3, 10, 16]
        assert len(eng.program_cards()) == 3
        assert eng.bucket_for(2) == 3 and eng.bucket_for(4) == 10


def test_corpus_record_and_append_on_close(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CARD_CORPUS", str(tmp_path / "c.jsonl"))
    from mxnet_tpu_torch import compile_cache
    eng = _engine(max_batch=8)
    assert eng.corpus_record() is None
    for i in range(3):
        eng.predict(data=_req(2, seed=i))
    rec = eng.corpus_record()
    assert rec["kind"] == "serving" and rec["max_batch"] == 8
    assert rec["rows_hist"].get("2") == 3
    assert rec["buckets"] == [1, 2, 4, 8] and rec["cards"]
    assert rec["graph"] == eng._prog.graph_fingerprint()
    assert set(rec["env"]) == {"torch", "cuda", "driver", "devices"}
    eng.close()
    got = compile_cache.corpus_records(kind="serving")
    assert len(got) == 1 and got[0]["rows_hist"] == rec["rows_hist"]


def _corpus(tmp_path, monkeypatch):
    """A corpus banked by a port engine over skewed traffic (3-row
    batches)."""
    monkeypatch.setenv("MXNET_CARD_CORPUS", str(tmp_path / "c.jsonl"))
    monkeypatch.delenv("MXNET_COMPILE_CACHE", raising=False)
    with _engine(max_batch=8) as eng:
        for i in range(6):
            eng.predict(data=_req(3, seed=i))
    from mxnet_tpu_torch import compile_cache
    return compile_cache.corpus_records(kind="serving")


def test_plans_equal_across_packages(tmp_path, monkeypatch):
    recs = _corpus(tmp_path, monkeypatch)
    graph = recs[0]["graph"]
    with mx.name.NameManager():
        jgraph = mx.executor._GraphProgram(_mlp(mx)).graph_fingerprint()
    assert graph == jgraph
    for kw in ({}, {"max_batch": 8}, {"graph": graph},
               {"max_buckets": 2}, {"default_inflight": 5}):
        assert plan_serving(recs, **kw) == jplan(recs, **kw)
    extra = [{"kind": "serving", "max_batch": 16,
              "rows_hist": {"3": 50, "10": 30, "16": 5},
              "bucket_ms": {"4": {"total_ms": 40.0, "count": 10}},
              "spans": {"serve_d2h": {"total_ms": 100.0, "count": 10},
                        "serve_batch": {"total_ms": 50.0, "count": 10}}}]
    assert plan_serving(extra) == jplan(extra)
    assert plan_serving(extra)["buckets"] == [3, 10, 16]
    assert plan_serving([]) is None and jplan([]) is None


def test_autotune_engine_plans_from_corpus(tmp_path, monkeypatch):
    _corpus(tmp_path, monkeypatch)
    with _engine(max_batch=8, autotune=True) as tuned:
        plan = tuned.stats()["autotune_plan"]
        assert plan is not None and plan["kind"] == "autotune_plan"
        assert 3 in tuned.buckets and tuned.buckets[-1] == 8
        assert tuned.buckets == plan["buckets"]
        assert tuned._max_inflight == plan["max_inflight"]
        cards = tuned.program_cards()
        assert cards and all(c.get("autotune_plan") == plan
                             for c in cards.values())
        x = _req(3, seed=11)
        with _engine(max_batch=8) as plain:
            np.testing.assert_array_equal(tuned.predict(data=x)[0],
                                          plain.predict(data=x)[0])


def test_autotune_without_corpus_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CARD_CORPUS", str(tmp_path / "none.jsonl"))
    monkeypatch.delenv("MXNET_COMPILE_CACHE", raising=False)
    with _engine(max_batch=8, autotune=True) as eng:
        assert eng.buckets == bucket_sizes(8)
        assert eng.stats()["autotune_plan"] is None
        assert eng._max_inflight == 2


def test_explicit_buckets_override_autotune(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CARD_CORPUS", str(tmp_path / "c.jsonl"))
    from mxnet_tpu_torch import compile_cache
    compile_cache.corpus_append({"kind": "serving", "max_batch": 8,
                                 "rows_hist": {"3": 10}})
    with _engine(max_batch=8, autotune=True, buckets=[5]) as eng:
        assert eng.buckets == [5, 8]
        assert eng.stats()["autotune_plan"] is None


# ---------------------------------------------------------------------------
# (d) decode
# ---------------------------------------------------------------------------

PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3], [2, 7])
_KW = dict(slots=4, max_prompt_len=16, max_new_tokens=10)


def _cells():
    args = dict(vocab=29, embed=16, heads=4, head_dim=8, max_len=48)
    return jdec.AttentionDecodeCell(**args), AttentionDecodeCell(**args)


def _prompts():
    return [np.array(p, np.int32) for p in PROMPTS]


def test_decode_spans_and_counters_match_jax():
    jcell, tcell = _cells()
    got, want = {}, {}
    for make, t, res in (
            (lambda: DecodeEngine(tcell, tcell.init_params(1), ctx=CPU,
                                  **_KW), tt, got),
            (lambda: jdec.DecodeEngine(jcell, jcell.init_params(1), **_KW),
             jt, want)):
        eng = make()
        t.reset()
        with eng:
            res["tokens"] = [eng.generate(p).tokens for p in _prompts()]
            st = eng.stats()
        res["spans"] = {n: t.span_count(n)
                        for n in t.DECODE_SPANS + ("serve_request",
                                                   "serve_wait")}
        res["counters"] = {k: v for k, v in t.counters().items()
                           if k.startswith(("decode.", "dispatch."))}
        res["steps"] = (st["steps"], st["slot_admit"])
    assert got == want
    assert got["spans"]["serve_decode_step"] == got["steps"][0]
    assert got["spans"]["serve_prefill"] == got["steps"][1] == 4


def test_decode_tokens_bit_equal_with_telemetry_on_and_off():
    _, tcell = _cells()
    out = []
    for on in (True, False):
        (tt.enable if on else tt.disable)()
        with DecodeEngine(tcell, tcell.init_params(1), ctx=CPU,
                          keep_logits=True, **_KW) as eng:
            futs = [eng.submit(p) for p in _prompts()]
            out.append([f.result(timeout=120) for f in futs])
    tt.enable()
    for a, b in zip(*out):
        assert a.tokens == b.tokens
        assert np.array_equal(a.logits, b.logits)


def test_decode_cards_corpus_and_logger(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("MXNET_CARD_CORPUS", str(tmp_path / "c.jsonl"))
    args = dict(vocab=23, embed=8, hidden=16, max_len=32)
    cell = LSTMDecodeCell(**args)
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.telemetry"):
        eng = DecodeEngine(cell, cell.init_params(1), ctx=CPU,
                           telemetry_logger=mt.callback.TelemetryLogger(2),
                           **_KW)
        with eng:
            cards = eng.program_cards()
            assert len(cards) == len(eng.prompt_buckets) \
                + len(eng.slot_buckets)
            assert all(c["dispatches"] == 0 for c in cards.values())
            assert tt.counters()["decode.prefill_compiles"] == \
                len(eng.prompt_buckets)
            for p in _prompts():
                eng.generate(p)
            rec = eng.corpus_record()
            assert rec["kind"] == "decode" and rec["steps"] > 0
            assert eng.partition_summary() is None
            led = tt.ledger()[str(CPU)]["by_kind"]
            assert led["kv_cache"] >= eng.kv_cache_bytes()
    assert any(r.message.startswith("decode:") and "tok/s=" in r.message
               for r in caplog.records)
    from mxnet_tpu_torch import compile_cache
    assert compile_cache.corpus_records(kind="decode")


def test_decode_scheduler_death_dumps(tmp_path):
    flight.configure(str(tmp_path))
    _, tcell = _cells()
    eng = DecodeEngine(tcell, tcell.init_params(1), ctx=CPU, **_KW)
    try:
        def _boom(pending):
            raise RuntimeError("seeded scheduler bug")

        eng._admit = _boom
        f = eng.submit(_prompts()[0])
        with pytest.raises(MXNetError, match="scheduler"):
            f.result(timeout=30)
        eng._thread.join(timeout=30)
        dumps = [p for p in os.listdir(str(tmp_path))
                 if "decode_scheduler_death" in p]
        assert dumps
        rec = flight_view.load_dump(os.path.join(str(tmp_path), dumps[0]))
        assert rec["extra"]["failed_requests"] == 1
    finally:
        eng.close()


def test_decode_dispatch_site_poisons_then_pool_rebuilds(tmp_path):
    flight.configure(str(tmp_path))
    _, tcell = _cells()
    with DecodeEngine(tcell, tcell.init_params(1), ctx=CPU,
                      retry_budget=0, **_KW) as eng:
        faults.configure("dispatch:raise:n=1")
        with pytest.raises(MXNetError, match="poisoned"):
            eng.generate(_prompts()[0])
        faults.clear()
        assert len(eng.generate(_prompts()[0]).tokens) == 10
    assert any("decode_dispatch_failure" in p
               for p in os.listdir(str(tmp_path)))
    ev = [e["kind"] for e in tt.events()]
    assert "decode.pool_rebuilt" in ev


# ---------------------------------------------------------------------------
# (e) mx.profiler
# ---------------------------------------------------------------------------

def test_profiler_dump_merges_host_spans_on_one_timebase(tmp_path):
    fname = str(tmp_path / "profile.json")
    with _engine(max_batch=8) as eng:
        mt.profiler.set_config(filename=fname)
        mt.profiler.set_state("run")
        for i in range(3):
            eng.predict(data=_req(8, seed=i))
        mt.profiler.set_state("stop")
        mt.profiler.dump()
    with open(fname) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    host = [e for e in events if e.get("cat") == "host"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    assert {e["name"] for e in host} >= set(tt.SERVE_SPANS)
    assert any(e["name"].startswith("aten::") for e in ops)
    assert any(e.get("cat") == "flow" for e in events)
    assert any(e.get("ph") == "M" and e.get("name") == "process_name"
               and e["args"]["name"] == "mxnet_tpu host" for e in events)
    assert trace["otherData"]["mxnet_tpu_programs"]
    # each serve_batch span encloses the matmuls its forward launched
    batches = [e for e in host if e["name"] == "serve_batch"]
    mms = [e for e in ops if e["name"] in ("aten::addmm", "aten::linear",
                                           "aten::mm", "aten::matmul")]
    assert len(batches) == 3 and mms
    for b in batches:
        inside = [m for m in mms if b["ts"] <= m["ts"]
                  and m["ts"] + m["dur"] <= b["ts"] + b["dur"]]
        assert inside, (b, mms[:3])


def test_profiler_scope_region_in_trace(tmp_path):
    fname = str(tmp_path / "scope.json")
    mt.profiler.set_config(filename=fname)
    mt.profiler.set_state("run")
    with mt.profiler.Scope("my_hot_region"):
        a = mt.nd.ones((32, 32), ctx=CPU)
        mt.nd.dot(a, a).wait_to_read()
    mt.profiler.set_state("stop")
    with open(fname) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "host" and e["name"] == "my_hot_region"
               for e in events)
    assert any(e.get("cat") == "user_annotation"
               and e["name"] == "my_hot_region" for e in events)


def test_link_chrome_trace_fallback_without_export(tmp_path):
    fname = str(tmp_path / "fallback.json")
    empty = tmp_path / "empty_trace"
    empty.mkdir()
    old = dict(mt.profiler._state)
    try:
        mt.profiler._state.update({"running": False, "filename": fname,
                                   "dir": str(empty), "prof": None})
        tt.mark_trace_start()
        with tt.span("host_only_span"):
            pass
        mt.profiler._link_chrome_trace()
    finally:
        mt.profiler._state.update(old)
    with open(fname) as f:
        trace = json.load(f)
    assert "host_only_span" in {e["name"] for e in trace["traceEvents"]
                                if e.get("cat") == "host"}


def test_scope_releases_span_when_annotation_fails():
    class _BoomAnn:
        def __enter__(self):
            raise RuntimeError("annotation failed to arm")

        def __exit__(self, *exc):
            return False

    scope = mt.profiler.Scope("failing_region")
    scope._ann = _BoomAnn()
    before = tt.span_count("failing_region")
    with pytest.raises(RuntimeError):
        scope.__enter__()
    assert tt.span_count("failing_region") == before + 1


def test_fit_profiler_merged_chrome_trace(tmp_path):
    fname = str(tmp_path / "fit.json")
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (128, 16)).astype(np.float32)
    Y = rs.randint(0, 4, 128).astype(np.float32)
    with mt.name.NameManager():
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
    mod = mt.mod.Module(net, context=CPU)
    metric = mt.metric.Accuracy()

    def fit():
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=32), eval_metric=metric,
                num_epoch=1, initializer=mt.initializer.Xavier(),
                optimizer="sgd", optimizer_params={"learning_rate": 0.05})

    fit()
    mt.profiler.set_config(filename=fname)
    mt.profiler.set_state("run")
    fit()
    metric.get()
    mt.profiler.set_state("stop")
    with open(fname) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "host"}
    assert {"feed", "step", "fit_batch", "io_next", "metric_fetch"} <= names
    assert any(e.get("ph") == "X" and e.get("cat") != "host"
               for e in events)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_monitor_taps_outputs(pkg):
    m, ctx = (mx, mx.cpu()) if pkg == "jax" else (mt, mt.cpu())
    mon = m.monitor.Monitor(interval=1, sort=True)
    data = m.sym.Variable("data")
    out = m.sym.exp(data, name="expout")
    exe = out.simple_bind(ctx=ctx, data=(2, 2))
    mon.install(exe)
    exe.arg_dict["data"][:] = 1.0
    mon.tic()
    exe.forward()
    rows = mon.toc()
    assert [name for _, name, _ in rows] == ["data", "expout_output"]
    assert float(rows[1][2]) == pytest.approx(np.e, rel=1e-6)
