"""The port's flight recorder (``mxnet_tpu_torch/flight.py``) against the
JAX package's, and the port's counterparts of ``tests/test_flight.py``:
causal ids on spans and chrome flow events, the event ring, the metrics
sampler and its series, the OpenMetrics endpoint (its text equal to the
JAX package's for the same counters, ledger and engine states), crash
postmortems (the JAX dump's keys at every level, read by
``tools/flight_view.py``), the excepthooks installed and removed
cleanly, ``Module.fit``'s step ids, and the divergence sentinel's
postmortem.

The hooks are process-global in both packages: every test that arms
the port's leaves through ``flight.uninstall()`` in the fixture; the
JAX package's recorder is only written through ``postmortem(path=)``,
which arms nothing.
"""
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import flight as jflight, telemetry as jtelemetry
from mxnet_tpu.faults import InjectedFault as JInjectedFault

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import flight, telemetry
from mxnet_tpu_torch.faults import InjectedFault

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import flight_view  # noqa: E402  (stdlib-only CLI module)

CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _clean_registry():
    hooks = (sys.excepthook, threading.excepthook)
    for t in (telemetry, jtelemetry):
        t.enable()
        t.reset()
    flight.sampler_stop()
    flight.series_clear()
    flight.configure(None)
    yield
    flight.sampler_stop()
    flight.metrics_http_stop()
    flight.series_clear()
    flight.configure(None)
    flight.uninstall()
    for t in (telemetry, jtelemetry):
        t.enable()
        t.reset()
    assert (sys.excepthook, threading.excepthook) == hooks


# ---------------------------------------------------------------------------
# Causal ids and flows
# ---------------------------------------------------------------------------

def test_causal_scope_stamps_spans_and_nests():
    with telemetry.causal(epoch=1, nbatch=7):
        with telemetry.span("feed"):
            pass
        assert telemetry.current_causal() == {"epoch": 1, "nbatch": 7}
        with telemetry.causal(req_id=3):
            with telemetry.span("inner"):
                pass
    assert telemetry.current_causal() is None
    with telemetry.span("outside"):
        pass
    by_name = {s["name"]: s for s in telemetry.recent_spans()}
    assert by_name["feed"]["ctx"] == {"epoch": 1, "nbatch": 7}
    assert by_name["inner"]["ctx"] == {"req_id": 3}
    assert by_name["outside"]["ctx"] is None


def test_span_explicit_ctx_survives_cross_thread_exit():
    sp = telemetry.span("serve_wait", ctx={"req_id": 42}).__enter__()

    def _closer():
        with telemetry.causal(epoch=9, nbatch=9):
            sp.__exit__(None, None, None)

    t = threading.Thread(target=_closer)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rec = [s for s in telemetry.recent_spans() if s["name"] == "serve_wait"]
    assert rec and rec[-1]["ctx"] == {"req_id": 42}


def test_chrome_flow_events_link_shared_ids():
    with telemetry.causal(epoch=0, nbatch=2):
        with telemetry.span("feed"):
            pass
        with telemetry.span("step"):
            pass
    with telemetry.span("serve_batch", ctx={"req_ids": [5, 6]}):
        pass
    with telemetry.span("serve_request", ctx={"req_id": 5}):
        pass
    evs = telemetry.chrome_events(since_trace_start=False)
    step_flow = [e for e in evs if e.get("cat") == "flow"
                 and e["id"] == "step:0:2"]
    assert [e["ph"] for e in step_flow] == ["s", "f"]
    assert step_flow[-1]["bp"] == "e"
    req_flow = [e for e in evs if e.get("cat") == "flow"
                and e["id"] == "req:5"]
    assert [e["ph"] for e in req_flow] == ["s", "f"]
    assert not [e for e in evs if e.get("cat") == "flow"
                and e["id"] == "req:6"]
    feed = [e for e in evs if e.get("ph") == "X" and e["name"] == "feed"]
    assert feed[0]["args"] == {"epoch": 0, "nbatch": 2}


def test_request_flow_chains_in_pipeline_order():
    req_sp = telemetry.span("serve_request", ctx={"req_id": 9}).__enter__()
    with telemetry.span("serve_wait", ctx={"req_id": 9}):
        time.sleep(0.001)
    with telemetry.span("serve_batch", ctx={"req_ids": [9]}):
        time.sleep(0.001)
    with telemetry.span("serve_d2h", ctx={"req_ids": [9]}):
        time.sleep(0.001)
    time.sleep(0.001)
    req_sp.__exit__(None, None, None)
    evs = telemetry.chrome_events(since_trace_start=False)
    flow = [e for e in evs if e.get("cat") == "flow" and e["id"] == "req:9"]
    assert [e["ph"] for e in flow] == ["s", "t", "t", "f"]
    slices = {e["name"]: e for e in evs if e.get("ph") == "X"}
    assert flow[0]["ts"] == slices["serve_wait"]["ts"]
    assert flow[1]["ts"] == slices["serve_batch"]["ts"]
    assert flow[2]["ts"] == slices["serve_d2h"]["ts"]
    req = slices["serve_request"]
    assert flow[3]["bp"] == "e"
    assert req["ts"] <= flow[3]["ts"] <= req["ts"] + req["dur"]
    assert flow[3]["ts"] > slices["serve_d2h"]["ts"]


def test_event_ring_records_bounded_and_resets():
    telemetry.record_event("serving.shed", req_id=1, cause="admission")
    evs = telemetry.events()
    assert evs[-1]["kind"] == "serving.shed"
    assert evs[-1]["data"] == {"req_id": 1, "cause": "admission"}
    for i in range(telemetry.EVENT_RING_SIZE + 10):
        telemetry.record_event("tick", i=i)
    assert len(telemetry.events()) == telemetry.EVENT_RING_SIZE
    assert telemetry.events(n=3)[-1]["data"] == {
        "i": telemetry.EVENT_RING_SIZE + 9}
    telemetry.reset()
    assert telemetry.events() == []
    telemetry.disable()
    telemetry.record_event("off")
    telemetry.enable()
    assert telemetry.events() == []


# ---------------------------------------------------------------------------
# Metrics sampler + series ring
# ---------------------------------------------------------------------------

def test_sampler_banks_counter_deltas_and_gauges():
    flight.sampler_start(10)
    assert flight.sampler_running()
    assert flight.sampler_interval_ms() == pytest.approx(10.0)
    time.sleep(0.05)
    telemetry.counter_inc("serving.requests", 4)
    telemetry.counter_inc("serving.resolved", 1)
    time.sleep(0.08)
    flight.sampler_stop()
    assert not flight.sampler_running()
    samples = flight.series()
    assert samples, "sampler banked nothing"
    for s in samples:
        assert {"ts", "dt_ms", "counters", "queue_depth",
                "ledger_bytes", "serving"} <= set(s)
    assert sum(s["counters"].get("serving.requests", 0)
               for s in samples) == 4
    assert samples[-1]["queue_depth"] == 3
    flight.sampler_start(10)
    time.sleep(0.03)
    telemetry.reset()
    time.sleep(0.05)
    flight.sampler_stop()
    flagged = [s for s in flight.series() if s.get("registry_reset")]
    assert flagged and flagged[-1]["counters"] == {}


def test_sample_has_the_jax_keys():
    a, _ = flight._build_sample({}, 0.01)
    b, _ = jflight._build_sample({}, 0.01)
    assert set(a) == set(b)
    assert set(a["serving"]) == set(b["serving"])


def test_sampler_interval_zero_means_disabled():
    assert flight.sampler_start(0) is None
    assert not flight.sampler_running()
    assert flight.sampler_start(-5) is None
    assert not flight.sampler_running()


def test_series_window_and_jsonl_dump(tmp_path):
    flight.sampler_start(10)
    time.sleep(0.06)
    flight.sampler_stop()
    win = flight.series_window(3)
    assert win["n"] == len(win["samples"]) <= 3
    out = str(tmp_path / "series.jsonl")
    text = flight.series_dump(out)
    assert [json.loads(ln) for ln in text.splitlines()] == flight.series()
    with open(out) as f:
        assert f.read() == text
    flight.series_clear()
    assert flight.series() == []


# ---------------------------------------------------------------------------
# OpenMetrics
# ---------------------------------------------------------------------------

class _Engine:
    """A stand-in engine: the recorder reads only ``overload_state``."""

    def __init__(self, state):
        self.state = state

    def overload_state(self):
        return dict(self.state)


def test_openmetrics_text_equals_the_jax_packages(monkeypatch):
    class _Buf:
        pass

    holders = [_Buf() for _ in range(4)]
    engines = [_Engine({"queued_rows": 3, "breaker_open": False}),
               _Engine({"queued_rows": 2, "breaker_open": True,
                        "active_slots": 5})]
    for i, (t, f) in enumerate(((telemetry, flight),
                                (jtelemetry, jflight))):
        monkeypatch.setattr(t, "_ledger", {})
        monkeypatch.setattr(t, "_ledger_live", {})
        monkeypatch.setattr(f, "_engines", weakref.WeakSet())
        for e in engines:
            f.register_engine(e)
        t.counter_inc("serving.requests", 7)
        t.counter_inc("serving.resolved", 5)
        t.counter_inc("dispatch.serve", 3)
        t.counter_inc("faults.injected.d2h")
        t.ledger_track(holders[2 * i], "gpu(0)", 4096)
        t.ledger_track(holders[2 * i + 1], "cpu(0)", 64)
        card = {"id": "forward@p1/s0", "flops": 1e9}
        t.record_program(card)
        t.program_dispatch(card)
        t.record_span("step", 0, 10 ** 7)
        t.set_peak_flops(1e12)
    try:
        got, want = flight.openmetrics_text(), jflight.openmetrics_text()
        assert got == want
        assert got.count("# TYPE mxnet_tpu_ledger_alive_bytes gauge") == 1
        assert "mxnet_tpu_serving_breaker_open{" in got
        assert got.rstrip().endswith("# EOF")
    finally:
        for t in (telemetry, jtelemetry):
            t.set_peak_flops(None)


def test_openmetrics_endpoint_loopback_scrape():
    telemetry.counter_inc("serving.requests", 7)

    class _Buf:
        pass

    holders = [_Buf(), _Buf()]
    telemetry.ledger_track(holders[0], "ledgertest(0)", 64)
    telemetry.ledger_track(holders[1], "ledgertest(1)", 128)
    port = flight.metrics_http_start(0, host="127.0.0.1")
    try:
        text = urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics" % port, timeout=10).read().decode()
        ident = telemetry.process_identity()
        who = 'host="%s",rank="%d"' % (ident["host"], ident["rank"])
        assert "# TYPE mxnet_tpu_serving_requests counter" in text
        assert "mxnet_tpu_serving_requests_total{%s} 7" % who in text
        assert text.count("# TYPE mxnet_tpu_ledger_alive_bytes gauge") == 1
        assert ('mxnet_tpu_ledger_alive_bytes{ctx="ledgertest(1)",%s}'
                ' 128' % who) in text
        assert text.rstrip().endswith("# EOF")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen("http://127.0.0.1:%d/secrets" % port,
                                   timeout=10)
        assert flight.metrics_http_start(0) == port
    finally:
        flight.metrics_http_stop()


# ---------------------------------------------------------------------------
# Postmortems
# ---------------------------------------------------------------------------

def _trajectory(t):
    """One request's serving trajectory with fixed endpoints (ms from
    now): waiting 0-2, in its batch 2-3, fetched 3-3.5, resolved at 10."""
    t0 = time.perf_counter_ns()
    ms = 1000000
    t.record_span("serve_wait", t0, t0 + 2 * ms, ctx={"req_id": 11})
    t.record_span("serve_batch", t0 + 2 * ms, t0 + 3 * ms,
                  ctx={"req_ids": [11]})
    t.record_span("serve_d2h", t0 + 3 * ms, t0 + 3 * ms + ms // 2,
                  ctx={"req_ids": [11]})
    t.record_span("serve_request", t0, t0 + 10 * ms, ctx={"req_id": 11})
    t.record_event("serving.batch", req_ids=[11], bucket=8, rows=1,
                   pad_rows=7)
    t.record_program({"id": "forward@p1/s0", "kind": "forward",
                      "flops": 1e9})
    holder = _Holder()
    t.ledger_track(holder, "cpu(0)", 64, shape=(16,), dtype="float32")
    return holder


class _Holder:
    pass


def _schema(rec):
    """The key structure of a postmortem: its top-level keys, the keys of
    each fixed-schema block, of each element of its rings, and of one
    context's ledger entry (the ledger, counter and card maps are keyed
    by data, not by schema)."""
    out = {"top": sorted(rec)}
    for k in ("process", "exception", "online", "faults", "extra"):
        out[k] = sorted(rec[k]) if isinstance(rec[k], dict) else rec[k]
    for k in ("spans", "events", "ledger_top"):
        out[k] = sorted({kk for e in rec[k] for kk in e})
    # the entries this test put there (other tests' live buffers and
    # cards may share the process-global registries)
    out["ledger"] = sorted(rec["ledger"]["cpu(0)"])
    out["programs"] = sorted(rec["programs"]["forward@p1/s0"])
    return out


def test_postmortem_has_the_jax_keys_and_flight_view_reads_it(tmp_path):
    paths = {}
    for t, f, exc in ((telemetry, flight, InjectedFault("dispatch")),
                      (jtelemetry, jflight, JInjectedFault("dispatch"))):
        holder = _trajectory(t)
        paths[f] = f.postmortem("unit_test", exc=exc,
                                extra={"req_ids": [11]},
                                path=str(tmp_path / ("%s.json" % f.__name__)))
        del holder
    got = flight_view.load_dump(paths[flight])
    want = flight_view.load_dump(paths[jflight])
    assert got["schema"] == want["schema"] == "mxnet_tpu.flight/1"
    assert _schema(got) == _schema(want)
    assert got["exception"]["fault_site"] == "dispatch"
    assert got["extra"] == {"req_ids": [11]}
    summary = flight_view.summarize(got)
    slow = summary["slowest_requests"]
    assert slow and slow[0]["req_id"] == 11
    assert slow[0]["total_ms"] >= slow[0]["wait_ms"] > 0
    assert slow[0]["pad_rows"] == 7 and slow[0]["bucket"] == 8
    assert set(summary) == set(flight_view.summarize(want))


def test_postmortem_into_the_flight_dir(tmp_path):
    flight.configure(str(tmp_path))
    assert flight.installed()
    _trajectory(telemetry)
    path = flight.postmortem("unit_test", exc=InjectedFault("d2h"))
    assert path is not None and os.path.exists(path)
    assert os.path.dirname(path) == str(tmp_path)
    assert flight.last_postmortem() == path
    assert telemetry.counters().get("flight.postmortem") == 1
    assert flight_view.load_dump(path)["exception"]["fault_site"] == "d2h"


def test_postmortem_disabled_and_throttled(tmp_path):
    assert flight.postmortem("nothing") is None
    flight.configure(str(tmp_path))
    p1 = flight.postmortem("flap")
    p2 = flight.postmortem("flap")
    p3 = flight.postmortem("flap", force=True)
    assert p1 is not None and p2 is None and p3 is not None
    assert p1 != p3


def test_failed_write_does_not_burn_throttle_slot(tmp_path, monkeypatch):
    flight.configure(str(tmp_path))
    calls = {"n": 0}
    real = flight.atomic_write

    def flaky(path, data):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full")
        return real(path, data)

    monkeypatch.setattr(flight, "atomic_write", flaky)
    assert flight.postmortem("glitch") is None
    assert telemetry.counters().get("flight.postmortem_fail") == 1
    p = flight.postmortem("glitch")
    assert p is not None and os.path.exists(p)


def test_gather_peer_postmortems(tmp_path):
    flight.configure(str(tmp_path))
    with open(os.path.join(str(tmp_path), "postmortem-r3-1-001-x.json"),
              "w") as f:
        json.dump({"reason": "dead", "ts": 1.0, "events": [{"k": 1}],
                   "exception": {"type": "E", "message": "m"}}, f)
    with open(os.path.join(str(tmp_path), "postmortem-r4-1-001-y.json"),
              "w") as f:
        f.write("{truncated")
    got = flight.gather_peer_postmortems()
    assert [g["rank"] for g in got] == [3]
    assert got[0]["reason"] == "dead" and got[0]["events_tail"] == [{"k": 1}]


def test_excepthooks_install_and_uninstall_cleanly(tmp_path):
    before = (sys.excepthook, threading.excepthook)
    flight.configure(str(tmp_path))
    assert flight.installed()
    assert sys.excepthook is flight._excepthook
    assert threading.excepthook is flight._threading_hook
    flight.install()                          # idempotent
    flight.uninstall()
    assert not flight.installed()
    assert (sys.excepthook, threading.excepthook) == before
    flight.uninstall()                        # idempotent


def test_thread_excepthook_writes_postmortem(tmp_path):
    flight.configure(str(tmp_path))

    def _boom():
        raise RuntimeError("coalescer down")

    t = threading.Thread(target=_boom, name="doomed")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    dumps = [f for f in os.listdir(str(tmp_path))
             if "uncaught_thread_exception" in f]
    assert dumps, os.listdir(str(tmp_path))
    rec = flight_view.load_dump(os.path.join(str(tmp_path), dumps[0]))
    assert rec["exception"]["type"] == "RuntimeError"
    assert rec["extra"]["thread"] == "doomed"


def test_env_autostart_is_guarded():
    """Malformed or zero MXNET_METRICS_* values never break
    ``import mxnet_tpu_torch``: the recorder stays off."""
    for val in ("abc", "0"):
        env = dict(os.environ, MXNET_METRICS_INTERVAL_MS=val,
                   MXNET_METRICS_PORT=val, PYTHONPATH=ROOT)
        proc = subprocess.run(
            [sys.executable, "-c",
             "from mxnet_tpu_torch import flight; "
             "assert not flight.sampler_running(); "
             "assert flight._http_server is None; print('OK')"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            timeout=300, env=env, cwd=ROOT)
        assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_divergence_halt_triggers_postmortem(tmp_path):
    from mxnet_tpu_torch.checkpoint import DivergenceError
    from mxnet_tpu_torch.module.base_module import BaseModule
    flight.configure(str(tmp_path))
    with pytest.raises(DivergenceError):
        BaseModule()._handle_divergence("halt", None, 3, 14)
    dumps = [f for f in os.listdir(str(tmp_path)) if "divergence" in f]
    assert dumps
    rec = flight_view.load_dump(os.path.join(str(tmp_path), dumps[0]))
    assert rec["extra"] == {"epoch": 3, "nbatch": 14, "policy": "halt"}
    # the sentinel event landed in the ring too
    assert any(e["kind"] == "divergence.detected" for e in rec["events"])


def test_flight_view_cli_renders_and_rejects_garbage(tmp_path):
    flight.configure(str(tmp_path))
    telemetry.record_event("serving.shed", req_id=1, cause="coalesce")
    path = flight.postmortem("cli_test", exc=ValueError("x"))
    view = os.path.join(ROOT, "tools", "flight_view.py")
    proc = subprocess.run([sys.executable, view, path],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "flight postmortem: cli_test" in proc.stdout
    assert "serving.shed" in proc.stdout
    wrong = str(tmp_path / "wrong.json")
    with open(wrong, "w") as f:
        json.dump({"schema": "other/1"}, f)
    with pytest.raises(flight_view.MalformedDump):
        flight_view.load_dump(wrong)


def test_telemetry_logger_log_series(caplog):
    logger = mt.callback.TelemetryLogger(frequent=1)
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.telemetry"):
        logger.log_series()
        flight.sampler_start(10)
        telemetry.counter_inc("serving.requests", 20)
        telemetry.counter_inc("serving.shed_requests", 5)
        telemetry.counter_inc("dispatch.serve", 2)
        time.sleep(0.08)
        flight.sampler_stop()
        logger.log_series()
        logger.log_series()
    lines = [r.message for r in caplog.records
             if r.message.startswith("series:")]
    assert len(lines) == 1, lines
    assert "req/s=" in lines[0] and "dispatch/s=" in lines[0]


def test_fit_stamps_step_ids_and_flows():
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (32 * 3, 8)).astype(np.float32)
    Y = rs.randint(0, 4, 32 * 3).astype(np.float32)
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.FullyConnected(net, num_hidden=4, name="fc2")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(net, name="softmax"),
                        context=CPU)

    def fit():
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=32),
                eval_metric=mt.metric.Accuracy(), num_epoch=1,
                initializer=mt.initializer.Xavier(), optimizer="sgd",
                optimizer_params={"learning_rate": 0.05})

    fit()
    telemetry.reset()
    fit()
    spans = [s for s in telemetry.recent_spans()
             if s["ctx"] and s["ctx"].get("nbatch") == 1]
    assert {"fit_batch", "feed", "step"} <= {s["name"] for s in spans}
    flows = [e for e in telemetry.chrome_events(since_trace_start=False)
             if e.get("cat") == "flow" and e["id"] == "step:0:1"]
    phs = [e["ph"] for e in flows]
    assert phs[0] == "s" and phs[-1] == "f" and len(phs) >= 3
