"""The port's telemetry (``mxnet_tpu_torch/telemetry.py``) against the JAX
package's, and the port's counterparts of ``tests/test_telemetry.py`` and
``tests/test_program_cards.py``.

(a) Registry parity: both registries driven with the same calls
    (``record_span`` with fixed ``t0_ns``/``t1_ns``, ``counter_inc``,
    ``record_event``, ``causal``, ``record_program`` +
    ``program_dispatch``, ``set_peak_flops``) report equal
    ``counters()``, ``span_stats()``, ``events()`` (their wall-clock
    ``ts`` aside) and ``_online_stats()``, exactly; ``chrome_events()``
    is equal with both time anchors set to one instant and one pid;
    ``snapshot()`` has the same keys; ``disable()`` turns every call
    into a no-op in both.
(b) The registry's own behaviour, the executor's dispatch registry and
    ``Module.fit``'s telemetry, as in ``tests/test_telemetry.py``, with
    the overhead guard's 2% bound on ``Module.fit`` and on a Gluon
    ``record``/``backward`` step.
(c) Program cards and the buffer ledger, as in
    ``tests/test_program_cards.py``: one card per entry point and
    signature, ``flops`` equal to the analytic 2·MAC count of a small
    ResNet v1's Convolution and FullyConnected nodes (the JAX package's
    ``cost_analysis`` figure is printed beside it, not asserted), the
    first call's counting leaves the outputs unchanged.

JAX tests with no port counterpart yet, by ROADMAP item:
- Queue 1 item 4 (the distributed slice): ``test_train_step_card_on_dp_mesh``,
  ``test_ledger_shard_put``, ``test_snapshot_json_serializable_end_to_end``'s
  mesh (its one-device half is here), the ``shard_put`` span of
  ``test_fit_profiler_merged_chrome_trace`` (the rest is here).
- Queue 1 item 6: ``test_recompile_cause_warning_names_changed_shape`` and
  ``test_recompile_dtype_flip_named`` (the port compiles nothing: a new
  signature builds a new card, and there is no recompile diagnosis),
  ``test_storage_ledger_report`` (``storage.py``),
  ``test_oom_enriched_with_ledger_and_card``/``test_non_oom_errors_pass_through``
  (``DeviceMemoryError``), ``test_cards_degrade_when_analysis_unavailable``
  and ``test_dispatch_survives_aot_compile_failure`` (XLA's analyses and
  AOT compile have no counterpart), ``test_no_raw_jit_outside_instrumented_wrapper``
  (``tools/mxlint.py`` is not ported).
"""
import ast
import gc
import json
import logging
import os
import re
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jt

import mxnet_tpu_torch as mt
from torch_threads import one_torch_thread  # noqa: F401
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch import executor as _ex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _clean_registry():
    for t in (tt, jt):
        t.enable()
        t.reset()
        t.set_peak_flops(None)
    yield
    for t in (tt, jt):
        t.enable()
        t.reset()
        t.set_peak_flops(None)


# ---------------------------------------------------------------------------
# (a) registry parity
# ---------------------------------------------------------------------------

def _drive(t):
    """The same sequence of registry calls, with fixed span endpoints."""
    t0 = 10 ** 12
    t.counter_inc("serving.requests")
    t.counter_inc("serving.rows", 7)
    t.record_transfer(4096)
    t.record_transfer(128, direction="d2h")
    t.record_host_sync("asnumpy")
    t.record_fault("dispatch")
    t.record_fallback("env_pin")
    t.dispatch_event("serve")
    for i in range(9):
        t.record_span("serve_batch", t0 + i * 10 ** 6,
                      t0 + i * 10 ** 6 + (i + 1) * 137000,
                      ctx={"req_ids": [i, i + 1]})
    for i in range(5):
        t.record_span("feed", t0 + i * 3 * 10 ** 6 - 20000,
                      t0 + i * 3 * 10 ** 6 - 1000,
                      ctx={"epoch": 0, "nbatch": i})
        t.record_span("step", t0 + i * 3 * 10 ** 6,
                      t0 + i * 3 * 10 ** 6 + 2 * 10 ** 6,
                      ctx={"epoch": 0, "nbatch": i})
    t.record_span("serve_wait", t0, t0 + 5000, ctx={"req_id": 1})
    t.record_span("serve_request", t0, t0 + 9 * 10 ** 6,
                  ctx={"req_id": 1})
    with t.causal(req_id=3):
        assert t.current_causal() == {"req_id": 3}
        with t.causal(epoch=1, nbatch=2):
            assert t.current_causal() == {"epoch": 1, "nbatch": 2}
        t.record_event("serving.shed", req_id=3, cause="admission",
                       rows=2)
    t.record_event("fault.injected", site="d2h", action="nan", call=1)
    card = {"id": "forward@p1/s0", "kind": "forward", "flops": 2.5e9,
            "signature": [["args['data']", [4, 8], "float32", None]]}
    t.record_program(card)
    for _ in range(3):
        t.program_dispatch(card)
    other = {"id": "train_step@p2/s0", "kind": "train_step",
             "flops": 1e10}
    t.record_program(other)
    t.program_dispatch(other)
    t.card_annotate("forward@p1/s0", autotune_plan={"buckets": [4]})
    t.set_peak_flops(6.7e13)


def test_registries_agree_exactly():
    _drive(tt)
    _drive(jt)
    assert tt.counters() == jt.counters()
    assert tt.span_stats() == jt.span_stats()
    assert tt._online_stats() == jt._online_stats()
    assert tt.programs() == jt.programs()
    assert tt.dispatch_counts() == jt.dispatch_counts()
    for name in ("serve_batch", "step"):
        assert tt.span_count(name) == jt.span_count(name)
        assert tt.span_seconds(name) == jt.span_seconds(name)
        assert tt.span_durations(name) == jt.span_durations(name)

    def strip(evs):        # each registry stamps its own wall clock
        return [{k: v for k, v in e.items() if k != "ts"} for e in evs]
    assert strip(tt.events()) == strip(jt.events())
    assert len(tt.events()) == 2
    online = tt._online_stats()
    assert online["flops_dispatched"] == 3 * 2.5e9 + 1e10
    assert online["mfu"] == pytest.approx(
        online["flops_dispatched"] / 0.01 / 6.7e13, rel=1e-12)


def test_chrome_events_agree_on_one_anchor(monkeypatch):
    for t in (tt, jt):
        monkeypatch.setattr(t, "_ANCHOR_PERF_NS", 0)
        monkeypatch.setattr(t, "_ANCHOR_EPOCH_NS", 1_700_000_000 * 10 ** 9)
    _drive(tt)
    _drive(jt)
    got = tt.chrome_events(pid=1, since_trace_start=False)
    want = jt.chrome_events(pid=1, since_trace_start=False)
    assert got == want
    flows = [e for e in got if e.get("cat") == "flow"]
    # request 1 chains serve_wait -> serve_batch -> serve_request; each
    # step chains feed -> step
    ids = {e["id"] for e in flows}
    assert {"req:1", "step:0:0"} <= ids
    assert any(e["ph"] == "M" and e["args"].get("name") == "mxnet_tpu host"
               for e in got)


def test_snapshot_has_the_jax_keys():
    _drive(tt)
    _drive(jt)
    a, b = tt.snapshot(), jt.snapshot()
    assert set(a) == set(b)
    for k in ("online", "process"):
        assert set(a[k]) == set(b[k])
    json.dumps(a)


def test_disable_makes_every_call_a_no_op():
    for t in (tt, jt):
        t.disable()
        _drive(t)
        with t.span("off"):
            pass
        t.ledger_track(type("O", (), {})(), "cpu(0)", 64)
        t.enable()
        assert t.counters() == {}
        assert t.span_stats() == {}
        assert t.events() == []
        assert t.programs() == {}
        assert t._online_stats()["flops_dispatched"] == 0.0


def test_percentile_is_one_rule():
    """``base.latency_percentiles`` (serving and decode ``stats()``) calls
    the telemetry copy of the JAX package's ``_percentile``."""
    from mxnet_tpu_torch import base
    vals = sorted(np.random.RandomState(1).uniform(0, 10, 37).tolist())
    for q in (0, 10, 50, 95, 99, 100):
        assert tt._percentile(vals, q) == jt._percentile(vals, q)
    assert base._percentile is tt._percentile
    assert base.latency_percentiles(vals) == {
        "p%d_ms" % q: round(jt._percentile(vals, q), 4)
        for q in (50, 95, 99)}


def test_span_names_are_the_jax_packages():
    for name in ("FIT_PHASE_SPANS", "SERVE_SPANS", "DECODE_SPANS",
                 "COMPILE_SPANS", "COUNTERS", "SPAN_RING_SIZE",
                 "EVENT_RING_SIZE", "MAX_PROGRAM_CARDS"):
        assert getattr(tt, name) == getattr(jt, name), name


def test_port_counter_names_are_declared():
    """Every ``counter_inc`` literal in the port matches a declared
    pattern of ``telemetry.COUNTERS`` (an undeclared name is a typo that
    never aggregates)."""
    pats = [re.compile(re.escape(p[:-1]) + ".+" if p.endswith("*")
                       else re.escape(p) + "$") for p in tt.COUNTERS]
    found = []
    for d, _, files in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(
                        node.func, "attr", None) == "counter_inc" \
                        and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Constant):
                        name = a.value
                    elif isinstance(a, ast.BinOp) and isinstance(
                            a.left, ast.Constant):
                        name = a.left.value.replace("%s", "x")
                    else:
                        continue
                    found.append(name)
                    assert any(p.match(name) for p in pats), name
    assert len(found) > 40


# ---------------------------------------------------------------------------
# (b) the registry, the dispatch registry and Module.fit
# ---------------------------------------------------------------------------

def test_counters_and_reset():
    tt.counter_inc("a")
    tt.counter_inc("a", 4)
    tt.counter_inc("b")
    assert tt.counters() == {"a": 5, "b": 1}
    tt.reset()
    assert tt.counters() == {}


def test_span_records_histogram_and_percentiles():
    for _ in range(20):
        with tt.span("phase"):
            pass
    stats = tt.span_stats("phase")["phase"]
    assert stats["count"] == 20
    assert stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"] \
        <= stats["max_ms"]
    snap = tt.snapshot()
    assert "phase" in snap["spans"] and snap["enabled"] is True


def test_span_ring_is_bounded():
    for _ in range(tt.SPAN_RING_SIZE + 100):
        with tt.span("ring"):
            pass
    assert len(tt.chrome_events(since_trace_start=False)) \
        <= tt.SPAN_RING_SIZE + 16


def test_dispatch_multi_subscriber_and_legacy_shim():
    seen_a, seen_b, legacy = [], [], []
    cb_a = tt.on_dispatch(seen_a.append)
    cb_b = tt.on_dispatch(seen_b.append)
    old = _ex.dispatch_hook
    _ex.dispatch_hook = legacy.append
    try:
        _ex.record_dispatch("k1")
    finally:
        _ex.dispatch_hook = old
        tt.remove_dispatch(cb_a)
        tt.remove_dispatch(cb_b)
    assert seen_a == ["k1"] and seen_b == ["k1"] and legacy == ["k1"]
    assert tt.dispatch_counts() == {"k1": 1}
    _ex.record_dispatch("k2")
    assert seen_a == ["k1"]
    tt.remove_dispatch(cb_a)


def _mlp(m, hidden=32, classes=4):
    data = m.sym.Variable("data")
    net = m.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _iter(m, n_batches, batch=32, d=16, classes=4):
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (batch * n_batches, d)).astype(np.float32)
    Y = rs.randint(0, classes, batch * n_batches).astype(np.float32)
    return m.io.NDArrayIter(X, Y, batch_size=batch)


def _fit(m, mod, it, metric=None, **kwargs):
    mod.fit(it, eval_metric=metric or m.metric.Accuracy(), num_epoch=1,
            initializer=m.initializer.Xavier(), optimizer="sgd",
            optimizer_params={"learning_rate": 0.05}, **kwargs)


def test_module_fit_snapshot_fused():
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    _fit(mt, mod, _iter(mt, 6))
    tt.reset()
    _fit(mt, mod, _iter(mt, 6))
    snap = mod.telemetry_snapshot()
    assert snap["fused_fallback_code"] is None
    c = snap["counters"]
    assert c.get("dispatch.train_step") == 6
    assert "dispatch.fwd_bwd" not in c
    st = snap["spans"]["step"]
    assert st["count"] == 6
    assert st["p50_ms"] <= st["p95_ms"] <= st["p99_ms"]
    for name in ("fit_batch", "feed", "io_next"):
        assert name in snap["spans"], name
    json.dumps(snap)


def test_module_fit_fallback_counted_and_logged_once(caplog, monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.module"):
        _fit(mt, mod, _iter(mt, 5))
    snap = mod.telemetry_snapshot()
    assert snap["counters"].get("fused_fallback.env_pin") == 5
    assert snap["fused_fallback_code"] == "env_pin"
    msgs = [r.message for r in caplog.records
            if "fused-step fallback" in r.message]
    assert len(msgs) == 1 and "code=env_pin" in msgs[0]
    c = snap["counters"]
    assert c.get("dispatch.fwd_bwd") == 5
    assert c.get("dispatch.opt_update") == 5


def test_host_sync_and_transfer_counters():
    got = {}
    for m, t in ((mt, tt), (mx, jt)):
        a = m.nd.ones((8, 8), ctx=m.cpu())
        t.reset()
        a.asnumpy()
        a.wait_to_read()
        got[m] = t.counters()
    assert got[mt] == got[mx]
    assert got[mt]["host_sync.blocking"] == 2
    assert got[mt]["transfer.d2h_bytes"] == 8 * 8 * 4


def test_telemetry_logger_callback(caplog):
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.telemetry"):
        _fit(mt, mod, _iter(mt, 6),
             batch_end_callback=mt.callback.TelemetryLogger(frequent=2))
    lines = [r.message for r in caplog.records
             if "dispatches/batch" in r.message]
    assert lines, "TelemetryLogger logged nothing"
    assert "jit compile/hit" in lines[-1]
    assert "dispatches/batch=1.00" in lines[-1]


def _fit_spans_per_batch(m, t, n=4, env_pin=False, monkeypatch=None):
    if env_pin:
        monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    mod = m.mod.Module(_mlp(m), context=m.cpu())
    t.reset()
    _fit(m, mod, _iter(m, n), batch_end_callback=lambda p: None,
         epoch_end_callback=lambda *a: None)
    counts = {k: t.span_count(k) for k in t.FIT_PHASE_SPANS}
    steps = {}
    for s in t.recent_spans():
        ctx = s["ctx"] or {}
        if "nbatch" in ctx and s["name"] in t.FIT_PHASE_SPANS:
            steps.setdefault(ctx["nbatch"], []).append(s["name"])
    if env_pin:
        monkeypatch.delenv("MXNET_MODULE_FUSED_STEP")
    return counts, {k: sorted(v) for k, v in steps.items()}


@pytest.mark.parametrize("env_pin", [False, True])
def test_fit_phase_span_counts_match_jax(env_pin, monkeypatch):
    """The FIT_PHASE_SPANS counts, and the spans each (epoch, nbatch)
    causal id carries, equal the JAX package's on the same batches —
    fused and phase-split."""
    got = _fit_spans_per_batch(mt, tt, env_pin=env_pin,
                               monkeypatch=monkeypatch)
    want = _fit_spans_per_batch(mx, jt, env_pin=env_pin,
                                monkeypatch=monkeypatch)
    assert got == want
    counts, steps = got
    assert counts["fit_batch"] == 4 and sorted(steps) == [0, 1, 2, 3]
    assert counts["epoch_sync"] == 1 and counts["callbacks"] == 5


def test_fit_parameters_unchanged_by_telemetry():
    """Module.fit's parameters are bit-equal with telemetry on and off
    (the first call's counters do not touch the arithmetic)."""
    out = []
    for on in (True, False):
        (tt.enable if on else tt.disable)()
        mt.random.seed(3)
        mod = mt.mod.Module(_mlp(mt), context=CPU)
        _fit(mt, mod, _iter(mt, 3))
        out.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    tt.enable()
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k])


# ---------------------------------------------------------------------------
# The overhead guard (<2% of the batch-time floor)
# ---------------------------------------------------------------------------

def _op_cost(fn, iters=20000, reps=5):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / iters)
    return best / 1e9


def _measured_overhead(batch_s, nbatch):
    """Telemetry work per batch from the registry's own exact op counts
    over the last epoch (spans, counter ops, events, ledger tracks, card
    bumps, sampler ticks), each priced at its microbenchmarked cost —
    the JAX package's ``test_telemetry_overhead_guard`` method."""
    from mxnet_tpu_torch import flight
    spans = sum(tt.span_count(n) for n in tt.span_stats()) / nbatch
    counts = tt.counters()
    counter_ops = sum(v for k, v in counts.items()
                      if k.endswith("_count") or k.startswith(
                          ("dispatch.", "host_sync.", "jit."))) / nbatch
    event_ops = len(tt.events()) / nbatch
    ledger_ops = sum(st.get("tracked_total", 0)
                     for st in tt.ledger().values()) / nbatch
    card_ops = sum(c.get("dispatches", 0)
                   for c in tt.programs().values()) / nbatch
    ticks = len(flight.series()) / nbatch

    class _Obj:
        pass

    def one_span():
        with tt.span("_guard_probe"):
            pass

    _card = {"id": "_guard_card"}
    with tt.causal(epoch=0, nbatch=0):
        span_s = _op_cost(one_span)
    counter_s = _op_cost(lambda: tt.counter_inc("_guard_probe"))
    event_s = _op_cost(lambda: tt.record_event("_guard_probe"))
    track_s = _op_cost(lambda: tt.ledger_track(
        _Obj(), "cpu(0)", 128, shape=(32,), dtype="float32"), iters=5000)
    card_s = _op_cost(lambda: tt.program_dispatch(_card))
    tick_s = _op_cost(lambda: flight._build_sample({}, 0.02), iters=500)
    overhead_s = spans * span_s + counter_ops * counter_s \
        + event_ops * event_s + ledger_ops * track_s \
        + card_ops * card_s + ticks * tick_s
    tt.reset()
    frac = overhead_s / batch_s
    assert frac < 0.02, \
        "telemetry work %.1fus/batch (%.1f spans x %.2fus + %.1f counter " \
        "ops x %.2fus + %.1f events x %.2fus + %.1f ledger tracks x " \
        "%.2fus + %.1f card bumps x %.2fus + %.2f sampler ticks x " \
        "%.1fus) is %.2f%% of the %.0fus batch floor — exceeds the 2%% " \
        "guard" % (overhead_s * 1e6, spans, span_s * 1e6, counter_ops,
                   counter_s * 1e6, event_ops, event_s * 1e6,
                   ledger_ops, track_s * 1e6, card_ops, card_s * 1e6,
                   ticks, tick_s * 1e6, frac * 100, batch_s * 1e6)
    return frac


def _guarded(epoch, nbatch):
    from mxnet_tpu_torch import flight
    epoch()                              # warm
    batch_s = min(epoch() for _ in range(3)) / nbatch
    tt.reset()
    flight.series_clear()
    flight.sampler_start(20.0)
    try:
        epoch()
    finally:
        flight.sampler_stop()
    frac = _measured_overhead(batch_s, nbatch)
    flight.series_clear()
    return frac


def test_telemetry_overhead_guard_module_fit():
    batch, nbatch = 512, 12
    rs = np.random.RandomState(0)
    X = rs.uniform(-1, 1, (batch * nbatch, 64)).astype(np.float32)
    Y = rs.randint(0, 8, batch * nbatch).astype(np.float32)
    mod = mt.mod.Module(_mlp(mt, hidden=256, classes=8), context=CPU)
    metric = mt.metric.Accuracy()

    def epoch():
        it = mt.io.NDArrayIter(X, Y, batch_size=batch)
        t0 = time.perf_counter()
        _fit(mt, mod, it, metric)
        metric.get()
        return time.perf_counter() - t0

    _guarded(epoch, nbatch)


def test_telemetry_overhead_guard_gluon_record_backward():
    from mxnet_tpu_torch import autograd, gluon
    batch, nbatch = 512, 12
    rs = np.random.RandomState(0)
    X = mt.nd.array(rs.uniform(-1, 1, (batch, 64)).astype(np.float32),
                    ctx=CPU)
    Y = mt.nd.array(rs.randint(0, 8, batch).astype(np.float32), ctx=CPU)
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(256, activation="relu"))
        net.add(gluon.nn.Dense(8))
    net.initialize(mt.init.Xavier(), ctx=CPU)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05})

    def epoch():
        t0 = time.perf_counter()
        for _ in range(nbatch):
            with autograd.record():
                loss = loss_fn(net(X), Y)
            loss.backward()
            trainer.step(batch)
        loss.asnumpy()
        return time.perf_counter() - t0

    _guarded(epoch, nbatch)


# ---------------------------------------------------------------------------
# (c) program cards and the buffer ledger
# ---------------------------------------------------------------------------

def _cards(kind=None):
    return [c for c in tt.programs().values()
            if kind is None or c["kind"] == kind]


def test_cards_for_all_entry_points():
    ex = _mlp(mt).simple_bind(ctx=CPU, grad_req="write", data=(32, 16),
                              softmax_label=(32,))
    ex.forward(is_train=False)
    ex.forward_backward()
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    _fit(mt, mod, _iter(mt, 4))
    for kind in ("forward", "fwd_bwd", "train_step"):
        card = _cards(kind)[0]
        assert card["flops"] and card["flops"] > 0, card
        assert card["argument_bytes"] > 0 and card["output_bytes"] > 0
        assert card["trace_ms"] is None and card["compile_ms"] is None
        assert card["peak_bytes"] is None           # no CUDA allocator
        assert card["dispatches"] >= 1
        assert set(card) >= {
            "id", "kind", "signature", "donated", "dispatches", "flops",
            "bytes_accessed", "transcendentals", "peak_bytes",
            "argument_bytes", "output_bytes", "alias_bytes", "temp_bytes",
            "generated_code_bytes", "trace_ms", "compile_ms", "source"}
        paths = [e[0] for e in card["signature"]]
        assert any("data" in p for p in paths), paths
    assert _cards("train_step")[0]["dispatches"] == 4
    # 2 * (32x16x32 + 32x32x4) multiply-adds forward; fwd_bwd adds the
    # backward's matmuls
    assert _cards("forward")[0]["flops"] == 2 * (32 * 16 * 32 + 32 * 32 * 4)


def test_cache_reuse_keeps_one_card():
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    _fit(mt, mod, _iter(mt, 3))
    n_cards = len(_cards("train_step"))
    _fit(mt, mod, _iter(mt, 3))
    assert len(_cards("train_step")) == n_cards == 1
    assert _cards("train_step")[0]["dispatches"] == 6


def test_build_counts_no_dispatch_and_first_call_is_unchanged():
    """``build`` makes the card without a dispatch; the counted first
    call returns exactly what an uncounted call returns."""
    sym = _mlp(mt)
    ex = sym.simple_bind(ctx=CPU, data=(4, 16), softmax_label=(4,))
    for n, a in ex.arg_dict.items():
        a[:] = np.random.RandomState(len(n)).normal(
            size=a.shape).astype(np.float32)
    prog = _ex._GraphProgram(sym)
    args, aux = ex._raw_args(), ex._raw_aux()
    tt.disable()
    plain, _ = prog.forward_fn()(args, aux)
    tt.enable()
    built, _ = prog.forward_fn().build(args, aux)
    assert _cards("forward")[0]["dispatches"] == 0
    counted, _ = prog.forward_fn()(args, aux)
    assert len(_cards("forward")) == 1
    assert _cards("forward")[0]["dispatches"] == 1
    for a, b, c in zip(plain, built, counted):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_card_flops_equal_the_analytic_count_on_resnet():
    """A small ResNet v1 (NHWC, fused tails): the forward card's flops
    equal the analytic 2*MAC count of its Convolution and FullyConnected
    nodes exactly (``chip_smoke._conv_fc_flops``, which the card run
    holds the full-width cards to; K1 launches through ctypes and counts
    0). The JAX
    package's XLA ``cost_analysis`` counts elementwise work too; it is
    printed beside it, not asserted."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    shapes = {"data": (4, 32, 32, 3)}
    syms = {}
    os.environ["MXNET_FUSED_BN_ADD_RELU"] = "1"
    try:
        for m, res in ((mt, tres), (mx, jres)):
            m.layout.set_default_layout("NHWC")
            try:
                with m.name.NameManager():
                    net = res.ResNetV1(res.BottleneckV1, [1, 1, 1, 1],
                                       [16, 32, 64, 128, 256], classes=10)
                syms[m] = net(m.sym.Variable("data"))
            finally:
                m.layout.set_default_layout(None)
    finally:
        os.environ.pop("MXNET_FUSED_BN_ADD_RELU", None)
    from test_torch_kvstore import chip_smoke
    want = chip_smoke._conv_fc_flops(syms[mt], shapes)
    assert want == chip_smoke._conv_fc_flops(syms[mx], shapes)
    mt.layout.set_default_layout("NHWC")
    try:
        ex = syms[mt].simple_bind(ctx=CPU, **shapes)
        ex.forward(is_train=False)
    finally:
        mt.layout.set_default_layout(None)
    card = _cards("forward")[0]
    assert card["flops"] == want
    mx.layout.set_default_layout("NHWC")
    try:
        jex = syms[mx].simple_bind(ctx=mx.cpu(), **shapes)
        jex.forward(is_train=False)
    finally:
        mx.layout.set_default_layout(None)
    jflops = [c["flops"] for c in jt.programs().values()
              if c["kind"] == "forward"]
    print("small ResNet v1 forward FLOPs: port card %d (analytic 2*MAC), "
          "JAX cost_analysis %s" % (card["flops"], jflops))


def test_graph_fingerprint_matches_jax():
    for layout in (None, "NHWC"):
        mt.layout.set_default_layout(layout)
        mx.layout.set_default_layout(layout)
        try:
            with mt.name.NameManager():
                a = _ex._GraphProgram(_mlp(mt)).graph_fingerprint()
            with mx.name.NameManager():
                b = mx.executor._GraphProgram(_mlp(mx)).graph_fingerprint()
        finally:
            mt.layout.set_default_layout(None)
            mx.layout.set_default_layout(None)
        assert a == b and a[1] == layout


def _ledger_stats(key):
    return tt.ledger().get(key) or {
        "alive_bytes": 0, "alive_count": 0, "peak_bytes": 0,
        "tracked_total": 0, "tracked_bytes_total": 0}


def test_ledger_ndarray_lifecycle():
    key = str(CPU)
    gc.collect()
    base = _ledger_stats(key)
    a = mt.nd.zeros((64, 64), ctx=CPU)
    after_a = _ledger_stats(key)
    assert after_a["alive_bytes"] - base["alive_bytes"] == 64 * 64 * 4
    assert after_a["alive_count"] - base["alive_count"] == 1
    assert after_a["peak_bytes"] >= after_a["alive_bytes"]
    b = mt.nd.ones((32,), ctx=CPU)
    peak = _ledger_stats(key)["peak_bytes"]
    del a
    gc.collect()
    after_del = _ledger_stats(key)
    assert after_del["alive_bytes"] - base["alive_bytes"] == 32 * 4
    assert after_del["peak_bytes"] == peak
    assert after_del["tracked_total"] - base["tracked_total"] == 2
    top = tt.ledger_top(64)
    assert any(t["shape"] == [32] and t["ctx"] == key for t in top)
    del b
    gc.collect()
    assert _ledger_stats(key)["alive_bytes"] == base["alive_bytes"]


def test_ledger_disabled_is_silent_and_consistent():
    key = str(CPU)
    a = mt.nd.zeros((16, 16), ctx=CPU)
    base = tt.ledger()[key]["alive_bytes"]
    tt.disable()
    b = mt.nd.zeros((128, 128), ctx=CPU)
    assert tt.ledger()[key]["alive_bytes"] == base
    del a
    gc.collect()
    tt.enable()
    assert tt.ledger()[key]["alive_bytes"] == base - 16 * 16 * 4
    del b


def test_ledger_release_is_lock_free():
    key = str(CPU)
    a = mt.nd.zeros((16,), ctx=CPU)
    base = tt.ledger()[key]["alive_bytes"]
    with tt._lock:
        del a
        gc.collect()
    assert tt.ledger()[key]["alive_bytes"] == base - 16 * 4


def test_online_mfu_estimate():
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    _fit(mt, mod, _iter(mt, 5))
    online = tt.snapshot()["online"]
    assert online["flops_dispatched"] > 0
    assert online["step_time_s"] > 0
    assert online["model_flops_per_s"] > 0
    assert online["mfu"] is None
    tt.set_peak_flops(1e12)
    online = tt.snapshot()["online"]
    assert online["peak_flops"] == 1e12
    expected = online["flops_dispatched"] / online["step_time_s"] / 1e12
    assert online["mfu"] == pytest.approx(expected, rel=1e-3)


def test_snapshot_json_serializable_end_to_end():
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    _fit(mt, mod, _iter(mt, 3))
    parsed = json.loads(json.dumps(mod.telemetry_snapshot()))
    assert parsed["programs"] and parsed["online"]["flops_dispatched"] > 0
    assert parsed["ledger"][str(CPU)]["alive_bytes"] > 0


def test_telemetry_logger_programs_mode(caplog):
    mod = mt.mod.Module(_mlp(mt), context=CPU)
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.telemetry"):
        _fit(mt, mod, _iter(mt, 4),
             batch_end_callback=mt.callback.TelemetryLogger(
                 frequent=2, programs=True))
    lines = [r.message for r in caplog.records if "program card" in r.message]
    assert any("train_step" in ln and "flops=" in ln for ln in lines)
    assert len(lines) == len(set(lines))
