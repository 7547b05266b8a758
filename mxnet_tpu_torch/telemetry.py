"""Unified runtime telemetry: counters, host-span tracing, dispatch taps.

A whole copy of ``mxnet_tpu/telemetry.py`` (stdlib only; the port
imports nothing of the JAX package). On the card, PyTorch launches
asynchronously: a span times the HOST side of the work it wraps (feed,
dispatch, blocking syncs), as the JAX package's spans time the host side
of an asynchronous XLA dispatch; device time comes from
``mx.profiler``. This module is the standing instrument every slice
reads from:

* a **counter registry** — program dispatches by kind
  (``executor.record_dispatch``), fused-step fallback events keyed by
  their stable ``FusedFallback.code``, host<->device transfer bytes,
  blocking host syncs, kvstore traffic, serving and decode counters;
* **host-side span tracing** — ``with telemetry.span("feed"): ...``
  records wall-time intervals into a bounded ring buffer with a
  per-name duration histogram and a p50/p95/p99 ``snapshot()`` API;
* a **multi-subscriber dispatch registry** — ``on_dispatch(cb)`` /
  ``remove_dispatch(cb)``; the single-slot ``executor.dispatch_hook``
  is a shim read by ``executor.record_dispatch``;
* **chrome-trace export** — ``chrome_events()`` renders the span ring
  as chrome://tracing ``X`` events; ``profiler.py`` merges them into
  the ``torch.profiler`` trace (CPU ops and CUDA kernels) so host and
  device timelines land in ONE perfetto-loadable JSON;
* a **program-card registry** — the executor deposits one card per
  entry point and abstract signature (``record_program``) with its
  FLOPs (``torch.utils.flop_counter``), argument/output bytes and the
  allocator's peak around the first call; ``program_dispatch`` bumps
  the card's dispatch count per launch, and ``snapshot()`` derives an
  ONLINE sustained-FLOP/s (and MFU, once ``set_peak_flops`` is told
  the card's ceiling) from card FLOPs x dispatches / step-span time.
  Cards are plain JSON-safe dicts built by executor.py (this module
  stays stdlib-only and never imports torch);
* a **live device-buffer ledger** — ``ledger_track(obj, ...)`` charges
  a buffer to its context until ``obj`` is garbage-collected
  (a weakref callback), maintaining per-context alive-bytes/alive-count/
  peak-bytes; ``ledger_top()`` lists the largest live buffers;
* **causal ids** — ``with telemetry.causal(req_id=7): ...`` stamps
  every span recorded on the thread (or a span built with an explicit
  ``ctx=``, for spans that cross threads) with the ids of the request
  or fit step it serves. ``serving.submit()`` stamps a ``req_id`` that
  rides the request through coalesce → batch dispatch → d2h → resolve
  (batch spans carry the member ``req_ids``), ``Module.fit`` stamps
  ``(epoch, nbatch)`` onto feed/step/opt spans, and ``chrome_events()``
  renders the shared ids as chrome-trace FLOW events (``ph: s/t/f``)
  so perfetto draws arrows linking one request's or step's spans
  across threads;
* an **event ring** — ``record_event(kind, **data)`` appends one
  discrete runtime event (a fault firing, a shed, a breaker trip) into
  a bounded ring; together with ``recent_spans()`` it is the last-N
  "what happened, when, to which request" record a crash postmortem
  (``flight.py``) dumps.

Everything here is cheap when disabled: ``MXNET_TELEMETRY=0`` (or
``disable()``) reduces every span to two attribute reads and every
counter to one branch. Counters and spans are process-global — the fit
loop, the kvstore and the io pipeline all feed one registry, which is
what makes the merged trace readable. The names (counters, spans, the
chrome track "mxnet_tpu host") are the JAX package's, so one reader
(``tools/flight_view.py``, a dashboard) reads both packages.
"""
from __future__ import annotations

import collections
import itertools
import os
import socket
import threading
import time
import weakref

__all__ = [
    "enabled", "enable", "disable", "reset",
    "counter_inc", "counters", "snapshot", "span", "record_span",
    "span_stats", "span_count", "span_durations", "span_seconds",
    "causal", "current_causal", "record_event", "events",
    "recent_spans", "serving_queue_depth", "process_identity",
    "on_dispatch", "remove_dispatch", "dispatch_event",
    "record_jit", "record_fallback", "record_fault", "record_transfer",
    "record_host_sync", "chrome_events", "mark_trace_start",
    "record_program", "program_dispatch", "programs", "card_update",
    "card_annotate",
    "set_peak_flops", "ledger_track", "ledger", "ledger_top",
    "SPAN_RING_SIZE", "EVENT_RING_SIZE", "FIT_PHASE_SPANS",
    "SERVE_SPANS", "DECODE_SPANS", "COMPILE_SPANS",
    "MAX_PROGRAM_CARDS", "COUNTERS",
]

# ring capacities: bound memory for arbitrarily long training runs. The
# span ring keeps the most recent intervals for chrome export; duration
# histograms keep more samples per name so percentiles stay meaningful
# after the ring has wrapped.
SPAN_RING_SIZE = 4096
_DURATIONS_PER_NAME = 4096

# event ring: the flight recorder's last-N discrete-event record
# (faults, sheds, breaker trips, checkpoint saves, preemptions) — what
# a crash postmortem dumps next to the span ring
EVENT_RING_SIZE = 2048

# the fit-loop phase span names — the ONE list artifact summaries
# filter on, kept next to the code that records them
FIT_PHASE_SPANS = ("fit_batch", "feed", "step", "shard_put",
                   "metric_update", "metric_fetch", "opt_update",
                   "io_next", "callbacks", "epoch_sync",
                   "kv_push", "kv_pull")

# the serving-path span names (mxnet_tpu/serving.py): request time in
# queue, program dispatch per coalesced batch, the blocking d2h fetch,
# and the whole submit->resolve request latency whose p50/p95/p99 the
# serving artifacts and TelemetryLogger report
SERVE_SPANS = ("serve_wait", "serve_batch", "serve_d2h", "serve_request")

# the decode-tier span names (mxnet_tpu/decode.py): one slot's prefill
# dispatch, one batched decode step advancing every active slot a
# token (its duration IS the per-token latency the decode artifacts
# report), and the retire-time host assembly that resolves a finished
# sequence. A decode request's flow chains serve_wait -> serve_prefill
# -> serve_decode_step x N -> serve_detokenize -> serve_request.
DECODE_SPANS = ("serve_prefill", "serve_decode_step", "serve_detokenize")

# the JAX package's program-build span names (tracing, an XLA compile,
# a disk-cache deserialize). The port compiles no programs (its kernels
# are built once by ``kernels/_build.py``), so nothing records these;
# the names stay so a reader of both packages filters one tuple
COMPILE_SPANS = ("jit_trace", "jit_compile", "jit_deserialize")

# program-card registry bound: recompile storms must not grow the
# registry without limit — the oldest card is dropped (its FLOPs x
# dispatches folded into the online total so MFU stays right)
MAX_PROGRAM_CARDS = 256

# the DECLARED counter-name registry (the JAX package's): every
# ``counter_inc`` literal in the runtime must match one of these
# patterns — an undeclared name at the call site is a typo that never
# aggregates (``tests/test_torch_telemetry.py`` checks the port's call
# sites against it). A
# trailing ``.*`` covers a dynamic tail: fallback codes, fault sites,
# reject causes, shed causes, dispatch/program kinds.
COUNTERS = (
    "flight.postmortem", "flight.postmortem_fail",
    "dispatch.*", "jit.*", "recompile.*",
    "fused_fallback.*",
    "partition.replicated_fallback",
    "faults.injected", "faults.injected.*",
    "transfer.*", "host_sync.*",
    "kvstore.push", "kvstore.pull", "kvstore.wire_bytes",
    "kvstore.dist.collectives", "kvstore.dist.wire_bytes",
    "kvstore.dist.wire_bytes_raw", "kvstore.dist.fused_steps",
    "elastic.dead_workers", "elastic.remesh", "elastic.resumed",
    "exec_group.forward",
    "training.preempted",
    "divergence.detected", "divergence.skipped", "divergence.rollback",
    "checkpoint.save", "checkpoint.resume",
    "compile_cache.hit", "compile_cache.miss",
    "compile_cache.store", "compile_cache.store_fail",
    "compile_cache.reject", "compile_cache.reject.*",
    "compile_cache.bytes_read", "compile_cache.bytes_written",
    "compile_cache.corpus_append",
    "serving.requests", "serving.rows", "serving.batches",
    "serving.batch_rows", "serving.pad_rows", "serving.pad_bytes",
    "serving.resolved", "serving.failed_requests",
    "serving.shed_requests", "serving.shed_rows", "serving.shed.*",
    "serving.deadline_exceeded", "serving.retries",
    "serving.dispatch_failures", "serving.breaker_trips",
    "serving.breaker_fastfail",
    "decode.requests", "decode.tokens", "decode.steps",
    "decode.slot_admit", "decode.slot_retire",
    "decode.shed", "decode.shed.*", "decode.deadline_exceeded",
    "decode.prefill_compiles", "decode.resolved",
    "decode.failed_requests", "decode.dispatch_failures",
    "decode.retries", "decode.breaker_trips", "decode.breaker_fastfail",
    # fleet observability (the distributed slice): per-channel
    # gate-wait attribution
    # and the structured straggler verdicts the gate emits
    "heartbeat.gate_wait_ms.*", "heartbeat.gate_crossings.*",
    "dist.straggler",
)


class _State:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = os.environ.get("MXNET_TELEMETRY", "1") not in (
            "0", "false")


_state = _State()
_lock = threading.Lock()
_counters = {}           # guarded by: _lock
# span ring: (name, start_ns, end_ns, thread_id, causal_ctx_or_None)
# in perf_counter_ns time. Appends are deliberately LOCK-FREE
# (GIL-atomic deque ops on the per-batch hot path); see the
# _record_span disables.
_spans = collections.deque(maxlen=SPAN_RING_SIZE)   # guarded by: _lock
# event ring: (perf_ns, kind, data_dict_or_None, thread_id). Appends
# are lock-free for the same hot-path reason (some events fire under
# OTHER locks — the serving admission path records sheds while holding
# the engine lock, and stacking _lock under it per event buys nothing).
_events = collections.deque(maxlen=EVENT_RING_SIZE)  # guarded by: _lock
# per-thread causal ids (req_id / epoch+nbatch) stamped onto spans
# recorded while a causal() scope is active on that thread
_tls = threading.local()
_durations = {}          # name -> deque of durations  # guarded by: _lock
_span_total = {}         # name -> cumulative count    # guarded by: _lock
_span_seconds = {}       # guarded by: _lock
                         # name -> cumulative span seconds (uncapped) —
                         # the online-MFU denominator must cover EVERY
                         # step, not just the histogram ring's tail
_dispatch_subs = []      # guarded by: _lock
_gen = 0                 # guarded by: _lock
                         # bumped by reset(): spans straddling a reset
                         # belong to the OLD window and must not leak
                         # into the freshly cleared registry

# program cards: card["id"] -> card dict (insertion-ordered). The card
# OBJECT is shared with the executor wrapper that built it — dispatch
# bumps mutate it in place, and a reset() simply drops the registry
# reference; the wrapper re-installs (with a fresh dispatch count) on
# the next launch, so a windowed reset reads clean.
_programs = {}                  # guarded by: _lock
_programs_dropped_flops = 0.0   # guarded by: _lock
_peak_flops = None              # guarded by: _lock

# live device-buffer ledger: per-context alive/peak counters plus the
# individual live-buffer map that backs ledger_top() / OOM enrichment
_ledger = {}        # guarded by: _lock
                    # ctx key -> {alive_bytes, alive_count, peak_bytes,
                    #             tracked_total, tracked_bytes_total}
_ledger_live = {}   # guarded by: _lock
                    # token -> (ctx_key, nbytes, shape, dtype, kind,
                    #           keyed_key_or_None)
_ledger_keyed = {}  # guarded by: _lock
                    # (id(obj), ctx_key, kind) -> token, for
                    # replace=True re-tracking (a re-committed
                    # parameter replaces its prior charge instead of
                    # double-counting)
_ledger_seq = itertools.count(1)
# released tokens land here LOCK-FREE and are drained under _lock by
# the next ledger operation. The release callback must NOT take
# _lock: cyclic-GC (autograd tapes make NDArray cycles) can run the
# callback synchronously on a thread that already HOLDS _lock (any
# allocation inside a locked section can trip the GC threshold), and
# the non-reentrant lock would deadlock the process mid-training.
_ledger_pending = collections.deque()   # guarded by: _lock
# token -> the weakref whose callback releases it (held until the charge
# retires: a collected weakref calls nothing)
_ledger_refs = {}   # guarded by: _lock

# perf_counter<->epoch anchor, taken once at import: spans are stamped
# in the monotonic perf_counter timebase (immune to clock steps); the
# chrome exporter maps them back to epoch microseconds through this
# anchor so they can align with the device trace
_ANCHOR_PERF_NS = time.perf_counter_ns()
_ANCHOR_EPOCH_NS = time.time_ns()

# perf_counter_ns stamp of the last profiler trace start (chrome export
# filters to spans inside the trace window)
_trace_start_ns = None


# ---------------------------------------------------------------------------
# Enable/disable
# ---------------------------------------------------------------------------

def enabled():
    """Whether spans and counters record (default on; MXNET_TELEMETRY=0
    starts disabled). Dispatch SUBSCRIBERS fire regardless — they were
    installed explicitly."""
    return _state.enabled


def enable():
    _state.enabled = True


def disable():
    _state.enabled = False


def reset():
    """Clear every counter, span, histogram and program card
    (subscribers stay). Spans currently OPEN on any thread are dropped
    at their exit — a pre-reset interval must not appear in the new
    accounting window. The buffer LEDGER's live map survives (the
    buffers are still alive and their callbacks will still fire);
    its cumulative totals zero and peak rebases to the current alive
    level, so a windowed reader sees this window's high-water mark."""
    global _gen, _programs_dropped_flops
    with _lock:
        _gen += 1
        _counters.clear()
        _spans.clear()
        _events.clear()
        _durations.clear()
        _span_total.clear()
        _span_seconds.clear()
        _programs.clear()
        _programs_dropped_flops = 0.0
        _ledger_drain_locked()
        for st in _ledger.values():
            st["peak_bytes"] = st["alive_bytes"]
            st["tracked_total"] = 0
            st["tracked_bytes_total"] = 0


# ---------------------------------------------------------------------------
# Counter registry
# ---------------------------------------------------------------------------

def counter_inc(name, n=1):
    """Add ``n`` to counter ``name`` (no-op while disabled)."""
    if not _state.enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters():
    """Snapshot copy of the counter registry."""
    with _lock:
        return dict(_counters)


def record_jit(kind, hit):
    """One program-cache lookup: ``hit=False`` is a program build,
    ``hit=True`` a cached-program reuse (the JAX package's jit cache; the
    port's executor builds no programs and never calls this)."""
    if not _state.enabled:
        return
    what = "hit" if hit else "compile"
    with _lock:
        _counters["jit.%s" % what] = _counters.get("jit.%s" % what, 0) + 1
        k = "jit.%s.%s" % (what, kind)
        _counters[k] = _counters.get(k, 0) + 1


def serving_queue_depth(counts, prefix="serving."):
    """Admitted-but-unterminated serving requests, from a counter
    mapping: requests − resolved − post-admission sheds − failed.
    Admission sheds never entered ``requests`` (they must not drive
    the depth negative); coalesce/resolve/breaker sheds and failed
    requests DID, and each terminated its future. THE one copy of the
    formula — ``InferenceEngine.stats()`` (over its engine-local stats,
    ``prefix=""``), ``TelemetryLogger.log_serving`` and the flight
    recorder's sampler all call this, so a new terminal cause is a
    one-place change."""
    def g(key):
        return counts.get(prefix + key, 0)
    return (g("requests") - g("resolved")
            - (g("shed_requests") - g("shed.admission"))
            - g("failed_requests"))


def record_fallback(code):
    """One fused-step fallback event, keyed by the stable
    ``FusedFallback.code`` (module/base_module.FUSED_FALLBACK_CODES)."""
    counter_inc("fused_fallback.%s" % code)


def record_fault(site):
    """One INJECTED fault fired at a named ``faults.py`` site — counted
    as ``faults.injected.<site>`` (total under ``faults.injected``) so
    the chaos lane's artifact carries exact fire counts next to the
    shed/retry/resume counters the injections caused."""
    counter_inc("faults.injected")
    counter_inc("faults.injected.%s" % site)


def record_transfer(nbytes, direction="h2d"):
    """Host<->device transfer accounting (bytes + event count)."""
    if not _state.enabled:
        return
    with _lock:
        _counters["transfer.%s_bytes" % direction] = \
            _counters.get("transfer.%s_bytes" % direction, 0) + int(nbytes)
        _counters["transfer.%s_count" % direction] = \
            _counters.get("transfer.%s_count" % direction, 0) + 1


def record_host_sync(what="host"):
    """One BLOCKING host synchronisation (asnumpy/wait_to_read/metric
    flush) — the stalls of an asynchronous pipeline."""
    if not _state.enabled:
        return
    with _lock:
        _counters["host_sync.blocking"] = \
            _counters.get("host_sync.blocking", 0) + 1
        k = "host_sync.%s" % what
        _counters[k] = _counters.get(k, 0) + 1


# ---------------------------------------------------------------------------
# Dispatch registry (multi-subscriber; replaces the single-slot hook)
# ---------------------------------------------------------------------------

def on_dispatch(cb):
    """Subscribe ``cb(kind)`` to every jitted-program dispatch
    (``executor.record_dispatch``). Unlike the legacy single-slot
    ``executor.dispatch_hook`` global, any number of subscribers coexist
    — the probe, tests and telemetry no longer clobber each other.
    Returns ``cb`` for symmetric ``remove_dispatch(cb)``."""
    with _lock:
        if cb not in _dispatch_subs:
            _dispatch_subs.append(cb)
    return cb


def remove_dispatch(cb):
    """Unsubscribe a callback; unknown callbacks are ignored."""
    with _lock:
        try:
            _dispatch_subs.remove(cb)
        except ValueError:
            pass


def dispatch_event(kind):
    """Fan one dispatch out to the counter registry and every
    subscriber. Called by ``executor.record_dispatch`` — the ONE
    dispatch-reporting entry point (tools/run_checks.sh lints that no
    other site grows a raw hook call)."""
    if _state.enabled:
        with _lock:
            k = "dispatch.%s" % kind
            _counters[k] = _counters.get(k, 0) + 1
    # deliberately lock-free: list() is one GIL-atomic snapshot, and
    # subscriber callbacks must NOT run under _lock (a callback that
    # reads counters() would deadlock)
    if _dispatch_subs:
        for cb in list(_dispatch_subs):
            cb(kind)


def dispatch_counts():
    """{kind: count} view of the dispatch counters (the probe's
    per-batch dispatch accounting reads this instead of installing its
    own hook)."""
    with _lock:
        return {k[len("dispatch."):]: v for k, v in _counters.items()
                if k.startswith("dispatch.")}


# ---------------------------------------------------------------------------
# Causal ids + discrete-event ring (the flight-recorder substrate)
# ---------------------------------------------------------------------------

class _Causal:
    """Scope installing causal ids (req_id / epoch+nbatch) as the
    thread's ambient span context; nests (inner ids shadow, the outer
    dict is restored on exit)."""
    __slots__ = ("_ids", "_prev")

    def __init__(self, ids):
        self._ids = ids

    def __enter__(self):
        self._prev = getattr(_tls, "ids", None)
        _tls.ids = self._ids
        return self

    def __exit__(self, *exc):
        _tls.ids = self._prev
        return False


def causal(**ids):
    """``with telemetry.causal(epoch=2, nbatch=17): ...`` — every span
    recorded on THIS thread inside the scope carries the given ids
    (``chrome_events()`` renders shared ids as flow arrows; postmortems
    and ``tools/flight_view.py`` group the ring by them). Spans that
    cross threads pass ``span(name, ctx=...)`` explicitly instead."""
    return _Causal(ids)


def current_causal():
    """The ambient causal-id dict of this thread (None outside any
    ``causal()`` scope)."""
    return getattr(_tls, "ids", None)


def record_event(kind, **data):
    """Append one discrete runtime event (a fault firing, a shed, a
    breaker trip, a checkpoint save) to the bounded event ring — the
    flight record a crash postmortem dumps. Lock-free (GIL-atomic
    bounded-deque append): events fire from hot paths and from inside
    OTHER locks (the serving admission path holds the engine lock).
    No-op while disabled."""
    if not _state.enabled:
        return
    _events.append((time.perf_counter_ns(), kind, data or None,
                    threading.get_ident()))


def events(n=None):
    """The retained event ring as JSON-safe dicts (oldest first):
    ``{"ts": epoch_s, "kind": ..., "tid": ..., "data": {...}|None}``.
    ``n`` keeps only the newest n."""
    with _lock:
        evs = list(_events)
    if n is not None:
        evs = evs[-int(n):]
    return [{"ts": round(_epoch_us(p_ns) / 1e6, 6), "kind": kind,
             "tid": tid, "data": data}
            for p_ns, kind, data, tid in evs]


def recent_spans(n=None):
    """The retained span ring as JSON-safe dicts (oldest first):
    ``{"name", "ts" (epoch_s), "dur_ms", "tid", "ctx"}`` — the causal
    ``ctx`` carries the req_id / step ids stamped by ``causal()`` or an
    explicit ``span(ctx=)``. ``n`` keeps only the newest n."""
    with _lock:
        spans = list(_spans)
    if n is not None:
        spans = spans[-int(n):]
    return [{"name": name, "ts": round(_epoch_us(s_ns) / 1e6, 6),
             "dur_ms": round((e_ns - s_ns) / 1e6, 4), "tid": tid,
             "ctx": None if ctx is None else dict(ctx)}
            for name, s_ns, e_ns, tid, ctx in spans]


# ---------------------------------------------------------------------------
# Host-side span tracing
# ---------------------------------------------------------------------------

class _Span:
    """Reentrant-per-instance-free timing scope; ~two perf_counter_ns
    calls + two deque appends when enabled, two attribute reads when
    disabled. ``ctx`` pins explicit causal ids (for spans that are
    entered on one thread and exited on another, e.g. the serving
    request spans); without it the recording thread's ambient
    ``causal()`` ids are captured at ENTER."""
    __slots__ = ("name", "_t0", "_gen", "_ctx")

    def __init__(self, name, ctx=None):
        self.name = name
        self._t0 = 0
        self._ctx = ctx

    def __enter__(self):
        if _state.enabled:
            self._t0 = time.perf_counter_ns()
            self._gen = _gen
            if self._ctx is None:
                self._ctx = getattr(_tls, "ids", None)
        return self

    def cancel(self):
        """Drop this span: nothing is recorded at scope exit (e.g. an
        epoch-end StopIteration is not io time)."""
        self._t0 = 0

    def __exit__(self, *exc):
        # record only if telemetry is STILL enabled (a disable() mid-
        # span pins the disabled leg clean) and no reset() started a
        # new accounting window while this span was open
        if self._t0 and _state.enabled and self._gen == _gen:
            _record_span(self.name, self._t0, time.perf_counter_ns(),
                         self._ctx)
        self._t0 = 0
        return False


def span(name, ctx=None):
    """``with telemetry.span("feed"): ...`` — record one host wall-time
    interval into the ring buffer and the per-name histogram. ``ctx``
    attaches explicit causal ids (defaults to the recording thread's
    ambient ``causal()`` scope)."""
    return _Span(name, ctx)


def record_span(name, t0_ns, t1_ns, ctx=None):
    """Record an already-completed interval (``perf_counter_ns``
    endpoints) retroactively — for callers that only learn a span's
    identity AFTER it ended: the collective gate knows which rank it
    waited on (and by how much) only once the wait resolves, yet the
    ``gate_wait`` span must carry that attribution in its ctx."""
    if not _state.enabled:
        return
    _record_span(name, int(t0_ns), int(t1_ns), dict(ctx) if ctx else None)


def _record_span(name, t0_ns, t1_ns, ctx=None):
    # deque.append and dict reads are GIL-atomic so the ring/histogram
    # writes stay lock-free; the cumulative counter is a read-modify-
    # write and takes the lock like every other counter
    _spans.append((name, t0_ns, t1_ns, threading.get_ident(), ctx))
    d = _durations.get(name)
    if d is None:
        with _lock:
            d = _durations.setdefault(name, collections.deque(
                maxlen=_DURATIONS_PER_NAME))
    d.append((t1_ns - t0_ns) / 1e9)
    with _lock:
        _span_total[name] = _span_total.get(name, 0) + 1
        _span_seconds[name] = _span_seconds.get(name, 0.0) \
            + (t1_ns - t0_ns) / 1e9


def span_seconds(name):
    """CUMULATIVE wall-seconds recorded under ``name`` since the last
    reset() — unlike the histogram total, not capped by the duration
    ring. The online-MFU denominator."""
    with _lock:
        return _span_seconds.get(name, 0.0)


def span_count(name):
    """CUMULATIVE number of spans recorded under ``name`` since the last
    reset() — unlike ``span_stats()[name]['count']``, not capped by the
    histogram ring, so windowed readers (TelemetryLogger) can tell how
    many new samples landed since their last look."""
    with _lock:
        return _span_total.get(name, 0)


def span_durations(name):
    """Copy of the retained duration samples (seconds, oldest first) for
    one span name — at most the last ``_DURATIONS_PER_NAME`` samples."""
    with _lock:
        d = _durations.get(name)
        return list(d) if d is not None else []


def _percentile(sorted_vals, q):
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(
        q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def span_stats(name=None):
    """Per-span-name wall-time statistics over the retained histogram:
    {name: {count, total_ms, mean_ms, p50_ms, p95_ms, p99_ms, max_ms}}.
    ``name`` restricts to one span name."""
    with _lock:
        items = [(name, list(_durations[name]))] if name is not None \
            and name in _durations else \
            ([] if name is not None else
             [(k, list(v)) for k, v in _durations.items()])
    out = {}
    for k, vals in items:
        s = sorted(vals)
        total = sum(s)
        out[k] = {
            "count": len(s),
            "total_ms": round(total * 1e3, 3),
            "mean_ms": round(total / len(s) * 1e3, 4) if s else 0.0,
            "p50_ms": round(_percentile(s, 50) * 1e3, 4),
            "p95_ms": round(_percentile(s, 95) * 1e3, 4),
            "p99_ms": round(_percentile(s, 99) * 1e3, 4),
            "max_ms": round(s[-1] * 1e3, 4) if s else 0.0,
        }
    return out


# ---------------------------------------------------------------------------
# Program-card registry
# ---------------------------------------------------------------------------

def set_peak_flops(flops):
    """Tell the registry the chip's peak FLOP/s so ``snapshot()`` can
    turn the online sustained-FLOP/s into an MFU fraction. ``None``
    clears it (MFU reads ``None`` again)."""
    global _peak_flops
    with _lock:
        _peak_flops = None if flops is None else float(flops)


def record_program(card):
    """Install one program card (a JSON-safe dict built by
    ``executor.make_card`` — this module never inspects torch
    objects). ``card["id"]`` keys the registry; a re-record under the
    same id replaces the entry. The registry is bounded at
    ``MAX_PROGRAM_CARDS``: the oldest card is evicted with its
    FLOPs x dispatches folded into the online total."""
    global _programs_dropped_flops
    if not _state.enabled or not isinstance(card, dict) \
            or "id" not in card:
        return
    card.setdefault("dispatches", 0)
    with _lock:
        card["_gen"] = _gen
        _programs[card["id"]] = card
        while len(_programs) > MAX_PROGRAM_CARDS:
            old = _programs.pop(next(iter(_programs)))   # oldest insert
            _programs_dropped_flops += \
                (old.get("flops") or 0.0) * old.get("dispatches", 0)


def program_dispatch(card):
    """One launch of a carded program: bump its dispatch count (under
    the lock — cards are shared with ``programs()`` readers). If a
    reset() opened a new accounting window since the card was
    installed, the count restarts and the card re-registers — so a
    windowed snapshot reads only this window's dispatches."""
    if not _state.enabled or card is None:
        return
    with _lock:
        if card.get("_gen") != _gen:
            card["dispatches"] = 0
            card["_gen"] = _gen
            _programs[card["id"]] = card
        card["dispatches"] = card.get("dispatches", 0) + 1


def card_update(card, **fields):
    """Mutate a (possibly registered) card under the registry lock —
    the only safe way to add fields after ``record_program``, since
    ``programs()`` iterates the shared dict objects."""
    if card is None:
        return
    with _lock:
        card.update(fields)


def card_annotate(card_id, **fields):
    """Annotate a REGISTERED card by id (callers that only hold the
    ``programs()`` copy, e.g. the serving autotuner stamping its chosen
    plan onto the bucket cards). Returns True when the card exists."""
    with _lock:
        card = _programs.get(card_id)
        if card is None:
            return False
        card.update(fields)
        return True


def programs():
    """{card_id: card} copy of the program-card registry (private
    bookkeeping keys stripped — the result is JSON-serializable). The
    per-card copies happen INSIDE the lock: cards are live objects
    that dispatchers mutate under the same lock."""
    with _lock:
        return {k: {kk: vv for kk, vv in c.items()
                    if not kk.startswith("_")}
                for k, c in _programs.items()}


def _online_stats():
    """The live roofline estimate: FLOPs dispatched (card FLOPs x
    dispatch count, plus evicted cards' share) over cumulative
    step-span wall-time. ``mfu`` needs ``set_peak_flops`` — the chip
    ceiling is not knowable from stdlib."""
    with _lock:
        flops = _programs_dropped_flops + sum(
            (c.get("flops") or 0.0) * c.get("dispatches", 0)
            for c in _programs.values())
        step_s = _span_seconds.get("step", 0.0)
        compile_s = _span_seconds.get("jit_compile", 0.0)
        deser_s = _span_seconds.get("jit_deserialize", 0.0)
        # read the ceiling INSIDE the lock: the mfu and peak_flops
        # fields below must come from the same value (a set_peak_flops
        # racing the two bare reads used to be able to split them)
        peak = _peak_flops
    out = {
        "flops_dispatched": flops,
        "step_time_s": round(step_s, 6),
        # first-launch compiles happen INSIDE the step span; reported so
        # readers can judge how much of the window was warmup
        "compile_time_s": round(compile_s, 6),
        # disk-cache loads (compile_cache) — the warm-start counterpart
        "deserialize_time_s": round(deser_s, 6),
        "model_flops_per_s": round(flops / step_s, 3) if step_s else None,
        "peak_flops": peak,
        # unrounded: a CPU-smoke MFU is ~1e-6 and must not read as 0.0
        "mfu": flops / step_s / peak if step_s and peak else None,
    }
    return out


# ---------------------------------------------------------------------------
# Live device-buffer ledger
# ---------------------------------------------------------------------------

def _ledger_release(token):
    """The weakref callback for ``token``: LOCK-FREE (deque.append is
    GIL-atomic) — see the _ledger_pending note for why taking _lock here
    would deadlock under cyclic GC. (A ``weakref.ref`` callback, not the
    JAX package's ``weakref.finalize``: half the cost per tracked array,
    which the port pays once per eager op.)"""
    def release(_ref):
        try:
            _ledger_pending.append(token)
        except Exception:   # interpreter-shutdown callbacks must not raise
            pass
    return release


def _ledger_release_one_locked(token):
    """Retire ONE live token's charge. Caller holds _lock."""
    _ledger_refs.pop(token, None)
    rec = _ledger_live.pop(token, None)
    if rec is None:
        return
    st = _ledger.get(rec[0])
    if st is not None:
        st["alive_bytes"] -= rec[1]
        st["alive_count"] -= 1
        bk = st["by_kind"]
        bk[rec[4]] = bk.get(rec[4], 0) - rec[1]
    # a replace-keyed charge drops its reverse-map entry with it (only
    # if the key still maps to THIS token — a re-track may already have
    # claimed it for a newer charge)
    kk = rec[5]
    if kk is not None and _ledger_keyed.get(kk) == token:
        del _ledger_keyed[kk]


def _ledger_drain_locked():
    """Apply pending releases to the counters. Caller holds _lock."""
    while _ledger_pending:
        _ledger_release_one_locked(_ledger_pending.popleft())


def ledger_track(obj, ctx_key, nbytes, shape=None, dtype=None,
                 kind="ndarray", replace=False):
    """Charge ``nbytes`` on context ``ctx_key`` until ``obj`` is
    garbage-collected (a weakref callback releases the charge). Tracks
    the FRAMEWORK's view — aliasing wrappers (detach, shared _data)
    each count, so alive-bytes is an upper bound of framework-held
    device memory (``torch.cuda.memory_allocated`` is the allocator's
    own figure). No-op while disabled (but releases
    always run, so toggling never corrupts the counters).

    ``replace=True`` keys the charge on ``(obj, ctx_key, kind)`` and
    retires any prior live charge under the same key first — the
    re-commit path (a parameter re-placed on its mesh after
    init_params / a plan rebuild) updates its charge instead of
    double-counting the same storage."""
    if not _state.enabled:
        return
    nbytes = int(nbytes)
    token = next(_ledger_seq)
    try:
        ref = weakref.ref(obj, _ledger_release(token))
    except TypeError:       # obj not weakref-able: count cumulatively only
        token = None
    with _lock:
        _ledger_drain_locked()
        st = _ledger.get(ctx_key)
        if st is None:
            st = _ledger[ctx_key] = {
                "alive_bytes": 0, "alive_count": 0, "peak_bytes": 0,
                "tracked_total": 0, "tracked_bytes_total": 0,
                "by_kind": {}}
        st["tracked_total"] += 1
        st["tracked_bytes_total"] += nbytes
        if token is not None:
            keyed_key = None
            if replace:
                keyed_key = (id(obj), ctx_key, kind)
                prior = _ledger_keyed.pop(keyed_key, None)
                if prior is not None:
                    _ledger_release_one_locked(prior)
                _ledger_keyed[keyed_key] = token
            st["alive_bytes"] += nbytes
            st["alive_count"] += 1
            st["by_kind"][kind] = st["by_kind"].get(kind, 0) + nbytes
            if st["alive_bytes"] > st["peak_bytes"]:
                st["peak_bytes"] = st["alive_bytes"]
            _ledger_live[token] = (ctx_key, nbytes, shape, dtype, kind,
                                   keyed_key)
            _ledger_refs[token] = ref


def ledger():
    """{ctx: {alive_bytes, alive_count, peak_bytes, tracked_total,
    tracked_bytes_total, by_kind}} copy of the per-context ledger
    counters (``by_kind``: live bytes per track kind — e.g. committed
    ``param`` bytes vs in-flight ``shard_put`` batches on a mesh)."""
    with _lock:
        _ledger_drain_locked()
        return {k: dict(v, by_kind=dict(v["by_kind"]))
                for k, v in _ledger.items()}


def ledger_top(n=8):
    """The ``n`` largest LIVE tracked buffers, biggest first:
    [{ctx, nbytes, shape, dtype, kind}] — what the enriched OOM error
    prints so an allocation failure names its suspects."""
    with _lock:
        _ledger_drain_locked()
        live = list(_ledger_live.values())
    live.sort(key=lambda r: -r[1])
    return [{"ctx": r[0], "nbytes": r[1],
             "shape": None if r[2] is None else list(r[2]),
             "dtype": None if r[3] is None else str(r[3]),
             "kind": r[4]} for r in live[:n]]


def online():
    """The live roofline estimate alone (``snapshot()["online"]``)
    without the span-percentile sorts the full snapshot pays — what the
    flight-recorder sampler reads every tick."""
    return _online_stats()


try:
    _HOSTNAME = socket.gethostname()
except OSError:
    _HOSTNAME = "unknown"


def process_identity():
    """The uniform WHO-wrote-this block every banked JSON carries: rank /
    process count / recorded-dead peers from ``dist.py`` (the launch
    environment's values before the group is up; never raises), plus
    host and pid so artifacts from a shared ``MXNET_FLIGHT_DIR`` are
    attributable. Embedded in :func:`snapshot`, flight postmortems, the
    flight sampler's series window and the serving stats surface."""
    try:
        from . import dist as _dist
        ident = {"rank": _dist.rank(),
                 "num_processes": _dist.process_count(),
                 "dead_ranks": list(_dist.dead_ranks())}
    except Exception:
        ident = {"rank": 0, "num_processes": 1, "dead_ranks": []}
    ident["host"] = _HOSTNAME
    ident["pid"] = os.getpid()
    return ident


def snapshot():
    """One self-describing dict: counters + span percentiles + program
    cards + the online MFU estimate + the buffer ledger + the process
    identity block. This is what ``Module.telemetry_snapshot()``
    returns, what ``chip_smoke.py`` prints and what ``callback.TelemetryLogger`` diffs per log line. Every
    value is JSON-serializable end to end."""
    return {
        "enabled": _state.enabled,
        "process": process_identity(),
        "counters": counters(),
        "spans": span_stats(),
        "programs": programs(),
        "online": _online_stats(),
        "ledger": ledger(),
    }


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

def mark_trace_start():
    """Stamp the profiler trace-start instant; ``chrome_events()`` then
    exports only spans inside the trace window. Called by
    ``profiler.set_state('run')``."""
    global _trace_start_ns
    _trace_start_ns = time.perf_counter_ns()
    return _trace_start_ns


def _epoch_us(perf_ns):
    return (_ANCHOR_EPOCH_NS + (perf_ns - _ANCHOR_PERF_NS)) / 1e3


def trace_start_epoch_us():
    """Epoch-microsecond instant of the last mark_trace_start() (None
    before any trace ran) — profiler.py aligns host events against the
    device trace's own timebase through this."""
    if _trace_start_ns is None:
        return None
    return _epoch_us(_trace_start_ns)


def _flow_ids(ctx):
    """The flow identities one span's causal ctx binds it to: a request
    id (``req_id`` on request spans, each member of ``req_ids`` on
    batch-level spans) maps to ``req:<n>``; fit-step ids map to
    ``step:<epoch>:<nbatch>``."""
    if not ctx:
        return ()
    out = []
    if ctx.get("req_id") is not None:
        out.append(("req", "req:%s" % ctx["req_id"]))
    for rid in ctx.get("req_ids") or ():
        out.append(("req", "req:%s" % rid))
    if ctx.get("epoch") is not None and ctx.get("nbatch") is not None:
        out.append(("step", "step:%s:%s" % (ctx["epoch"], ctx["nbatch"])))
    return out


# the serving-pipeline order a request FLOW must chain in. Start-time
# order would get it wrong: serve_request is ENTERED at submit (same
# instant as serve_wait), so by start time the chain would terminate at
# serve_d2h and the "request resolved" terminus would never be drawn.
_SERVE_FLOW_RANK = {"serve_wait": 0,
                    "serve_prefill": 1,
                    "serve_batch": 2, "serve_decode_step": 2,
                    "serve_d2h": 3, "serve_detokenize": 3,
                    "serve_request": 4}


def chrome_events(pid=None, since_trace_start=True):
    """Render retained host spans as chrome://tracing complete events
    (``ph: "X"``, ``ts``/``dur`` in microseconds, epoch timebase) plus
    the process/thread metadata rows that label the track "mxnet_tpu
    host" in perfetto, plus FLOW events (``ph: "s"/"t"/"f"``) linking
    the spans that share one causal id — one request's serve_wait →
    serve_batch → serve_d2h → serve_request across the submit/coalesce/
    resolve threads, one fit step's feed → step → opt spans — so
    perfetto draws the request's/step's path as arrows.
    ``since_trace_start=True`` keeps only spans that began after the
    last ``mark_trace_start()`` (everything, if no trace was
    started)."""
    if pid is None:
        pid = os.getpid()
    with _lock:
        spans = list(_spans)
    t0 = _trace_start_ns if since_trace_start else None
    ident = process_identity()
    track = "mxnet_tpu host"
    if ident["num_processes"] > 1:
        track = "mxnet_tpu %s (rank %d)" % (ident["host"], ident["rank"])
    events = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": track},
    }, {
        "ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
        "args": {"sort_index": -1},
    }]
    tids = set()
    flows = {}            # flow id -> (label, [(s_ns, tid), ...])
    for name, s_ns, e_ns, tid, ctx in spans:
        if t0 is not None and s_ns < t0:
            continue
        tids.add(tid)
        ev = {
            "ph": "X", "cat": "host", "name": name,
            "pid": pid, "tid": tid,
            "ts": round(_epoch_us(s_ns), 3),
            "dur": round((e_ns - s_ns) / 1e3, 3),
        }
        if ctx:
            ev["args"] = dict(ctx)
        events.append(ev)
        for label, fid in _flow_ids(ctx):
            # request flows chain in PIPELINE order (wait -> batch ->
            # d2h -> request), not start order — serve_request opens at
            # submit, so its start sorts next to serve_wait; its node
            # binds near the span END (the resolution instant), which
            # also keeps the drawn arrows chronologically forward.
            # Other flows (fit steps) chain by start time.
            rank = _SERVE_FLOW_RANK.get(name, -1) if label == "req" \
                else -1
            bind_ns = s_ns if name != "serve_request" \
                else max(s_ns, e_ns - 1000)
            flows.setdefault(fid, (label, []))[1].append(
                (rank, bind_ns, tid))
    for fid, (label, members) in flows.items():
        if len(members) < 2:
            continue          # an arrow needs two ends
        members.sort()       # (rank, bind_ns, tid): pipeline order,
                             # then time within a rank
        last = len(members) - 1
        for i, (_rank, bind_ns, tid) in enumerate(members):
            # flow binding: ts inside the slice on the same thread —
            # a slice's own start (or a point just before its end, for
            # the serve_request terminus) is inside by definition
            ev = {
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
                "cat": "flow", "name": label, "id": fid,
                "pid": pid, "tid": tid,
                "ts": round(_epoch_us(bind_ns), 3),
            }
            if i == last:
                ev["bp"] = "e"   # bind the finish to the enclosing slice
            events.append(ev)
    for tid in tids:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "host thread %d" % tid},
        })
    return events
