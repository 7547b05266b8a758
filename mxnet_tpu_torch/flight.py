"""Flight recorder: metrics time-series sampler, OpenMetrics endpoint,
and crash postmortems.

A whole copy of ``mxnet_tpu/flight.py`` (the port imports nothing of the
JAX package); ``POSTMORTEM_SCHEMA`` is the JAX package's, so
``tools/flight_view.py`` reads the port's dumps unchanged. The black box
on top of ``telemetry.py``:

* a **metrics sampler** — a daemon thread snapshots counter DELTAS,
  serving queue depth, ledger bytes, the online MFU estimate and
  breaker/shed state into a bounded in-memory time-series ring every
  ``MXNET_METRICS_INTERVAL_MS`` (``sampler_start()``/``sampler_stop()``
  programmatically). It reads host-side registries only and launches
  nothing on the card. ``series()`` reads the ring, ``series_dump()``
  exports it as JSONL;

* an **OpenMetrics endpoint** — ``metrics_http_start()`` (or
  ``MXNET_METRICS_PORT``) serves ``/metrics`` as Prometheus-scrapable
  text from a stdlib ``http.server`` thread. OFF by default and bound
  to loopback (127.0.0.1) only — the endpoint exposes counter names
  and program shapes, so exposing it beyond the host is an explicit
  operator decision (``MXNET_METRICS_HOST``);

* **crash postmortems** — ``postmortem(reason, exc=...)`` dumps one
  flight-record JSON (the last-N span ring with causal req/step ids,
  the discrete-event ring, counters, the recent time-series window,
  program cards, ledger top, fault-registry counts, live engine
  breaker/queue state) through ``checkpoint.atomic_write`` into
  ``MXNET_FLIGHT_DIR``. ``install()`` arms ``sys.excepthook`` /
  ``threading.excepthook`` (a dying coalescer thread writes its own
  black box) and an atexit series flush; ``uninstall()`` restores the
  previous hooks. The runtime triggers dumps explicitly on serving
  breaker trips and terminal batch failures, a dying coalescer or
  decode scheduler, and a decode pool rebuilt after a failed step.
  Everything is inert until a flight dir is configured — the hot paths
  pay nothing.

Postmortem and series file names carry the rank (``dist.py``) as in
the JAX package; the fleet view (the heartbeat's gate statistics in
each sample, peers' postmortems gathered at a member loss) comes with
ROADMAP Queue 1 item 4, second half.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time
import traceback
import weakref

from . import telemetry
from .checkpoint import atomic_write

__all__ = [
    "configure", "flight_dir", "install", "installed", "uninstall",
    "postmortem", "last_postmortem", "gather_peer_postmortems",
    "sampler_start", "sampler_stop", "sampler_running",
    "series", "series_window", "series_dump",
    "metrics_http_start", "metrics_http_stop", "openmetrics_text",
    "register_engine", "engine_states",
    "SERIES_RING_SIZE", "POSTMORTEM_SCHEMA",
]

ENV_DIR = "MXNET_FLIGHT_DIR"
ENV_INTERVAL = "MXNET_METRICS_INTERVAL_MS"
ENV_PORT = "MXNET_METRICS_PORT"
ENV_HOST = "MXNET_METRICS_HOST"

# time-series ring bound: at the 500 ms default interval this holds
# ~17 min of trajectory; a crash dump carries the most recent window
SERIES_RING_SIZE = 2048
DEFAULT_INTERVAL_MS = 500.0

POSTMORTEM_SCHEMA = "mxnet_tpu.flight/1"

# most recent samples a postmortem embeds (the full ring can be large;
# the dump wants the window AROUND the crash, not the whole session)
_POSTMORTEM_SERIES = 240
_POSTMORTEM_SPANS = 512
# per-reason dump throttle: a breaker flapping open/closed must not
# turn the flight dir into a disk-filling loop
_THROTTLE_S = 1.0

_lock = threading.Lock()
_dir = None                  # guarded by: _lock
_env_loaded = False          # guarded by: _lock
_installed = False           # guarded by: _lock
_prev_excepthook = None      # guarded by: _lock
_prev_threading_hook = None  # guarded by: _lock
_series = collections.deque(maxlen=SERIES_RING_SIZE)  # guarded by: _lock
_sampler_thread = None       # guarded by: _lock
_sampler_stop = None         # guarded by: _lock
_sampler_interval_s = None   # guarded by: _lock
_http_server = None          # guarded by: _lock
_http_thread = None          # guarded by: _lock
_engines = weakref.WeakSet()  # guarded by: _lock
_last_dump = {}              # guarded by: _lock
                             # reason -> monotonic instant of last dump
_last_path = None            # guarded by: _lock
_seq = 0                     # guarded by: _lock


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

def _load_env_locked():
    """Lazily adopt MXNET_FLIGHT_DIR. Caller holds _lock."""
    global _dir, _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    env = os.environ.get(ENV_DIR)
    if env and _dir is None:
        _dir = env


def configure(directory):
    """Set (or clear, with None) the postmortem directory and arm the
    process hooks. Explicit calls override ``MXNET_FLIGHT_DIR``."""
    global _dir, _env_loaded
    with _lock:
        _env_loaded = True
        _dir = None if directory is None else str(directory)
        armed = _dir is not None
    if armed:
        install()


def flight_dir():
    """The active postmortem directory, or None (recorder inert)."""
    with _lock:
        _load_env_locked()
        return _dir


# ---------------------------------------------------------------------------
# Live-engine registry (serving breaker/queue state for dumps/samples)
# ---------------------------------------------------------------------------

def register_engine(engine):
    """Track a live ``serving.InferenceEngine`` (weakly) so samples and
    postmortems can report its queue/breaker state. The engine calls
    this at construction; a collected engine drops out on its own."""
    with _lock:
        _engines.add(engine)


def engine_states():
    """[light overload-state dict per live engine] — each read under
    the engine's own lock via ``InferenceEngine.overload_state()``."""
    with _lock:
        engines = list(_engines)
    out = []
    for e in engines:
        try:
            out.append(e.overload_state())
        except Exception:   # a half-closed engine must not kill a dump
            pass
    return out


# ---------------------------------------------------------------------------
# Metrics sampler
# ---------------------------------------------------------------------------

def _build_sample(last, dt_s):
    """One time-series sample: counter deltas over the interval plus
    the derived gauges. Returns (sample, new_cumulative_baseline)."""
    cum = telemetry.counters()
    if any(cum.get(k, 0) < v for k, v in last.items()):
        # telemetry.reset() opened a new accounting window mid-interval:
        # deltas against the old baseline are meaningless
        deltas, reset = {}, True
    else:
        deltas = {k: v - last.get(k, 0) for k, v in cum.items()
                  if v != last.get(k, 0)}
        reset = False
    led = telemetry.ledger()
    online = telemetry.online()
    engines = engine_states()
    sample = {
        "ts": round(time.time(), 3),
        "dt_ms": round(dt_s * 1e3, 1),
        "rank": telemetry.process_identity()["rank"],
        "counters": deltas,
        "queue_depth": telemetry.serving_queue_depth(cum),
        "ledger_bytes": sum(st.get("alive_bytes", 0)
                            for st in led.values()),
        "mfu": online.get("mfu"),
        "model_flops_per_s": online.get("model_flops_per_s"),
        "serving": {
            "queued_rows": sum(e.get("queued_rows", 0) for e in engines),
            "breaker_open": any(e.get("breaker_open") for e in engines),
            "engines": len(engines),
            # slot occupancy across registered decode engines (0 for a
            # fleet of stateless engines — their overload_state carries
            # no active_slots key)
            "active_slots": sum(e.get("active_slots", 0)
                                for e in engines),
        },
    }
    if reset:
        sample["registry_reset"] = True
    return sample, cum


def _sampler_loop(stop, interval_s):
    last = telemetry.counters()
    last_t = time.monotonic()
    while not stop.wait(interval_s):
        now = time.monotonic()
        try:
            sample, last = _build_sample(last, now - last_t)
        except Exception:    # a torn read must not kill the sampler
            last_t = now
            continue
        last_t = now
        with _lock:
            _series.append(sample)


def sampler_start(interval_ms=None):
    """Start the daemon sampler thread (idempotent; a second call with
    a different interval restarts it). ``interval_ms`` defaults to
    ``MXNET_METRICS_INTERVAL_MS`` or 500; an interval <= 0 means
    DISABLED (returns None without starting — so an operator's
    ``MXNET_METRICS_INTERVAL_MS=0`` turns the sampler off instead of
    spinning it at the clamp floor). Returns the interval in ms."""
    global _sampler_thread, _sampler_stop, _sampler_interval_s
    if interval_ms is None:
        interval_ms = float(os.environ.get(ENV_INTERVAL,
                                           DEFAULT_INTERVAL_MS))
    if float(interval_ms) <= 0:
        return None
    interval_s = max(0.001, float(interval_ms) / 1e3)
    restart = False
    with _lock:
        if _sampler_thread is not None and _sampler_thread.is_alive():
            if _sampler_interval_s == interval_s:
                return interval_s * 1e3
            restart = True
    if restart:
        sampler_stop()
    with _lock:
        if _sampler_thread is not None and _sampler_thread.is_alive():
            return _sampler_interval_s * 1e3
        _sampler_stop = threading.Event()
        _sampler_interval_s = interval_s
        _sampler_thread = threading.Thread(
            target=_sampler_loop, args=(_sampler_stop, interval_s),
            name="mxtpu-flight-sampler", daemon=True)
        _sampler_thread.start()
    return interval_s * 1e3


def sampler_stop():
    """Stop the sampler thread (the ring keeps its samples)."""
    global _sampler_thread, _sampler_stop
    with _lock:
        thread, stop = _sampler_thread, _sampler_stop
        _sampler_thread = _sampler_stop = None
    if stop is not None:
        stop.set()
    if thread is not None and thread.is_alive():
        thread.join(timeout=5.0)


def sampler_running():
    with _lock:
        return _sampler_thread is not None and _sampler_thread.is_alive()


def sampler_interval_ms():
    """The running sampler's interval in ms, or None."""
    with _lock:
        if _sampler_thread is None or not _sampler_thread.is_alive():
            return None
        return _sampler_interval_s * 1e3


def series(n=None):
    """Copy of the time-series ring (oldest first); ``n`` keeps only
    the newest n samples."""
    with _lock:
        out = list(_series)
    if n is not None:
        out = out[-int(n):]
    return out


def series_window(n=_POSTMORTEM_SERIES):
    """The artifact-friendly tail of the ring: ``{"interval_ms", "n",
    "samples"}`` — what an artifact banks next to its snapshot."""
    samples = series(n)
    return {"interval_ms": sampler_interval_ms(),
            "process": telemetry.process_identity(),
            "n": len(samples), "samples": samples}


def series_clear():
    """Drop every retained sample (a fresh measurement window)."""
    with _lock:
        _series.clear()


def series_dump(path=None, n=None):
    """The ring as JSONL text (one sample per line, oldest first).
    ``path`` additionally writes it atomically. Returns the text."""
    text = "".join(json.dumps(s, sort_keys=True) + "\n"
                   for s in series(n))
    if path:
        atomic_write(path, text)
    return text


# ---------------------------------------------------------------------------
# OpenMetrics endpoint
# ---------------------------------------------------------------------------

def _metric_name(name):
    """Counter name -> OpenMetrics-safe sample name."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() else "_")
    return "mxnet_tpu_" + "".join(out)


def _escape_label(val):
    return str(val).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def openmetrics_text():
    """The registry as OpenMetrics/Prometheus exposition text: every
    telemetry counter as a ``counter`` family (``_total`` samples),
    plus the derived gauges (queue depth, per-context ledger bytes,
    online MFU, live-engine queued rows / breaker state). Every sample
    carries ``rank``/``host`` labels so one Prometheus
    scraping a fleet can aggregate or slice per rank without relabel
    rules."""
    ident = telemetry.process_identity()
    who = {"rank": ident["rank"], "host": ident["host"]}

    def labels_tail(labels):
        return "{%s}" % ",".join(
            '%s="%s"' % (k, _escape_label(v))
            for k, v in sorted(labels.items()))

    cum = telemetry.counters()
    lines = []
    for name in sorted(cum):
        m = _metric_name(name)
        lines.append("# TYPE %s counter" % m)
        lines.append("%s_total%s %s" % (m, labels_tail(who), cum[name]))

    typed = set()

    def gauge(name, value, labels=None):
        if value is None:
            return
        # ONE metadata line per metric family: a labeled gauge emitted
        # per context (the ledger) must not repeat its '# TYPE' — the
        # OpenMetrics parser rejects duplicate family metadata
        if name not in typed:
            typed.add(name)
            lines.append("# TYPE %s gauge" % name)
        merged = dict(who)
        if labels:
            merged.update(labels)
        lines.append("%s%s %s" % (name, labels_tail(merged), value))

    gauge("mxnet_tpu_serving_queue_depth",
          telemetry.serving_queue_depth(cum))
    for ctx, st in sorted(telemetry.ledger().items()):
        gauge("mxnet_tpu_ledger_alive_bytes", st.get("alive_bytes", 0),
              {"ctx": ctx})
    online = telemetry.online()
    gauge("mxnet_tpu_online_mfu", online.get("mfu"))
    gauge("mxnet_tpu_online_model_flops_per_s",
          online.get("model_flops_per_s"))
    engines = engine_states()
    gauge("mxnet_tpu_serving_queued_rows",
          sum(e.get("queued_rows", 0) for e in engines))
    gauge("mxnet_tpu_serving_breaker_open",
          int(any(e.get("breaker_open") for e in engines)))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def metrics_http_start(port=None, host=None):
    """Serve ``/metrics`` from a stdlib http.server daemon thread.
    OFF unless called (or ``MXNET_METRICS_PORT`` set > 0); binds
    LOOPBACK ONLY by default — the text exposes internal counter names
    and program shapes, so a wider bind (``host=``/
    ``MXNET_METRICS_HOST``) is an explicit operator decision. A
    PROGRAMMATIC ``port=0`` picks an ephemeral port (tests); the env
    knob treats 0 as OFF, matching the sampler's interval semantics.
    Returns the bound port."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    if port is None:
        port = int(os.environ.get(ENV_PORT, "0") or "0")
    if host is None:
        host = os.environ.get(ENV_HOST, "127.0.0.1")

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = openmetrics_text().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):   # scrapes must not spam stderr
            pass

    global _http_server, _http_thread
    with _lock:
        if _http_server is not None:
            return _http_server.server_address[1]
        _http_server = ThreadingHTTPServer((host, int(port)), _Handler)
        _http_server.daemon_threads = True
        _http_thread = threading.Thread(
            target=_http_server.serve_forever,
            name="mxtpu-flight-metrics", daemon=True)
        _http_thread.start()
        return _http_server.server_address[1]


def metrics_http_stop():
    global _http_server, _http_thread
    with _lock:
        server, thread = _http_server, _http_thread
        _http_server = _http_thread = None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None and thread.is_alive():
        thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Crash postmortems
# ---------------------------------------------------------------------------

def _exc_record(exc):
    if exc is None:
        return None
    rec = {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))[-16384:],
    }
    site = getattr(exc, "site", None)
    if site is not None:            # faults.InjectedFault names its site
        rec["fault_site"] = site
    return rec


def _process_identity():
    """Which worker of a multi-process job wrote this dump (a pod-scale
    postmortem is read next to its peers' — "whose flight recorder is
    this" must not require correlating pids with launcher logs). The
    uniform block lives in telemetry so snapshots, series windows,
    artifacts and dumps all agree on its shape."""
    return telemetry.process_identity()


def _build_record(reason, exc=None, extra=None):
    rec = {
        "schema": POSTMORTEM_SCHEMA,
        "reason": reason,
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "process": _process_identity(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "exception": _exc_record(exc),
        "extra": extra,
        "counters": telemetry.counters(),
        "events": telemetry.events(),
        "spans": telemetry.recent_spans(_POSTMORTEM_SPANS),
        "series": series(_POSTMORTEM_SERIES),
        "programs": telemetry.programs(),
        "online": telemetry.online(),
        "ledger": telemetry.ledger(),
        "ledger_top": telemetry.ledger_top(16),
        "engines": engine_states(),
    }
    try:
        from . import faults
        rec["faults"] = {"spec": faults.spec(), "counts": faults.counts()}
    except Exception:
        rec["faults"] = None
    return rec


def postmortem(reason, exc=None, extra=None, path=None, force=False):
    """Dump one flight-record JSON. ``reason`` names the trigger
    (``uncaught_exception``, ``device_memory_error``, ``divergence``,
    ``breaker_trip``, ``serving_dispatch_failure``,
    ``training_preempted``, ...); ``exc`` rides as a structured
    exception record (an ``InjectedFault``'s site is surfaced);
    ``extra`` carries trigger-specific facts — the serving path passes
    the dying batch's member ``req_ids``.

    Writes to ``path`` when given, else to the configured flight dir
    (``MXNET_FLIGHT_DIR`` / ``configure()``); with NEITHER, this is a
    no-op returning None — the triggers stay wired permanently and cost
    one check while the recorder is off. Dumps of one reason are
    throttled to one per second unless ``force=True`` (a flapping
    breaker must not fill the disk). Returns the written path, and
    never raises — a postmortem failing must not mask the crash being
    recorded."""
    global _seq, _last_path
    try:
        target = path
        throttled = False
        if target is None:
            d = flight_dir()
            if d is None:
                return None
            with _lock:
                now = time.monotonic()
                if not force and now - _last_dump.get(reason, -1e9) \
                        < _THROTTLE_S:
                    return None
                _seq += 1
                seq = _seq
            throttled = True
            # rank-disambiguated filename: a fleet shares ONE
            # MXNET_FLIGHT_DIR over NFS, where pids collide across
            # hosts — two ranks dumping the same reason must land as
            # two files, never clobber. (The per-reason throttle above
            # is in-process state, so it is rank-local by
            # construction — rank 0 dumping dead_worker never
            # suppresses rank 2's.)
            target = os.path.join(
                d, "postmortem-r%d-%d-%03d-%s.json" % (
                    telemetry.process_identity()["rank"], os.getpid(),
                    seq, _safe_reason(reason)))
        rec = _build_record(reason, exc=exc, extra=extra)
        atomic_write(target, json.dumps(rec, sort_keys=True,
                                        default=str))
        with _lock:
            _last_path = target
            if throttled:
                # stamp the throttle slot only AFTER a successful
                # write: a transient disk failure must not suppress
                # the next genuine trigger of the same reason
                _last_dump[reason] = time.monotonic()
        telemetry.counter_inc("flight.postmortem")
        telemetry.record_event("flight.postmortem", reason=reason,
                               path=target)
        return target
    except Exception as e:
        telemetry.counter_inc("flight.postmortem_fail")
        try:
            from . import log as _log
            _log.get_logger("mxnet_tpu_torch.flight").warning(
                "flight: postmortem %r failed: %s", reason, e)
        except Exception:
            pass
        return None


def _safe_reason(reason):
    return "".join(ch if ch.isalnum() or ch in "-_" else "_"
                   for ch in str(reason))[:64] or "unknown"


def last_postmortem():
    """Path of the most recent dump this process wrote, or None."""
    with _lock:
        return _last_path


_PM_RANK_RE = None      # compiled lazily; module stays regex-free otherwise


def gather_peer_postmortems(directory=None, exclude_rank=None,
                            max_events=8):
    """Light summaries of OTHER ranks' newest postmortems in the shared
    flight dir — the survivor's ``dead_worker`` dump embeds these so
    the cluster view shows the victim's last seconds, not just the
    survivor's keyhole. One entry per rank (its newest dump by mtime):
    ``{"rank", "path", "reason", "ts", "exception", "events_tail"}``.
    Best-effort end to end: a corrupt or half-written peer dump is
    skipped, and nothing here ever raises — this runs inside elastic
    recovery, where a second failure must not mask the first."""
    global _PM_RANK_RE
    try:
        import re as _re
        if _PM_RANK_RE is None:
            _PM_RANK_RE = _re.compile(r"^postmortem-r(\d+)-.*\.json$")
        d = directory or flight_dir()
        if d is None:
            return []
        me = telemetry.process_identity()["rank"] \
            if exclude_rank is None else int(exclude_rank)
        newest = {}                 # rank -> (mtime, path)
        for name in os.listdir(d):
            m = _PM_RANK_RE.match(name)
            if not m:
                continue
            rank = int(m.group(1))
            if rank == me:
                continue
            path = os.path.join(d, name)
            try:
                mt = os.path.getmtime(path)
            except OSError:
                continue
            if rank not in newest or mt > newest[rank][0]:
                newest[rank] = (mt, path)
        out = []
        for rank in sorted(newest):
            _mt, path = newest[rank]
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            exc = rec.get("exception")
            out.append({
                "rank": rank,
                "path": path,
                "reason": rec.get("reason"),
                "ts": rec.get("ts"),
                "exception": {"type": exc.get("type"),
                              "message": exc.get("message")}
                if isinstance(exc, dict) else None,
                "events_tail": (rec.get("events") or [])[-max_events:],
            })
        return out
    except Exception:
        return []


# ---------------------------------------------------------------------------
# Process hooks
# ---------------------------------------------------------------------------

def _excepthook(exc_type, exc, tb):
    if not (exc_type is KeyboardInterrupt or exc_type is SystemExit):
        if exc is not None and exc.__traceback__ is None:
            exc.__traceback__ = tb
        postmortem("uncaught_exception", exc=exc, force=True)
    prev = _prev_excepthook
    (prev or sys.__excepthook__)(exc_type, exc, tb)


def _threading_hook(args):
    if args.exc_type is not SystemExit:
        postmortem(
            "uncaught_thread_exception", exc=args.exc_value,
            extra={"thread": getattr(args.thread, "name", None)},
            force=True)
    prev = _prev_threading_hook
    (prev or threading.__excepthook__)(args)


def _atexit_flush():
    sampler_stop()
    d = flight_dir()
    if d is not None and series(1):
        try:
            series_dump(os.path.join(
                d, "flight-series-r%d-%d.jsonl" % (
                    telemetry.process_identity()["rank"],
                    os.getpid())))
        except Exception:
            pass


def install():
    """Arm the process-level hooks (idempotent): ``sys.excepthook`` and
    ``threading.excepthook`` dump a postmortem on any uncaught
    exception (then chain to the previous hook), and an atexit handler
    flushes the time-series ring to the flight dir. Called by
    ``configure()`` and the env autostart."""
    global _installed, _prev_excepthook, _prev_threading_hook
    with _lock:
        if _installed:
            return
        _installed = True
        _prev_excepthook = sys.excepthook
        _prev_threading_hook = threading.excepthook
    sys.excepthook = _excepthook
    threading.excepthook = _threading_hook
    atexit.register(_atexit_flush)


def installed():
    with _lock:
        return _installed


def uninstall():
    """Undo ``install()``: restore the hooks it replaced (where they are
    still ours) and drop the atexit flush. For tests and embedders that
    must leave the process as they found it."""
    global _installed, _prev_excepthook, _prev_threading_hook
    with _lock:
        if not _installed:
            return
        _installed = False
        prev, prev_t = _prev_excepthook, _prev_threading_hook
        _prev_excepthook = _prev_threading_hook = None
    if sys.excepthook is _excepthook:
        sys.excepthook = prev or sys.__excepthook__
    if threading.excepthook is _threading_hook:
        threading.excepthook = prev_t or threading.__excepthook__
    atexit.unregister(_atexit_flush)


def _maybe_autostart():
    """Adopt the env knobs at package import: a flight dir arms the
    hooks, an interval > 0 starts the sampler, a port > 0 starts the
    scrape endpoint (<= 0 means OFF for both, matching the sampler's
    documented knob). All three default OFF. A malformed value or an
    already-bound port warns and runs recorder-free (the faults.py env
    posture) — observability must never break ``import mxnet_tpu_torch``;
    child processes inherit the parent's env, so a second process racing
    for the same metrics port is NORMAL, not fatal."""

    def _adopt(what, fn):
        try:
            fn()
        except Exception as e:
            try:
                from . import log as _log
                _log.get_logger("mxnet_tpu_torch.flight").warning(
                    "flight: ignoring %s autostart: %s", what, e)
            except Exception:
                pass

    if flight_dir() is not None:
        _adopt("hook", install)
    if os.environ.get(ENV_INTERVAL):
        _adopt(ENV_INTERVAL, sampler_start)   # <= 0 no-ops inside
    port_env = os.environ.get(ENV_PORT)
    if port_env:
        def _start_port():
            if int(port_env) > 0:
                metrics_http_start()
        _adopt(ENV_PORT, _start_port)
