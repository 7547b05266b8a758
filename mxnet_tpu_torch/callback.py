"""Training callbacks (parity: python/mxnet/callback.py).

Counterpart of ``mxnet_tpu/callback.py`` (``module_checkpoint``,
``do_checkpoint``, ``log_train_metric``, ``Speedometer``,
``TelemetryLogger``, ``ProgressBar``, ``LogValidationMetricsCallback``),
kept as a copy: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "TelemetryLogger", "ProgressBar",
           "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """(parity: callback.module_checkpoint)"""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (parity: callback.do_checkpoint)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/sec every ``frequent`` batches (parity:
    callback.Speedometer). Reading the metric waits for the device."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size \
                    / (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" \
                        % (param.epoch, count, speed)
                    msg += "".join("\t%s=%f" % kv for kv in name_value)
                    logging.info(msg)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class TelemetryLogger:
    """Speedometer-style batch-end callback over the telemetry registry:
    every ``frequent`` batches, log the window's program dispatches per
    batch, program builds vs. cache hits (the JAX package's jit cache;
    always 0/0 in the port), fused-fallback events, host->device bytes,
    blocking host syncs, and the step-span p50/p95/p99 (no reference
    counterpart; the reference had no host-side registry to read)::

        mod.fit(train, batch_end_callback=mx.callback.TelemetryLogger(50))

    ``programs=True`` additionally logs every NEW program card the
    moment it appears in ``telemetry.programs()`` — entry, kind,
    FLOPs and the allocator's peak around its first call — so a new
    input signature mid-training is visible in the training log::

        mod.fit(train, batch_end_callback=mx.callback.TelemetryLogger(
            50, programs=True))

    The same object also understands the SERVING registry: hand it to a
    ``serving.InferenceEngine`` and every ``frequent`` coalesced batches
    it logs queue depth, batch-fill ratio, pad bytes and the request
    p50/p95/p99 latency window (``log_serving``)::

        engine = mx.serving.InferenceEngine(
            sym, params, {"data": (1, 3, 224, 224)},
            telemetry_logger=mx.callback.TelemetryLogger(100))
    """

    def __init__(self, frequent=50, logger=None, programs=False):
        from . import telemetry
        self.frequent = int(max(1, frequent))
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.telemetry")
        self._telemetry = telemetry
        self._last_counters = {}
        self._last_nbatch = None
        self._last_step_total = 0
        self._programs = bool(programs)
        self._seen_programs = set()
        self._last_serving = None
        self._last_serve_total = 0
        self._last_decode = None
        self._last_decode_ts = None
        self._last_decode_total = 0
        self._last_series_ts = None
        self._tag = None

    def _rank_tag(self):
        """``"[r<N>] "`` prefix on every log line of a multi-process
        run — N ranks tail into ONE launcher stream, and an unprefixed
        "step p99 spiked" line is unattributable exactly when it
        matters. Cached: identity is fixed for the process lifetime;
        single-process runs stay untagged."""
        if self._tag is None:
            ident = self._telemetry.process_identity()
            self._tag = ("[r%d] " % ident["rank"]
                         if ident["num_processes"] > 1 else "")
        return self._tag

    def _rebase(self, count):
        self._last_counters = self._telemetry.counters()
        self._last_step_total = self._telemetry.span_count("step")
        self._last_nbatch = count
        self._window_start = count

    def _window(self):
        cur = self._telemetry.counters()
        if any(v < self._last_counters.get(k, 0) for k, v in cur.items()) \
                or any(k not in cur for k in self._last_counters):
            # someone reset() the registry mid-window: the deltas are
            # meaningless — skip this log line and rebase
            self._last_counters = cur
            return None
        delta = {k: v - self._last_counters.get(k, 0)
                 for k, v in cur.items()
                 if v != self._last_counters.get(k, 0)}
        self._last_counters = cur
        return delta

    def _log_new_programs(self):
        """Report cards not seen before (cheap: one registry read per
        callback, and new cards only appear on compiles)."""
        for key, card in self._telemetry.programs().items():
            if key in self._seen_programs:
                continue
            self._seen_programs.add(key)
            flops = card.get("flops")
            peak = card.get("peak_bytes")
            self.logger.info(
                self._rank_tag() +
                "program card %s: kind=%s trace=%.1fms compile=%.1fms "
                "flops=%s peak_hbm=%s donated=%d",
                key, card.get("kind"),
                card.get("trace_ms") or 0.0, card.get("compile_ms") or 0.0,
                "%.4g" % flops if flops else None,
                "%.2fMiB" % (peak / 2.0 ** 20) if peak else None,
                len(card.get("donated") or ()))

    def log_serving(self, force=False):
        """One serving-window log line (queue depth, batch fill, request
        p50/p95/p99): a running ``serving.InferenceEngine`` built with
        ``telemetry_logger=`` calls this after every coalesced batch;
        every ``frequent`` batches one line lands. ``force=True`` (the
        engine's close()) flushes a final partial window. Reads the same
        process-global telemetry registry as the training path — the
        ``serving.*`` counters and ``serve_request`` spans."""
        t = self._telemetry
        cur = t.counters()
        batches = cur.get("serving.batches", 0)
        if self._last_serving is None:
            # first look: establish the window baseline
            self._last_serving = cur
            self._last_serve_total = t.span_count("serve_request")
            if not force:
                return
        last = self._last_serving
        nb = batches - last.get("serving.batches", 0)
        if nb < 0:          # someone reset() the registry mid-window
            self._last_serving = cur
            self._last_serve_total = t.span_count("serve_request")
            return
        if not force and nb < self.frequent:
            return
        if nb == 0 and not force:
            return
        self._last_serving = cur
        delta = {k: v - last.get(k, 0) for k, v in cur.items()
                 if k.startswith("serving.")}
        if self._programs:
            self._log_new_programs()
        rows = delta.get("serving.batch_rows", 0)
        pad = delta.get("serving.pad_rows", 0)
        # admitted-but-unterminated: the ONE shared formula (same
        # depth InferenceEngine.stats() and the flight sampler report)
        depth = t.serving_queue_depth(cur)
        # request-latency percentiles over THIS window's samples only
        durs = t.span_durations("serve_request")
        total = t.span_count("serve_request")
        k = min(max(total - self._last_serve_total, 0), len(durs))
        self._last_serve_total = total
        window = sorted(durs[-k:]) if k else []
        msg = ("serving: batches=%d requests=%d queue_depth=%d"
               % (nb, delta.get("serving.requests", 0), depth))
        if rows + pad:
            msg += "\tbatch_fill=%.2f" % (rows / float(rows + pad))
        if window:
            pct = t._percentile            # the ONE percentile rule
            msg += "\treq p50/p95/p99=%.2f/%.2f/%.2fms" % (
                pct(window, 50) * 1e3, pct(window, 95) * 1e3,
                pct(window, 99) * 1e3)
        pad_b = delta.get("serving.pad_bytes", 0)
        if pad_b:
            msg += "\tpad=%.1fKiB" % (pad_b / 1024.0)
        # overload-control window: shed/retry/breaker events are the
        # degradation signal an operator tails the log for
        shed = delta.get("serving.shed_requests", 0)
        if shed:
            msg += "\tshed=%d" % shed
        retries = delta.get("serving.retries", 0)
        if retries:
            msg += "\tretries=%d" % retries
        trips = delta.get("serving.breaker_trips", 0)
        if trips:
            msg += "\tbreaker_trips=%d" % trips
        self.logger.info(self._rank_tag() + msg)

    def log_decode(self, engine=None, force=False):
        """One decode-window log line (tokens/s, active slots, slot-pool
        fill, per-token p50/p95/p99): a running ``decode.DecodeEngine``
        built with ``telemetry_logger=`` calls this after every decode
        step; every ``frequent`` steps one line lands. ``force=True``
        (the engine's close()) flushes a final partial window. Reads
        the ``decode.*`` counters and ``serve_decode_step`` spans from
        the same process-global registry as everything else; ``engine``
        (when given) contributes the instantaneous slot occupancy."""
        import time as _time
        t = self._telemetry
        cur = t.counters()
        steps = cur.get("decode.steps", 0)
        now = _time.monotonic()
        if self._last_decode is None:
            self._last_decode = cur
            self._last_decode_ts = now
            self._last_decode_total = t.span_count("serve_decode_step")
            if not force:
                return
        last = self._last_decode
        ns = steps - last.get("decode.steps", 0)
        if ns < 0:          # someone reset() the registry mid-window
            self._last_decode = cur
            self._last_decode_ts = now
            self._last_decode_total = t.span_count("serve_decode_step")
            return
        if not force and ns < self.frequent:
            return
        if ns == 0 and not force:
            return
        elapsed = max(now - (self._last_decode_ts or now), 1e-9)
        self._last_decode = cur
        self._last_decode_ts = now
        delta = {k: v - last.get(k, 0) for k, v in cur.items()
                 if k.startswith("decode.")}
        if self._programs:
            self._log_new_programs()
        tokens = delta.get("decode.tokens", 0)
        msg = ("decode: steps=%d tokens=%d tok/s=%.1f"
               % (ns, tokens, tokens / elapsed))
        # mean decode batch over the window = tokens per step; with the
        # engine at hand the INSTANTANEOUS occupancy rides along too
        if ns:
            msg += "\tmean_batch=%.2f" % (tokens / float(ns))
        if engine is not None:
            ov = engine.overload_state()
            slots = ov.get("slots") or 1
            msg += "\tactive_slots=%d/%d fill=%.2f" % (
                ov.get("active_slots", 0), slots,
                ov.get("active_slots", 0) / float(slots))
        # per-token percentiles over THIS window's step spans only
        durs = t.span_durations("serve_decode_step")
        total = t.span_count("serve_decode_step")
        k = min(max(total - self._last_decode_total, 0), len(durs))
        self._last_decode_total = total
        window = sorted(durs[-k:]) if k else []
        if window:
            pct = t._percentile            # the ONE percentile rule
            msg += "\ttok p50/p95/p99=%.2f/%.2f/%.2fms" % (
                pct(window, 50) * 1e3, pct(window, 95) * 1e3,
                pct(window, 99) * 1e3)
        shed = delta.get("decode.shed", 0)
        if shed:
            msg += "\tshed=%d" % shed
        retries = delta.get("decode.retries", 0)
        if retries:
            msg += "\tretries=%d" % retries
        trips = delta.get("decode.breaker_trips", 0)
        if trips:
            msg += "\tbreaker_trips=%d" % trips
        self.logger.info(self._rank_tag() + msg)

    def log_series(self, force=False):
        """One RATE log line from the flight recorder's sampler ring
        (``flight.py``) — req/s, sheds/s, dispatches/s and
        the online MFU over the samples that landed since the last
        call — instead of re-snapshotting the cumulative counters and
        diffing them here: the sampler already banked the deltas on its
        own clock, so this reads (not recomputes) the trajectory.
        Nothing is logged until a new sample lands (``force=True``
        logs whatever the newest sample says). Needs
        ``flight.sampler_start()`` (or ``MXNET_METRICS_INTERVAL_MS``)
        — without a running sampler this is a silent no-op."""
        from . import flight
        samples = flight.series()
        if self._last_series_ts is not None:
            samples = [s for s in samples
                       if s["ts"] > self._last_series_ts]
        if not samples:
            if force and flight.series(1):
                samples = flight.series(1)
            else:
                return
        self._last_series_ts = samples[-1]["ts"]
        dt = sum(s.get("dt_ms", 0.0) for s in samples) / 1e3
        if dt <= 0:
            return

        def rate(key):
            total = sum(s.get("counters", {}).get(key, 0)
                        for s in samples)
            return total / dt

        last = samples[-1]
        msg = ("series: window=%.1fs req/s=%.1f shed/s=%.1f "
               "dispatch/s=%.1f queue_depth=%d"
               % (dt, rate("serving.requests"),
                  rate("serving.shed_requests"),
                  sum(sum(v for k, v in s.get("counters", {}).items()
                          if k.startswith("dispatch."))
                      for s in samples) / dt,
                  last.get("queue_depth", 0)))
        mfu = last.get("mfu")
        if mfu is not None:
            msg += "\tmfu=%.4g" % mfu
        if last.get("serving", {}).get("breaker_open"):
            msg += "\tbreaker=OPEN"
        self.logger.info(self._rank_tag() + msg)

    def __call__(self, param):
        if self._programs:
            self._log_new_programs()
        count = param.nbatch
        if self._last_nbatch is None or count < self._last_nbatch:
            # first call of an epoch (fit fires batch-end at nbatch=0,
            # Speedometer-style): establish the window baseline — a
            # partial first window would misreport every per-batch rate
            self._rebase(count)
            return
        self._last_nbatch = count
        # the window spans everything since the last LOG (or rebase),
        # not since the last callback — skipped callbacks must not
        # shrink the per-batch denominator
        nbatches = count - self._window_start
        if count % self.frequent != 0 or nbatches <= 0:
            return
        self._window_start = count
        delta = self._window()
        if delta is None:
            self._last_step_total = self._telemetry.span_count("step")
            return
        n = float(nbatches)
        dispatches = sum(v for k, v in delta.items()
                         if k.startswith("dispatch."))
        fallbacks = {k[len("fused_fallback."):]: v
                     for k, v in delta.items()
                     if k.startswith("fused_fallback.")}
        # step percentiles over THIS WINDOW's samples only (the
        # cumulative histogram would keep the first batch's compile
        # outlier in p99 forever)
        durs = self._telemetry.span_durations("step")
        total = self._telemetry.span_count("step")
        k = min(max(total - self._last_step_total, 0), len(durs))
        self._last_step_total = total
        window = sorted(durs[-k:]) if k else []
        msg = ("Epoch[%d] Batch [%d]\tdispatches/batch=%.2f"
               % (param.epoch, count, dispatches / n))
        msg += "\tjit compile/hit=%d/%d" % (
            delta.get("jit.compile", 0), delta.get("jit.hit", 0))
        if window:
            pct = self._telemetry._percentile    # the ONE percentile rule
            msg += "\tstep p50/p95/p99=%.2f/%.2f/%.2fms" % (
                pct(window, 50) * 1e3, pct(window, 95) * 1e3,
                pct(window, 99) * 1e3)
        h2d = delta.get("transfer.h2d_bytes", 0)
        if h2d:
            msg += "\th2d=%.1fKiB/batch" % (h2d / 1024.0 / n)
        syncs = delta.get("host_sync.blocking", 0)
        if syncs:
            msg += "\tblocking_syncs=%d" % syncs
        # collective gate wait this window (the distributed slice): the
        # per-rank view of fleet skew — a rank whose gate_wait/batch is high is
        # WAITING on a straggler; the straggler's own is ~0
        gate_ms = sum(v for k, v in delta.items()
                      if k.startswith("heartbeat.gate_wait_ms."))
        if gate_ms:
            msg += "\tgate_wait=%.1fms/batch" % (gate_ms / n)
        if fallbacks:
            msg += "\tfused_fallbacks=%s" % (
                ",".join("%s:%d" % kv for kv in sorted(fallbacks.items())))
        self.logger.info(self._rank_tag() + msg)


class ProgressBar:
    """(parity: callback.ProgressBar)"""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Log eval metrics at the end of each epoch (parity:
    callback.LogValidationMetricsCallback)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
