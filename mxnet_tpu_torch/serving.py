"""Inference serving: bucketed forward programs + a dynamic micro-batcher.

Counterpart of ``mxnet_tpu/serving.py`` (``InferenceEngine``):

* **batch buckets** — powers of two up to ``max_batch`` (``max_batch``
  itself is always a bucket), or an explicit ``buckets=`` set, or the
  autotuner's plan (``autotune=True``: ``tuner.plan_serving`` over the
  program-card corpus, ``compile_cache.corpus_records``). Parameters are
  device-resident once and shared by every bucket; ``warmup()`` runs one
  forward per bucket so cuDNN picks its algorithms before traffic
  arrives, and builds each bucket's program card (those warm-up calls
  count no dispatch, as the JAX package's warm-up compiles without
  executing).
* **a dynamic micro-batcher** — ``submit()`` enqueues a request and
  returns a ``concurrent.futures.Future``; a coalescer thread packs
  pending requests into the smallest covering bucket (zero-padding the
  rest), flushes when the pending rows fill ``max_batch`` or a
  ``max_wait_ms`` deadline expires, launches the forward (asynchronous
  on the card) with up to ``max_inflight`` batches in flight, and a
  resolver pool fetches each padded output (the blocking device-to-host
  copy) and slices it back into per-request results.
* **overload control** — bounded admission (``max_queue_rows`` with
  ``overload="shed"`` failing fast or ``"block"`` applying
  backpressure), request deadlines enforced at admission, coalesce and
  resolution, retry with backoff of transient launch failures, and a
  breaker that fast-fails after ``breaker_threshold`` consecutive
  failures.
* **telemetry** — the ``serving.*`` counters and events of the JAX
  engine, and the ``serve_wait`` / ``serve_batch`` / ``serve_d2h`` /
  ``serve_request`` spans (``telemetry.SERVE_SPANS``) under the causal
  ``req_id`` each ``submit()`` stamps (batch spans carry the member
  ``req_ids``). The ``dispatch`` (executor) and ``d2h`` fault sites
  fire on this path; a terminal batch failure, a breaker trip or a
  dying coalescer dumps a flight-recorder postmortem (inert without
  ``MXNET_FLIGHT_DIR``). ``close()`` banks ``corpus_record()`` into the
  corpus when one is configured.
* ``stats()`` — counters and the request-latency percentiles, computed
  here from every request's submit-to-terminal time.

* **serving meshes** — ``partition_rules=`` (the rule tree training
  uses) and ``mesh_axes=`` lay ``contexts`` (and, in a launched job, the
  same list on every process) out as a ``dp x mp`` mesh
  (``parallel.spmd.MeshParams``). Each member holds its shard of every
  parameter; an op reads a sharded one gathered whole, so a bucket's
  forward on a member sees the one-device forward's tensors, and a
  ``dp`` axis splits each bucket's rows. In one process the members run
  each dispatch together (``Mesh.run_local``). Across processes rank 0
  is the engine's front end: its coalescer broadcasts each dispatch
  (kind and bucket, then the batch) and every other rank, built with the
  same arguments, runs as a follower that computes its member's part of
  each dispatch until rank 0's ``close()`` broadcasts the stop.

Not ported yet: one captured CUDA graph per bucket (item 1).

Every graph output must be batch-major (dim 0 = batch); padded rows are
sliced off before a future resolves. bfloat16 outputs reach the caller
widened (exactly) to float32, since numpy has no bfloat16.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .base import MXNetError, latency_percentiles
from .executor import record_dispatch, DeviceMemoryError
from .ops.common import numpy_dtype
from .predictor import Predictor
from . import telemetry
from . import faults
from . import flight

__all__ = ["InferenceEngine", "bucket_sizes", "validate_buckets",
           "DeadlineExceeded", "QueueOverflow", "CircuitOpen",
           "EngineClosed", "DeviceMemoryError"]

# what a mesh engine's rank 0 broadcasts ahead of each dispatch
_MSG_STOP, _MSG_FORWARD = 0, 1


class DeadlineExceeded(MXNetError):
    """The request's deadline passed before a result could be delivered."""


class QueueOverflow(MXNetError):
    """Admission denied: the bounded queue is full under ``shed``."""


class CircuitOpen(MXNetError):
    """The dispatch breaker is open (too many consecutive failures)."""


class EngineClosed(MXNetError):
    """``submit``/``flush`` after ``close()``."""


def bucket_sizes(max_batch):
    """The power-of-two batch buckets up to ``max_batch`` (inclusive)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise MXNetError("max_batch must be >= 1, got %d" % max_batch)
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def validate_buckets(buckets, max_batch):
    """Normalise a custom bucket set (e.g. an autotuner plan): unique,
    sorted, clamped to [1, max_batch], and always topped by
    ``max_batch`` itself so a full batch never pads and every request
    has a covering bucket."""
    try:
        bs = sorted({int(b) for b in buckets})
    except (TypeError, ValueError):
        raise MXNetError("serving: buckets must be a list of ints, got %r"
                         % (buckets,))
    bs = [b for b in bs if 1 <= b <= max_batch]
    if not bs or bs[-1] != max_batch:
        bs.append(int(max_batch))
    return bs


# process-global request-id source: the CAUSAL id that rides one
# request through submit -> coalesce -> batch dispatch -> d2h -> resolve
_REQ_SEQ = itertools.count(1)


class _Request:
    __slots__ = ("arrays", "rows", "future", "deadline", "req_id", "t0",
                 "wait_span", "req_span")

    def __init__(self, arrays, rows, deadline=None):
        self.arrays = arrays          # {input name: np.ndarray (rows,...)}
        self.rows = rows
        self.deadline = deadline      # monotonic instant, or None
        self.req_id = next(_REQ_SEQ)
        self.t0 = time.perf_counter()
        self.future = Future()
        self.future.req_id = self.req_id
        # entered on the submitting thread, closed on the coalescer /
        # resolver threads: explicit causal ctx (thread-local ids would
        # not follow the request across threads)
        ctx = {"req_id": self.req_id}
        self.wait_span = telemetry.span("serve_wait", ctx=ctx).__enter__()
        self.req_span = telemetry.span("serve_request",
                                       ctx=ctx).__enter__()

    def expired(self, now=None):
        return self.deadline is not None \
            and (now if now is not None else time.monotonic()) > self.deadline


_FLUSH = object()
_SHUTDOWN = object()


def _is_transient(exc):
    """Whether a launch failure is worth retrying: only errors flagged
    ``transient``. Program errors (shape, dtype, out of memory: a
    ``DeviceMemoryError``, since a retry allocates the same bytes) fail
    the same way every time."""
    return bool(getattr(exc, "transient", False))


class InferenceEngine:
    """Dynamic micro-batching over bucketed forward programs.

    symbol, params, input_shapes : as for ``Predictor`` (dim 0 of each
        input shape is the batch; requests carry 1..max_batch rows)
    ctx : Context — the device (default ``gpu(0)``; ``MXNetError`` when
        no CUDA device is present and no ``ctx=cpu()`` was given)
    max_batch, max_wait_ms, max_inflight (default 2, or the autotuner
    plan's), dtype, warmup, predictor, max_queue_rows, deadline_ms,
    overload ("shed"|"block"), retry_budget, retry_backoff_ms,
    breaker_threshold, breaker_reset_s : as in the JAX package's engine.
    telemetry_logger : optional ``callback.TelemetryLogger``; the engine
        calls its ``log_serving()`` after every batch
    buckets : optional explicit batch-bucket list replacing the pow-2
        default (normalised by ``validate_buckets``)
    autotune : derive ``buckets``/``max_inflight`` from the card corpus
        (``tuner.plan_serving``); the pow-2 defaults when the corpus holds
        no serving record for this graph. The plan is stamped onto every
        bucket card (``autotune_plan``) and reported by ``stats()``
    partition_rules : ``parallel.PartitionRules`` (or its list of
        ``(pattern, spec)`` pairs): the parameters commit sharded over
        the serving mesh, one shard a member
    mesh_axes : ordered ``{axis: size}`` laying ``contexts`` out as the
        serving mesh (default ``{"dp": 1, "mp": -1}``); a ``dp`` axis
        above 1 splits each bucket's rows, so every bucket must divide
        by it
    contexts : the mesh's Contexts on this process (default ``[ctx]``);
        a mesh needs ``partition_rules`` or ``mesh_axes``. In a launched
        job whose processes the axes cover, rank 0 serves and every
        other rank's engine follows it (``submit`` raises there)
    """

    def __init__(self, symbol=None, params=None, input_shapes=None,
                 ctx=None, max_batch=32, max_wait_ms=2.0, max_inflight=None,
                 dtype=None, warmup=True, telemetry_logger=None,
                 predictor=None, buckets=None, autotune=False,
                 max_queue_rows=None, deadline_ms=None, overload="shed",
                 retry_budget=2, retry_backoff_ms=5.0,
                 breaker_threshold=5, breaker_reset_s=30.0,
                 partition_rules=None, mesh_axes=None, contexts=None):
        self._mesh_spec = None
        if partition_rules is not None or mesh_axes:
            from .parallel import spmd as _spmd
            self._mesh_spec = _spmd.engine_spec(
                "serving", partition_rules, mesh_axes, contexts, ctx)
            ctx = self._mesh_spec.mesh.devices[0]
        if predictor is None:
            if symbol is None or input_shapes is None:
                raise MXNetError("InferenceEngine needs (symbol, params, "
                                 "input_shapes) or predictor=")
            # a mesh engine's whole parameters stay on the host: each
            # member takes its shard from there
            from .context import cpu
            predictor = Predictor(symbol, params or {}, input_shapes,
                                  ctx=cpu() if self._mesh_spec is not None
                                  else ctx, dtype=dtype)
        self._predictor = predictor
        ex = predictor._executor
        self._prog = ex._prog
        self._symbol = predictor._symbol
        self._ctx = ex._ctx if self._mesh_spec is None else ctx
        self._device = self._ctx.torch_device()
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._autotune_plan = None
        if autotune and buckets is None:
            plan = self._load_plan()
            if plan and plan.get("buckets"):
                self._autotune_plan = plan
                buckets = plan["buckets"]
                if max_inflight is None and plan.get("max_inflight"):
                    max_inflight = plan["max_inflight"]
        self._max_inflight = max(1, int(max_inflight or 2))
        self.buckets = bucket_sizes(self.max_batch) if buckets is None \
            else validate_buckets(buckets, self.max_batch)
        self._input_names = list(predictor._input_names)
        self._row_shapes = {n: tuple(predictor._input_shapes[n][1:])
                            for n in self._input_names}
        self._in_dtypes = {n: ex.arg_dict[n]._data.dtype
                           for n in self._input_names}
        self._host_dtypes = {n: numpy_dtype(t)
                             for n, t in self._in_dtypes.items()}
        auto = set(predictor._auto_args)
        # params/aux stay device-resident across ALL buckets (shared)
        self._param_raw = {n: a._data for n, a in ex.arg_dict.items()
                           if n not in self._input_names and n not in auto}
        self._aux_raw = {n: a._data for n, a in ex.aux_dict.items()}
        self._param_shapes = {n: tuple(r.shape) for n, r in
                              self._param_raw.items()}
        self._auto_names = sorted(auto)
        self._extras_lock = threading.Lock()
        self._extras = {}                # guarded by: self._extras_lock
        self._follower = False
        if self._mesh_spec is None:
            self._forward = self._prog.forward_fn()
        else:
            self._init_members()

        if overload not in ("shed", "block"):
            raise MXNetError("serving: overload must be 'shed' or "
                             "'block', got %r" % (overload,))
        self.max_queue_rows = None if max_queue_rows is None \
            else max(1, int(max_queue_rows))
        self.deadline_s = None if deadline_ms is None \
            else float(deadline_ms) / 1e3
        self.overload = overload
        self._retry_budget = max(0, int(retry_budget))
        self._retry_backoff_s = max(0.0, float(retry_backoff_ms)) / 1e3
        self._breaker_threshold = max(0, int(breaker_threshold))
        self._breaker_reset_s = float(breaker_reset_s)
        self._breaker_open_at = None     # guarded by: self._lock
        self._breaker_probing = False    # guarded by: self._lock
        self._consecutive_failures = 0   # guarded by: self._lock
        self._queued_rows = 0            # guarded by: self._lock

        self._logger = telemetry_logger
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._stats = collections.Counter()            # guarded by: self._lock
        self._bucket_batches = collections.Counter()   # guarded by: self._lock
        # the measured serving data the card corpus persists for the
        # autotuner: coalesced-batch row counts (pre-padding) and
        # dispatch->resolution wall-time per bucket
        self._rows_hist = collections.Counter()        # guarded by: self._lock
        self._bucket_lat = {}                          # guarded by: self._lock
        self._latencies = collections.deque(maxlen=100000)  # guarded by: self._lock
        self._q = queue.Queue()
        self._inflight = threading.Semaphore(self._max_inflight)
        self._closed = False             # guarded by: self._lock
        self._close_done = False         # guarded by: self._lock
        self._pool = ThreadPoolExecutor(max_workers=self._max_inflight,
                                        thread_name_prefix="mx-serve-resolve")
        self._thread = threading.Thread(
            target=self._follow if self._follower else self._coalesce_loop,
            name="mx-serve-follow" if self._follower else "mx-serve-coalesce",
            daemon=True)
        self._thread.start()
        # the flight recorder's sampler/postmortems read this engine's
        # queue/breaker state (weakly held — close() is not required)
        flight.register_engine(self)
        if warmup:
            self.warmup()

    def partition_summary(self):
        """JSON-safe layout of the serving mesh (None without one): what
        the autotuner plan, the corpus record and the bucket program
        cards record."""
        if self._mesh_spec is None:
            return None
        from .parallel.partition import partition_summary as _summary
        return _summary(self._mesh_spec, self._param_shapes)

    # -- the serving mesh ---------------------------------------------------
    def _init_members(self):
        """Commit every member's shards of the parameters and aux states
        (charged to the ledger under the mesh key), check the buckets
        against the ``dp`` axis, and wire the mesh forward: a follower's
        loop on the ranks after the first of a launched job."""
        from .executor import _GraphProgram
        from .parallel import spmd as _spmd
        spec = self._mesh_spec
        mesh = spec.mesh
        bad = [b for b in self.buckets if b % spec.dp_size]
        if bad:
            raise MXNetError("serving: bucket size(s) %s not divisible by "
                             "the %r mesh axis (size %d)"
                             % (bad, spec.data_axis, spec.dp_size))
        shapes = dict(self._param_shapes)
        shapes.update({n: tuple(r.shape) for n, r in self._aux_raw.items()})
        layout = self._layout = _spmd.MeshParams(spec, shapes)
        prog = _GraphProgram(self._symbol)
        prog.layout = layout
        whole = (self._param_raw, self._aux_raw)

        def commit(j):
            layout.groups()
            dev = mesh.devices[j].torch_device()
            held = [{n: layout.shard(n, r, dev) for n, r in part.items()}
                    for part in whole]
            for part in held:
                for t in part.values():
                    layout.track(t)
            return {"params": held[0], "aux": held[1], "device": dev}
        self._members = _spmd.run_members(mesh, commit)
        # this process's first member stands for the mesh where the
        # one-device engine keeps its whole tensors
        self._param_raw = self._members[0]["params"]
        self._aux_raw = self._members[0]["aux"]
        self._member_forward = prog.forward_fn()
        self._spanning = mesh.processes > 1
        self._follower = self._spanning and mesh.rank != 0
        self._follow_error = None
        self._mesh_lock = threading.Lock()
        self._forward = prog._instrumented(
            "forward", ("mesh",), self._mesh_forward, ("args", "aux"))

    def _mesh_forward(self, args, aux):
        """One dispatch on the mesh (rank 0, or the only process): every
        member's forward of its rows; returns member 0's outputs, every
        row of the bucket, and no aux updates."""
        from .parallel import collectives as C
        batch = {n: args[n] for n in self._input_names}
        bucket = int(batch[self._input_names[0]].shape[0])
        with self._mesh_lock:
            if self._spanning:
                C.broadcast(torch.tensor([_MSG_FORWARD, bucket]))
                batch = {n: C.broadcast(b.contiguous())
                         for n, b in batch.items()}
            return self._run_members(batch, bucket), {}

    def _run_members(self, batch, bucket):
        """Each local member's forward of its rows of the host ``batch``
        (its shards gathered op by op), the outputs gathered over the
        ``dp`` axis; member 0's outputs."""
        from .parallel import spmd as _spmd
        layout = self._layout
        rows = bucket // self._mesh_spec.dp_size

        def member(j):
            m = self._members[j]
            args = dict(m["params"])
            for n in self._input_names:
                args[n] = layout.rows(batch[n]).to(m["device"])
            args.update(self._extras_for(rows, m["device"]))
            outs, _ = self._member_forward(args, m["aux"])
            return [layout.gather_rows(o) for o in outs]
        return _spmd.run_members(self._mesh_spec.mesh, member)[0]

    def _follow(self):
        """A follower's loop: every dispatch rank 0 broadcasts, until its
        stop (a failure is raised by ``close()``)."""
        from .parallel import collectives as C
        try:
            while True:
                kind, bucket = C.broadcast(torch.zeros(2, dtype=torch.int64))
                if int(kind) == _MSG_STOP:
                    return
                bucket = int(bucket)
                batch = {n: C.broadcast(torch.zeros(
                    (bucket,) + self._row_shapes[n],
                    dtype=self._in_dtypes[n])) for n in self._input_names}
                self._run_members(batch, bucket)
        except BaseException as e:          # noqa: BLE001 -- close() raises
            self._follow_error = e

    def _mesh_stop(self):
        """Rank 0: release the followers (their ``close()`` returns)."""
        from .parallel import collectives as C
        with self._mesh_lock:
            C.broadcast(torch.tensor([_MSG_STOP, 0]))

    def _not_follower(self, what):
        if self._follower:
            raise MXNetError(
                "serving: %s on rank %d, which follows the engine of rank 0 "
                "(a mesh across processes takes requests on rank 0 only)"
                % (what, self._mesh_spec.mesh.rank))

    def _load_plan(self):
        """The autotuner plan for this engine's ``max_batch`` from the
        card corpus, filtered to THIS graph's fingerprint, or None (no
        corpus / no serving records / tuner failure — autotune must
        never break construction)."""
        try:
            from . import compile_cache
            from .tuner import plan_serving
            records = compile_cache.corpus_records(kind="serving")
            return plan_serving(records, max_batch=self.max_batch,
                                graph=self._prog.graph_fingerprint(),
                                layout=self.partition_summary())
        except Exception as e:
            from . import log as _log
            _log.get_logger("mxnet_tpu_torch.serving").warning(
                "serving: autotune plan unavailable (%s); using pow-2 "
                "bucket defaults", e)
            return None

    # -- device staging -----------------------------------------------------
    def _put_batch(self, buf, name):
        """One input of a bucket on the device; on a mesh, on the host
        (each member moves its rows to its device)."""
        dev = self._device if self._mesh_spec is None else "cpu"
        return torch.from_numpy(buf).to(dev, self._in_dtypes[name])

    def warmup(self):
        """One forward per bucket, synchronised: cuDNN settles its
        algorithm choice for every bucket shape before traffic, and each
        bucket's program card is built (``_forward.build``: no dispatch
        counted). An autotuned engine stamps its plan on every card."""
        if self._follower:
            return              # rank 0's warmup reaches this rank's members
        for b in self.buckets:
            args = dict(self._param_raw)
            for n in self._input_names:
                args[n] = self._put_batch(
                    np.zeros((b,) + self._row_shapes[n],
                             self._host_dtypes[n]), n)
            args.update(self._bucket_extras(b))
            outs, _ = self._forward.build(args, self._aux_raw)
            for o in outs:
                o.cpu()
        if self._autotune_plan is not None:
            for cid in self.program_cards():
                telemetry.card_annotate(cid,
                                        autotune_plan=self._autotune_plan)
        layout = self.partition_summary()
        if layout is not None:
            for cid in self.program_cards():
                telemetry.card_annotate(cid, partition=layout)

    def _bucket_extras(self, bucket):
        """Device-resident zero dummies (softmax labels etc.) at this
        bucket's batch size, cached per bucket; none on a mesh, whose
        members make their own at their rows."""
        if self._mesh_spec is not None:
            return {}
        return self._extras_for(bucket, self._device)

    def _extras_for(self, rows, device):
        """The zero dummies at ``rows`` rows on ``device``, cached."""
        key = (rows, str(device))
        with self._extras_lock:
            cached = self._extras.get(key)
            if cached is not None:
                return cached
            extras = {}
            if self._auto_names:
                known = {n: (rows,) + self._row_shapes[n]
                         for n in self._input_names}
                known.update(self._param_shapes)
                shapes, _, _ = self._symbol.infer_shape_partial(**known)
                inferred = dict(zip(self._symbol.list_arguments(), shapes))
                ex = self._predictor._executor
                for n in self._auto_names:
                    if inferred.get(n) is None:
                        raise MXNetError("serving: cannot infer dummy shape "
                                         "for %r at bucket %d" % (n, rows))
                    extras[n] = torch.zeros(inferred[n],
                                            dtype=ex.arg_dict[n]._data.dtype,
                                            device=device)
            self._extras[key] = extras
            return extras

    def bucket_for(self, rows):
        """Smallest bucket covering ``rows``."""
        for b in self.buckets:
            if b >= rows:
                return b
        raise MXNetError("serving: %d rows exceed max_batch=%d"
                         % (rows, self.max_batch))

    def program_cards(self):
        """{card_id: card} for THIS engine's forward programs — one card
        per (bucket, dtype) signature."""
        entry = self._forward.entry
        return {k: c for k, c in telemetry.programs().items()
                if k == entry or k.startswith(entry + "/")}

    # -- request surface ----------------------------------------------------
    def _record_latency_locked(self, req):
        self._latencies.append((time.perf_counter() - req.t0) * 1e3)

    def _shed(self, req, cause, exc):
        """Resolve one request's future with a structured shed error and
        account it by cause (engine stats + telemetry). The wait/request
        spans still close — shed time is real queue time."""
        if req.future.done():
            return
        req.wait_span.__exit__(None, None, None)
        req.req_span.__exit__(None, None, None)
        req.future.set_exception(exc)
        with self._lock:
            self._record_latency_locked(req)
            self._stats["shed_requests"] += 1
            self._stats["shed_rows"] += req.rows
            self._stats["shed.%s" % cause] += 1
        telemetry.counter_inc("serving.shed_requests")
        telemetry.counter_inc("serving.shed_rows", req.rows)
        telemetry.counter_inc("serving.shed.%s" % cause)
        telemetry.record_event("serving.shed", req_id=req.req_id,
                               cause=cause, rows=req.rows)
        if isinstance(exc, DeadlineExceeded):
            telemetry.counter_inc("serving.deadline_exceeded")

    def submit(self, *args, deadline_ms=None, **kwargs):
        """Enqueue one request; returns a Future resolving to the list of
        per-output numpy arrays (each ``(rows, ...)``). Inputs go by name
        (``submit(data=x)``); a single-input graph also takes one
        positional array. Each input is ``(rows,) + row_shape`` with
        1 <= rows <= max_batch (a bare row means rows=1)."""
        self._not_follower("submit")
        if self._closed:
            raise EngineClosed("serving: engine is closed")
        if self._breaker_tripped():
            with self._lock:
                self._stats["breaker_fastfail"] += 1
                consecutive = self._consecutive_failures
            telemetry.counter_inc("serving.breaker_fastfail")
            raise CircuitOpen(
                "serving: breaker open after %d consecutive dispatch "
                "failures — fast-failing (retries again %.1fs after the "
                "trip)" % (consecutive, self._breaker_reset_s))
        if args:
            if len(args) != 1 or kwargs or len(self._input_names) != 1:
                raise MXNetError("serving: pass inputs by name "
                                 "(submit(name=array))")
            kwargs = {self._input_names[0]: args[0]}
        if set(kwargs) != set(self._input_names):
            raise MXNetError("serving: inputs %s do not match engine "
                             "inputs %s" % (sorted(kwargs),
                                            sorted(self._input_names)))
        arrays, rows = {}, None
        for n, v in kwargs.items():
            a = np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
            want = self._row_shapes[n]
            if a.shape == want:
                a = a[None]
            if a.ndim != len(want) + 1 or tuple(a.shape[1:]) != want:
                raise MXNetError("serving: input %r shape %s != (rows,)+%s"
                                 % (n, a.shape, want))
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise MXNetError("serving: inputs disagree on rows")
            arrays[n] = np.ascontiguousarray(
                a.astype(self._host_dtypes[n], copy=False))
        if not rows:
            raise MXNetError("serving: empty request")
        if rows > self.max_batch:
            raise MXNetError("serving: request rows %d exceed max_batch %d"
                             % (rows, self.max_batch))
        dl_s = self.deadline_s if deadline_ms is None \
            else float(deadline_ms) / 1e3
        deadline = None if dl_s is None else time.monotonic() + dl_s
        req = _Request(arrays, rows, deadline=deadline)

        def _drop_locked(exc, shed=False, deadline_hit=False):
            # an admission-rejected request never enters the queue, but
            # its spans were entered at _Request construction: close
            # them (the rejection time is a real latency sample) and
            # account the shed
            req.wait_span.__exit__(None, None, None)
            req.req_span.__exit__(None, None, None)
            self._record_latency_locked(req)
            if shed:
                self._stats["shed_requests"] += 1
                self._stats["shed_rows"] += rows
                self._stats["shed.admission"] += 1
                telemetry.counter_inc("serving.shed_requests")
                telemetry.counter_inc("serving.shed_rows", rows)
                telemetry.counter_inc("serving.shed.admission")
                telemetry.record_event("serving.shed", req_id=req.req_id,
                                       cause="admission", rows=rows)
                if deadline_hit:
                    telemetry.counter_inc("serving.deadline_exceeded")
            raise exc

        with self._space:
            if self._closed:
                _drop_locked(EngineClosed("serving: engine is closed"))
            while self.max_queue_rows is not None \
                    and self._queued_rows + rows > self.max_queue_rows:
                if self.overload == "shed":
                    _drop_locked(QueueOverflow(
                        "serving: admission queue full (%d rows waiting, "
                        "max_queue_rows=%d) — shedding"
                        % (self._queued_rows, self.max_queue_rows)),
                        shed=True)
                timeout = None if deadline is None \
                    else deadline - time.monotonic()
                if timeout is not None and timeout <= 0 \
                        or not self._space.wait(timeout):
                    _drop_locked(DeadlineExceeded(
                        "serving: deadline expired while blocked on a full "
                        "admission queue (max_queue_rows=%d)"
                        % self.max_queue_rows), shed=True,
                        deadline_hit=True)
                if self._closed:
                    _drop_locked(EngineClosed("serving: engine is closed"))
            self._stats["requests"] += 1
            self._stats["rows"] += rows
            self._queued_rows += rows
            self._q.put(req)
        telemetry.counter_inc("serving.requests")
        telemetry.counter_inc("serving.rows", rows)
        return req.future

    def predict(self, *args, **kwargs):
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(*args, **kwargs).result()

    def flush(self):
        """Dispatch whatever is pending now instead of waiting out the
        deadline."""
        self._not_follower("flush")
        with self._lock:
            if self._closed:
                raise EngineClosed("serving: engine is closed")
            self._q.put(_FLUSH)

    def stats(self):
        """Engine counters and request-latency percentiles."""
        with self._lock:
            st = dict(self._stats)
            rows_hist = {str(k): v for k, v in sorted(self._rows_hist.items())}
            bucket_ms = {str(b): {"count": c,
                                  "total_ms": round(t * 1e3, 3),
                                  "mean_ms": round(t / c * 1e3, 3)}
                         for b, (t, c) in sorted(self._bucket_lat.items())
                         if c}
            buckets = {str(k): v for k, v in
                       sorted(self._bucket_batches.items())}
            lat = np.asarray(self._latencies, dtype=np.float64)
            queued_rows = self._queued_rows
            breaker_open = self._breaker_tripped()
            consecutive = self._consecutive_failures
        rows = st.get("batch_rows", 0)
        pad = st.get("pad_rows", 0)
        done = st.get("resolved", 0) + st.get("shed_requests", 0) \
            + st.get("failed_requests", 0) - st.get("shed.admission", 0)
        return {
            "process": telemetry.process_identity(),
            "requests": st.get("requests", 0),
            "resolved": st.get("resolved", 0),
            "failed_requests": st.get("failed_requests", 0),
            "queue_depth": st.get("requests", 0) - done,
            "batches": st.get("batches", 0),
            "rows": st.get("rows", 0),
            "pad_rows": pad,
            "pad_bytes": st.get("pad_bytes", 0),
            "batch_fill": round(rows / (rows + pad), 4) if rows + pad
            else None,
            "queued_rows": queued_rows,
            "max_queue_rows": self.max_queue_rows,
            "deadline_ms": None if self.deadline_s is None
            else round(self.deadline_s * 1e3, 3),
            "overload": self.overload,
            "shed_requests": st.get("shed_requests", 0),
            "shed_rows": st.get("shed_rows", 0),
            "shed_by_cause": {k[len("shed."):]: v for k, v in st.items()
                              if k.startswith("shed.")},
            "retries": st.get("retries", 0),
            "dispatch_failures": st.get("dispatch_failures", 0),
            "breaker": {
                "open": breaker_open,
                "threshold": self._breaker_threshold,
                "consecutive_failures": consecutive,
                "trips": st.get("breaker_trips", 0),
                "fastfail": st.get("breaker_fastfail", 0),
            },
            "buckets": buckets,
            "rows_hist": rows_hist,
            "bucket_ms": bucket_ms,
            "max_inflight": self._max_inflight,
            "autotune_plan": self._autotune_plan,
            "device_bytes": self.device_bytes(),
            "latency_ms": latency_percentiles(lat),
        }

    def device_bytes(self):
        """Live device bytes the buffer ledger charges to this engine's
        context, split by ledger kind (``{"context", "total",
        "by_kind"}``): the figure capacity planning and OOM postmortems
        read. Reads host-side counters only. A mesh engine reads the
        mesh's key, where its members charge their shards."""
        key = str(self._ctx) if self._mesh_spec is None \
            else self._layout.ledger_key
        led = telemetry.ledger().get(key, {})
        return {"context": key,
                "total": int(led.get("alive_bytes", 0)),
                "by_kind": {k: int(v) for k, v in
                            led.get("by_kind", {}).items()}}

    def overload_state(self):
        """Light lock-held view of the queue/breaker state — what the
        flight recorder's sampler reads every tick and a postmortem
        embeds."""
        with self._lock:
            return {
                "queued_rows": self._queued_rows,
                "max_queue_rows": self.max_queue_rows,
                "breaker_open": self._breaker_tripped(),
                "consecutive_failures": self._consecutive_failures,
                "closed": self._closed,
                "max_inflight": self._max_inflight,
            }

    def corpus_record(self):
        """One JSON-safe record of this engine's measured serving data
        for the card corpus — what ``tuner.plan_serving`` turns into the
        next engine's bucket plan. None until a batch has dispatched."""
        from . import compile_cache
        st = self.stats()
        if not st["batches"]:
            return None
        cards = {
            k: {kk: c.get(kk) for kk in
                ("kind", "flops", "bytes_accessed", "peak_bytes",
                 "compile_ms", "deserialize_ms", "source", "dispatches")}
            for k, c in self.program_cards().items()}
        spans = {k: v for k, v in telemetry.span_stats().items()
                 if k in telemetry.SERVE_SPANS}
        return {
            "kind": "serving",
            "ts": time.time(),
            "env": compile_cache.env_meta(),
            "graph": self._prog.graph_fingerprint(),
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "layout": self.partition_summary(),
            "max_inflight": self._max_inflight,
            "max_wait_ms": round(self.max_wait_s * 1e3, 3),
            "requests": st["requests"],
            "batches": st["batches"],
            "batch_rows": st["rows"],
            "pad_rows": st["pad_rows"],
            "batch_fill": st["batch_fill"],
            "rows_hist": st["rows_hist"],
            "bucket_ms": st["bucket_ms"],
            "spans": spans,
            "cards": cards,
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self):
        """Drain and stop: already-submitted requests all resolve before
        close() returns; later ``submit``/``flush`` calls raise
        ``EngineClosed``. Rank 0 of a mesh across processes then releases
        the followers; a follower's ``close()`` returns once that stop
        arrives (raising what failed its loop)."""
        if self._follower:
            with self._space:
                already, self._close_done = self._close_done, True
                self._closed = True
            if not already:
                self._thread.join()
                self._pool.shutdown(wait=True)
                if self._follow_error is not None:
                    raise MXNetError("serving: this follower's loop failed "
                                     "(%s: %s)" % (
                                         type(self._follow_error).__name__,
                                         self._follow_error))
            return
        with self._space:
            already = self._close_done
            self._close_done = True
            if not self._closed:
                self._closed = True
                self._q.put(_SHUTDOWN)
                self._space.notify_all()
        if already:
            return
        self._thread.join()
        self._pool.shutdown(wait=True)
        if self._mesh_spec is not None and self._spanning:
            self._mesh_stop()
        # bank this engine's measured serving data into the card corpus
        # (when one is configured) for the next engine's autotuner —
        # telemetry, never state: a failure must not fail the shutdown
        try:
            from . import compile_cache
            if compile_cache.corpus_path() is not None:
                rec = self.corpus_record()
                if rec is not None:
                    compile_cache.corpus_append(rec)
        except Exception:
            pass
        if self._logger is not None:
            try:
                self._logger.log_serving(force=True)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- coalescer ----------------------------------------------------------
    def _launch(self, batch):
        """Release a coalesced batch from the admission queue, shed the
        members whose deadline passed while they waited, and dispatch the
        rest. On an unexpected raise the released rows are re-charged
        before propagating, so the coalescer's cleanup stays exact."""
        with self._space:
            self._queued_rows -= sum(r.rows for r in batch)
            self._space.notify_all()
        try:
            now = time.monotonic()
            live = []
            for r in batch:
                if r.expired(now):
                    self._shed(r, "coalesce", DeadlineExceeded(
                        "serving: request deadline expired in queue "
                        "(waited %.1fms past it)" % ((now - r.deadline) * 1e3)))
                else:
                    live.append(r)
            if live:
                self._dispatch(live)
        except BaseException:
            with self._space:
                self._queued_rows += sum(r.rows for r in batch)
            raise

    def _coalesce_loop(self):
        pending, pending_rows = [], 0
        deadline = None

        def dispatch():
            nonlocal pending, pending_rows, deadline
            if pending:
                batch, pending = pending, []
                pending_rows = 0
                deadline = None
                try:
                    self._launch(batch)
                except BaseException:
                    pending = batch + pending
                    raise

        try:
            while True:
                if pending:
                    try:
                        item = self._q.get(
                            timeout=max(0.0, deadline - time.monotonic()))
                    except queue.Empty:
                        dispatch()    # deadline flush under trickle load
                        continue
                else:
                    item = self._q.get()
                if item is _SHUTDOWN:
                    dispatch()
                    self._drain_after_shutdown()
                    break
                if item is _FLUSH:
                    dispatch()
                    continue
                if pending_rows + item.rows > self.max_batch:
                    try:
                        dispatch()    # the new request doesn't fit
                    except BaseException:
                        pending.append(item)
                        raise
                pending.append(item)
                pending_rows += item.rows
                if deadline is None:
                    deadline = time.monotonic() + self.max_wait_s
                if pending_rows >= self.max_batch:
                    dispatch()
        except BaseException as e:
            # the coalescer is the only consumer of the queue: if it dies,
            # fail every queued/pending future and close the engine
            self._coalescer_died(pending, e)
            raise

    def _coalescer_died(self, pending, exc):
        with self._space:
            self._closed = True
            self._space.notify_all()
        left = list(pending)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN and item is not _FLUSH:
                left.append(item)
        with self._space:
            self._queued_rows -= sum(r.rows for r in left)
            self._space.notify_all()
        err = MXNetError("serving: coalescer thread died (%s: %s) — the "
                         "engine is closed and this request was never "
                         "dispatched" % (type(exc).__name__, exc))
        for r in left:
            self._shed(r, "coalescer_death", err)
        flight.postmortem("coalescer_death", exc=exc,
                          extra={"engine": self.overload_state(),
                                 "failed_requests": len(left)})

    def _drain_after_shutdown(self):
        """Backstop: dispatch anything enqueued behind the sentinel."""
        left = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN and item is not _FLUSH:
                left.append(item)
        while left:
            batch, rows = [], 0
            while left and rows + left[0].rows <= self.max_batch:
                r = left.pop(0)
                batch.append(r)
                rows += r.rows
            try:
                self._launch(batch)
            except BaseException:
                for r in batch + left:
                    self._q.put(r)
                raise

    # -- breaker ------------------------------------------------------------
    def _breaker_tripped(self):
        """True while the breaker is open and still cooling."""
        opened = self._breaker_open_at
        if opened is None:
            return False
        return (time.monotonic() - opened) < self._breaker_reset_s

    def reset_breaker(self):
        """Force the breaker closed (operator override)."""
        with self._lock:
            self._breaker_open_at = None
            self._breaker_probing = False
            self._consecutive_failures = 0

    def _fail_requests(self, reqs, exc):
        failed = 0
        for r in reqs:
            if not r.future.done():
                # the spans entered at admission close on EVERY terminal
                # path (exiting one twice records it once)
                r.wait_span.__exit__(None, None, None)
                r.req_span.__exit__(None, None, None)
                r.future.set_exception(exc)
                with self._lock:
                    self._record_latency_locked(r)
                failed += 1
        if failed:
            with self._lock:
                self._stats["failed_requests"] += failed
            telemetry.counter_inc("serving.failed_requests", failed)

    def _dispatch_failed(self):
        """One coalesced batch's pipeline failed for good (at launch or at
        the resolution fetch): bump the consecutive count and trip the
        breaker at the threshold — a flight-recorder moment."""
        with self._lock:
            self._stats["dispatch_failures"] += 1
            self._consecutive_failures += 1
            self._breaker_probing = False
            consecutive = self._consecutive_failures
            trip = (self._breaker_threshold > 0
                    and consecutive >= self._breaker_threshold)
            if trip:
                self._breaker_open_at = time.monotonic()
                self._stats["breaker_trips"] += 1
        telemetry.counter_inc("serving.dispatch_failures")
        if trip:
            telemetry.counter_inc("serving.breaker_trips")
            telemetry.record_event("serving.breaker_trip",
                                   consecutive=consecutive)
            flight.postmortem("breaker_trip",
                              extra={"engine": self.overload_state(),
                                     "consecutive": consecutive})

    def _dispatch_succeeded(self):
        with self._lock:
            self._consecutive_failures = 0
            self._breaker_open_at = None
            self._breaker_probing = False

    def _dispatch(self, reqs):
        """Pack ``reqs`` into the smallest covering bucket, launch the
        bucket's forward (with the transient-failure retry budget), and
        hand resolution to the pool. With the breaker open the batch
        fast-fails, except the one half-open trial per cooldown."""
        with self._lock:
            opened = self._breaker_open_at
            fastfail = False
            if opened is not None:
                cooling = (time.monotonic() - opened) < self._breaker_reset_s
                if cooling or self._breaker_probing:
                    fastfail = True
                else:
                    self._breaker_probing = True    # the half-open trial
        if fastfail:
            with self._lock:
                self._stats["breaker_fastfail"] += len(reqs)
            telemetry.counter_inc("serving.breaker_fastfail", len(reqs))
            exc = CircuitOpen("serving: breaker open — dispatch suppressed")
            for r in reqs:
                self._shed(r, "breaker", exc)
            return
        # the batch's member ids: the serve_batch/serve_d2h spans carry
        # them and a terminal failure's postmortem names them
        ids = [r.req_id for r in reqs]
        bucket = None
        self._inflight.acquire()
        try:
            rows = sum(r.rows for r in reqs)
            bucket = self.bucket_for(rows)
            for r in reqs:
                r.wait_span.__exit__(None, None, None)
            args = dict(self._param_raw)
            pad_bytes = 0
            for n in self._input_names:
                buf = np.zeros((bucket,) + self._row_shapes[n],
                               self._host_dtypes[n])
                off = 0
                for r in reqs:
                    buf[off:off + r.rows] = r.arrays[n]
                    off += r.rows
                pad_bytes += (bucket - rows) * int(np.prod(
                    self._row_shapes[n], dtype=np.int64)) \
                    * self._in_dtypes[n].itemsize
                telemetry.record_transfer(buf.nbytes)
                args[n] = self._put_batch(buf, n)
            args.update(self._bucket_extras(bucket))
            attempt = 0
            while True:
                try:
                    record_dispatch("serve")
                    with telemetry.span("serve_batch",
                                        ctx={"req_ids": ids}):
                        outs, _ = self._forward(args, self._aux_raw)
                    break
                except Exception as e:
                    if attempt >= self._retry_budget or not _is_transient(e):
                        raise
                    attempt += 1
                    with self._lock:
                        self._stats["retries"] += 1
                    telemetry.counter_inc("serving.retries")
                    time.sleep(self._retry_backoff_s * (2 ** (attempt - 1)))
            with self._lock:
                self._stats["batches"] += 1
                self._stats["batch_rows"] += rows
                self._stats["pad_rows"] += bucket - rows
                self._stats["pad_bytes"] += pad_bytes
                self._bucket_batches[bucket] += 1
                self._rows_hist[rows] += 1
            telemetry.counter_inc("serving.batches")
            telemetry.counter_inc("serving.batch_rows", rows)
            telemetry.counter_inc("serving.pad_rows", bucket - rows)
            telemetry.counter_inc("serving.pad_bytes", pad_bytes)
            telemetry.record_event("serving.batch", req_ids=ids,
                                   bucket=bucket, rows=rows,
                                   pad_rows=bucket - rows)
            self._pool.submit(self._resolve, outs, reqs, bucket,
                              time.perf_counter())
        except BaseException as e:
            self._inflight.release()
            self._dispatch_failed()
            self._fail_requests(reqs, e)
            telemetry.record_event("serving.batch_failed", req_ids=ids,
                                   bucket=bucket, error=type(e).__name__)
            flight.postmortem("serving_dispatch_failure", exc=e,
                              extra={"req_ids": ids, "bucket": bucket,
                                     "engine": self.overload_state()})
        else:
            if self._logger is not None:
                try:
                    self._logger.log_serving()
                except Exception:
                    pass

    def _resolve(self, outs, reqs, bucket, t_disp):
        """Resolver-pool worker: blocking device-to-host fetch of the whole
        padded batch, then each request's rows — or ``DeadlineExceeded``
        when the result arrived past the request's deadline. The ``d2h``
        fault site fires first: a raise is a failed fetch, ``nan``
        corrupts the host copy."""
        try:
            act = faults.fire("d2h") if faults.active() else None
            with telemetry.span("serve_d2h",
                                ctx={"req_ids": [r.req_id for r in reqs]}):
                host = [(o.float() if o.dtype == torch.bfloat16 else o)
                        .cpu().numpy() for o in outs]
            if act == "nan":
                host = faults.poison(host)
            # the fetch landing is the real success signal (a dead
            # device surfaces here, not at launch)
            self._dispatch_succeeded()
            dt = time.perf_counter() - t_disp
            with self._lock:
                lat = self._bucket_lat.setdefault(bucket, [0.0, 0])
                lat[0] += dt
                lat[1] += 1
            now = time.monotonic()
            off = 0
            for r in reqs:
                sl = [h[off:off + r.rows] for h in host]
                off += r.rows
                if r.expired(now):
                    self._shed(r, "resolve", DeadlineExceeded(
                        "serving: result arrived %.1fms past the request "
                        "deadline" % ((now - r.deadline) * 1e3)))
                    continue
                r.req_span.__exit__(None, None, None)
                with self._lock:
                    self._record_latency_locked(r)
                    self._stats["resolved"] += 1
                telemetry.counter_inc("serving.resolved")
                r.future.set_result(sl)
        except BaseException as e:
            self._dispatch_failed()
            self._fail_requests(reqs, e)
            ids = [r.req_id for r in reqs]
            telemetry.record_event("serving.batch_failed", req_ids=ids,
                                   bucket=bucket, error=type(e).__name__)
            flight.postmortem("serving_dispatch_failure", exc=e,
                              extra={"req_ids": ids, "bucket": bucket,
                                     "engine": self.overload_state()})
        finally:
            self._inflight.release()
