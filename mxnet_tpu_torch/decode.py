"""Slot-based continuous batching for autoregressive decode.

Counterpart of ``mxnet_tpu/decode.py``. ``DecodeEngine`` runs a fixed
pool of S SLOTS. Each slot holds one live sequence's state inside a
cache dict whose leaves are slot-major ``(S, ...)`` tensors on the
device. Sequences are admitted and retired PER STEP (continuous
batching): a finishing sequence frees its slot at the step boundary and
a queued prompt takes it immediately, so the decode batch stays full
while a static whole-batch decoder would idle its finished lanes until
the longest member completes.

Two program families, each an ``executor._InstrumentedProgram`` over
the cache pool (one program card per bucket signature, the ``dispatch``
fault site; a test may swap in a plain callable):

* **prefill** (``_prefill_prog``) — per bucketed PROMPT length: one
  slot's state, the teacher-forced padded prompt, the slot's cache
  written, the first generated token returned.
* **decode** (``_decode_prog``) — per bucketed ACTIVE-SLOT count: the
  active slots gathered by index, every one advanced ONE token in a
  single batched step, the new state written back and the next tokens
  returned. Padding lanes carry slot id S (out of range): they gather a
  live slot (read only) and their rows are never written back.

Both update the pool IN PLACE, the counterpart of the reference's
donated buffers. There is nothing to compile: ``warmup()`` runs every
bucket once on the scheduler thread (building its card, counting no
dispatch), so cuBLAS handles, their workspaces and the allocator's
segments exist before traffic, and writes nothing.

Overload semantics follow serving's: bounded admission
(shed/``QueueOverflow`` or block), per-sequence deadlines enforced
while queued (shed at admission when the slot pool is saturated past
deadline) and while decoding, a transient-failure retry budget, and a
circuit breaker over consecutive dispatch failures. ``stats()`` reports
per-token latency (each decode step's wall time, dispatch through the
token fetch) and request latency (submit to terminal), computed here.

Telemetry as in the JAX package: the ``decode.*`` counters and events,
the ``serve_prefill`` / ``serve_decode_step`` / ``serve_detokenize``
spans (``telemetry.DECODE_SPANS``) under the causal request ids, the
``kv_cache`` ledger charge, ``corpus_record()``, ``telemetry_logger=``
and flight-recorder postmortems (a rebuilt pool, a breaker trip, a
dying scheduler).

A mesh (``partition_rules=``, ``mesh_axes=``, ``contexts=``, as
serving's) commits the parameters and the pool by the rules, one shard
a member (``parallel.spmd.MeshParams``). Under
``ring_attention.DECODE_PARTITION_RULES`` the heads of ``wq``/``wk``/
``wv``/``wo`` and of the cache split over ``mp``: each member attends
its own heads of its own cache, and only the output projection's
partial sum crosses the ``mp`` line (an all-reduce); ``embed`` and
``head`` stay whole. A cache held whole (``partition_rules=[]``, the
LSTM cell) leaves every member computing what one device computes.
Members of one process run each dispatch together; across processes the
scheduler runs on rank 0, which broadcasts every prefill (slot, length,
tokens) and every step (lanes, tokens, positions) to the followers and
samples the tokens.

Not ported yet: one captured CUDA graph per slot bucket (item 1).
"""
from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .base import MXNetError, latency_percentiles
from .context import current_context
from .executor import _InstrumentedProgram, record_dispatch
from . import telemetry
from . import flight
from .ops.common import numpy_dtype, torch_dtype
from .parallel.ring_attention import attention, decode_attention
from .rnn.rnn_cell import lstm_decode_step
from .serving import (DeadlineExceeded, QueueOverflow, CircuitOpen,
                      EngineClosed, bucket_sizes, _is_transient, _Request,
                      _SHUTDOWN)
from .weights import tree_from_numpy

__all__ = ["DecodeEngine", "DecodeResult", "AttentionDecodeCell",
           "LSTMDecodeCell", "DeadlineExceeded", "QueueOverflow",
           "CircuitOpen", "EngineClosed"]


# what a mesh engine's rank 0 broadcasts ahead of each dispatch
_MSG_STOP, _MSG_PREFILL, _MSG_STEP = 0, 1, 2

DecodeResult = collections.namedtuple("DecodeResult", ["tokens", "logits"])
DecodeResult.__doc__ = """One finished sequence: ``tokens`` is the
generated id list (prompt excluded, EOS included when hit);
``logits`` is the per-token ``(len(tokens), vocab)`` float32 array when
the engine runs with ``keep_logits=True``, else None."""


# -- decode cells -----------------------------------------------------------
#
# A cell is the model the engine batches: it owns the cache LAYOUT
# (slot-major leaf shapes and names) and two functions. ``prefill`` runs
# over ONE slot's state; ``step`` over a batch of gathered slots (a
# leading slot dimension), each row computing what the reference's
# per-slot step computes. Both take their ``state`` as donated: they may
# update its tensors in place, and return the new state.

def _caster(dtype):
    """Host draw (float64) -> the cell's dtype: a numpy array where numpy
    has the type, else (bfloat16) a CPU tensor, rounded to nearest even
    through float32 as the JAX package's ``astype(bfloat16)``."""
    if dtype == torch.bfloat16:
        return lambda a: torch.from_numpy(
            np.asarray(a, np.float32)).to(torch.bfloat16)
    npd = numpy_dtype(dtype)
    return lambda a: np.asarray(a).astype(npd)


class AttentionDecodeCell:
    """Single-layer KV-cached attention LM — the transformer-shaped
    decode workload. Cache leaves ``cache/k``/``cache/v`` are
    ``(S, H, T, D)``."""

    def __init__(self, vocab, embed, heads, head_dim, max_len,
                 dtype=np.float32):
        self.vocab = int(vocab)
        self.embed = int(embed)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.max_len = int(max_len)
        self.dtype = torch_dtype(dtype)

    def cache_spec(self, slots):
        shp = (int(slots), self.heads, self.max_len, self.head_dim)
        return {"cache/k": (shp, self.dtype), "cache/v": (shp, self.dtype)}

    def init_params(self, seed=0):
        """Deterministic host-side parameter draw: the same draws, in the
        same order, as the JAX package's cell."""
        rng = np.random.RandomState(seed)
        E, H, D, V = self.embed, self.heads, self.head_dim, self.vocab
        cast = _caster(self.dtype)

        def u(fan, *shape):
            s = 1.0 / np.sqrt(fan)
            return cast(rng.uniform(-s, s, shape))

        return {
            "embed": cast(rng.standard_normal((V, E)) * 0.05),
            "wq": u(E, E, H, D), "wk": u(E, E, H, D), "wv": u(E, E, H, D),
            "wo": u(H * D, H, D, E),
            "head": u(E, E, V),
        }

    def prefill(self, params, state, tokens, length, head_sum=None):
        """Teacher-forced prompt pass over ONE slot: ``tokens`` (L,) the
        padded prompt, ``length`` an int. Writes k/v for positions
        ``[0, L)`` into the ``(H, T, D)`` leaves of ``state``, attends
        causally, and returns the state and the logits at ``length - 1``
        (pad positions past ``length`` are never attended: the causal
        mask covers them here, the running-length mask afterwards).
        ``head_sum`` sums the output projection over the members that
        hold the other heads (a mesh member's own heads only: ``params``
        and ``state`` hold them)."""
        L = tokens.shape[0]
        x = params["embed"][tokens]                        # (L, E)
        q = torch.einsum("le,ehd->lhd", x, params["wq"])
        k = torch.einsum("le,ehd->lhd", x, params["wk"])
        v = torch.einsum("le,ehd->lhd", x, params["wv"])
        kh, vh = k.transpose(0, 1), v.transpose(0, 1)      # (H, L, D)
        kc, vc = state["cache/k"], state["cache/v"]
        kc[:, :L] = kh
        vc[:, :L] = vh
        out = attention(q.transpose(0, 1)[None], kh[None], vh[None],
                        causal=True)[0]                    # (H, L, D)
        proj = torch.einsum("hd,hde->e", out[:, length - 1], params["wo"])
        h = x[length - 1] + (proj if head_sum is None else head_sum(proj))
        return {"cache/k": kc, "cache/v": vc}, h @ params["head"]

    def step(self, params, state, tokens, pos, head_sum=None):
        """One decode step for a batch of slots: ``tokens``/``pos`` (B,)
        integer tensors, ``state`` leaves (B, H, T, D). Row b writes its
        k/v at ``pos[b]`` and attends over ``[0, pos[b]]``. Returns the
        state and the logits (B, V); ``head_sum`` as in ``prefill``."""
        x = params["embed"][tokens]                        # (B, E)
        q = torch.einsum("be,ehd->bhd", x, params["wq"])
        k = torch.einsum("be,ehd->bhd", x, params["wk"])
        v = torch.einsum("be,ehd->bhd", x, params["wv"])
        kc, vc = state["cache/k"], state["cache/v"]
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        # the two index tensors are split by a slice, so the indexed
        # dims lead: the value is (B, H, D)
        kc[rows, :, pos] = k.to(kc.dtype)
        vc[rows, :, pos] = v.to(vc.dtype)
        att = decode_attention(q, kc, vc, pos + 1)         # (B, H, D)
        proj = torch.einsum("bhd,hde->be", att, params["wo"])
        h = x + (proj if head_sum is None else head_sum(proj))
        return {"cache/k": kc, "cache/v": vc}, h @ params["head"]


class LSTMDecodeCell:
    """Single-layer LSTM LM — the RNN-shaped decode workload. The cache
    is the hidden/cell pair per slot (``cache/h``, ``cache/c``:
    ``(S, hidden)``); the step math is ``rnn.rnn_cell.lstm_decode_step``."""

    def __init__(self, vocab, embed, hidden, max_len, dtype=np.float32):
        self.vocab = int(vocab)
        self.embed = int(embed)
        self.hidden = int(hidden)
        self.max_len = int(max_len)
        self.dtype = torch_dtype(dtype)

    def cache_spec(self, slots):
        shp = (int(slots), self.hidden)
        return {"cache/h": (shp, self.dtype), "cache/c": (shp, self.dtype)}

    def init_params(self, seed=0):
        rng = np.random.RandomState(seed)
        E, Hid, V = self.embed, self.hidden, self.vocab
        cast = _caster(self.dtype)

        def u(fan, *shape):
            s = 1.0 / np.sqrt(fan)
            return cast(rng.uniform(-s, s, shape))

        return {
            "embed": cast(rng.standard_normal((V, E)) * 0.05),
            "wx": u(E, E, 4 * Hid), "wh": u(Hid, Hid, 4 * Hid),
            "b": cast(np.zeros(4 * Hid)),
            "head": u(Hid, Hid, V),
        }

    def step(self, params, state, tokens, pos):
        """One step for a batch of slots (or one slot: any leading dims)."""
        x = params["embed"][tokens]
        h, c = lstm_decode_step(x, state["cache/h"], state["cache/c"],
                                params["wx"], params["wh"], params["b"])
        return {"cache/h": h, "cache/c": c}, h @ params["head"]

    def prefill(self, params, state, tokens, length):
        """Run the prompt from a ZERO state (the slot's h/c are its
        previous occupant's, and an RNN carry has no mask) and return the
        state after ``length`` tokens with the logits at ``length - 1``.
        The reference scans the whole padded bucket with the state frozen
        past ``length``; those positions change nothing, so they are not
        run."""
        st = {n: torch.zeros_like(v) for n, v in state.items()}
        for i in range(length):
            st, logits = self.step(params, st, tokens[i], i)
        return st, logits


# -- the engine -------------------------------------------------------------

class _DecodeRequest(_Request):
    """One live sequence: serving's request (future, deadline, submit
    time) plus the decode cursor — slot index, next input token, its
    cache position, and the output accumulators."""

    __slots__ = ("prompt", "max_new", "eos_id", "slot", "next_token",
                 "pos", "out_tokens", "out_logits")

    def __init__(self, prompt, max_new, eos_id, deadline=None):
        super().__init__(arrays=None, rows=1, deadline=deadline)
        self.prompt = prompt             # np.int32 (len,)
        self.max_new = max_new
        self.eos_id = eos_id
        self.slot = None                 # guarded by: engine._lock
        self.next_token = None           # scheduler thread only
        self.pos = None                  # scheduler thread only
        self.out_tokens = []             # scheduler thread only
        self.out_logits = []             # scheduler thread only

    @property
    def finished(self):
        if len(self.out_tokens) >= self.max_new:
            return True
        return self.eos_id is not None and self.out_tokens \
            and self.out_tokens[-1] == self.eos_id


class _Call:
    """Work for the scheduler thread (``warmup``): run ``fn`` there and
    resolve ``future`` with its result."""

    __slots__ = ("fn", "future")

    def __init__(self, fn):
        self.fn = fn
        self.future = Future()

    def run(self):
        try:
            self.future.set_result(self.fn())
        except Exception as e:
            self.future.set_exception(e)


class DecodeEngine:
    """Continuous-batching autoregressive decode over a slot pool.

    cell : ``AttentionDecodeCell`` / ``LSTMDecodeCell`` (or anything
        with ``cache_spec``/``prefill``/``step``, ``max_len`` and
        ``vocab``)
    params : dict name -> array (numpy, tensor or NDArray) — copied to
        the device once
    slots : the pool size S: the most sequences decoding at once
    max_prompt_len : longest admissible prompt; prompt buckets are the
        powers of two up to it (default: half the cell's ``max_len``)
    max_new_tokens : per-request generation cap default
        (``submit(max_new_tokens=)`` overrides); prompt + new tokens must
        fit the cell's ``max_len``
    eos_id : default early-stop token id, or None
    ctx : Context — the device (default ``gpu(0)``; ``MXNetError`` when
        no CUDA device is present and no ``ctx=cpu()`` was given)
    partition_rules / mesh_axes / contexts : a mesh as serving's
        (``mesh_axes`` default ``{"dp": 1, "mp": -1}``; a mesh needs
        rules or axes): ``DECODE_PARTITION_RULES`` shards the heads over
        ``mp``, ``[]`` replicates everything. Across the processes of a
        launched job rank 0 schedules and the others follow it
    max_queue : sequences allowed to WAIT for a slot (None: unbounded)
    deadline_ms : default deadline for one sequence's whole life,
        enforced while queued and at every decode step
    overload : "shed" | "block" — full-queue policy, as serving
    retry_budget / retry_backoff_ms : transient dispatch retries
    breaker_threshold / breaker_reset_s : dispatch circuit breaker
    warmup : dispatch every bucket once at construction
    keep_logits : fetch and return per-token logits rows (one more
        device-to-host copy per step)
    telemetry_logger : optional ``callback.TelemetryLogger``; the engine
        calls its ``log_decode()`` after every decode step
    """

    def __init__(self, cell, params, slots=8, max_prompt_len=None,
                 max_new_tokens=64, eos_id=None, ctx=None,
                 partition_rules=None, mesh_axes=None, contexts=None,
                 max_queue=None, deadline_ms=None, overload="shed",
                 retry_budget=2, retry_backoff_ms=5.0,
                 breaker_threshold=5, breaker_reset_s=30.0,
                 warmup=True, keep_logits=False, telemetry_logger=None):
        self.cell = cell
        self.slots = int(slots)
        if self.slots < 1:
            raise MXNetError("decode: slots must be >= 1")
        self.max_len = int(cell.max_len)
        self.max_prompt_len = int(max_prompt_len) if max_prompt_len \
            else max(1, self.max_len // 2)
        if self.max_prompt_len > self.max_len:
            raise MXNetError("decode: max_prompt_len %d exceeds the "
                             "cell's max_len %d"
                             % (self.max_prompt_len, self.max_len))
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.prompt_buckets = bucket_sizes(self.max_prompt_len)
        self.slot_buckets = bucket_sizes(self.slots)
        if overload not in ("shed", "block"):
            raise MXNetError("decode: overload must be 'shed' or "
                             "'block', got %r" % (overload,))
        self.overload = overload
        self.max_queue = None if max_queue is None else max(1,
                                                            int(max_queue))
        self.deadline_s = None if deadline_ms is None \
            else float(deadline_ms) / 1e3
        self._retry_budget = max(0, int(retry_budget))
        self._retry_backoff_s = max(0.0, float(retry_backoff_ms)) / 1e3
        self._breaker_threshold = max(0, int(breaker_threshold))
        self._breaker_reset_s = float(breaker_reset_s)
        self._keep_logits = bool(keep_logits)
        self._logger = telemetry_logger

        self._mesh_spec = None
        self._follower = False
        if partition_rules is not None or mesh_axes:
            from .parallel import spmd as _spmd
            self._mesh_spec = _spmd.engine_spec(
                "decode", partition_rules, mesh_axes, contexts, ctx)
            ctx = self._mesh_spec.mesh.devices[0]
        if ctx is None:
            ctx = current_context()
        self._ctx = ctx
        self._device = ctx.torch_device()
        self._prefill_impl = self._make_prefill_impl()
        self._decode_impl = self._make_decode_impl()
        prefill, decode = self._prefill_impl, self._decode_impl
        if self._mesh_spec is None:
            self._params = tree_from_numpy(params, ctx=ctx)
            self._cache = self._make_cache()
        else:
            self._init_members(params)
            prefill = self._on_mesh(_MSG_PREFILL, prefill)
            decode = self._on_mesh(_MSG_STEP, decode)
        # the scheduler thread launches on the stream the parameters
        # were uploaded on
        self._stream = torch.cuda.current_stream(self._device) \
            if self._device.type == "cuda" else None

        # one program card per (family, bucket) signature; the bodies
        # return (cache, tokens, logits) and ``nan`` poisons the logits
        self._prefill_prog = _InstrumentedProgram(
            "decode_prefill", prefill,
            argnames=("params", "cache", "slot", "tokens", "length"),
            out_index=2, on_card=self._prefill_compiled)
        self._decode_prog = _InstrumentedProgram(
            "decode", decode,
            argnames=("params", "cache", "ids", "toks", "pos"),
            out_index=2)

        self._lock = threading.Lock()
        # admission backpressure + close wakeup: a Condition over the
        # SAME lock
        self._space = threading.Condition(self._lock)
        self._stats = collections.Counter()   # guarded by: self._lock
        self._queued = 0                 # guarded by: self._lock
        self._slot_table = [None] * self.slots   # guarded by: self._lock
        self._breaker_open_at = None     # guarded by: self._lock
        self._consecutive_failures = 0   # guarded by: self._lock
        self._closed = False             # guarded by: self._lock
        self._close_done = False         # guarded by: self._lock
        self._tok_lat = collections.deque(maxlen=100000)   # guarded by: self._lock
        self._req_lat = collections.deque(maxlen=100000)   # guarded by: self._lock
        self._q = queue.Queue()
        self._thread = threading.Thread(
            target=self._follow if self._follower else self._decode_loop,
            name="mx-decode-follow" if self._follower else "mx-decode-sched",
            daemon=True)
        self._thread.start()
        flight.register_engine(self)
        if warmup:
            self.warmup()

    # -- placement ----------------------------------------------------------
    def _make_cache(self):
        """A fresh zeroed slot pool on the device, charged to the buffer
        ledger as ``kv_cache`` (a rebuilt pool's old tensors release
        their charge when collected). On a mesh every member's pool of
        its shards, under the mesh's ledger key; member 0's is returned."""
        spec = self.cell.cache_spec(self.slots)
        if self._mesh_spec is not None:
            from .parallel import spmd as _spmd
            layout = self._layout

            def fresh(j):
                m = self._members[j]
                m["cache"] = {n: torch.zeros(layout.shard_shape(n),
                                             dtype=dt, device=m["device"])
                              for n, (_, dt) in spec.items()}
                for t in m["cache"].values():
                    layout.track(t, kind="kv_cache")
                return m["cache"]
            return _spmd.run_members(self._mesh_spec.mesh, fresh)[0]
        cache = {name: torch.zeros(shape, dtype=dtype, device=self._device)
                 for name, (shape, dtype) in spec.items()}
        for t in cache.values():
            telemetry.ledger_track(t, str(self._ctx), t.nbytes,
                                   shape=tuple(t.shape), dtype=str(t.dtype),
                                   kind="kv_cache")
        return cache

    def partition_summary(self):
        """JSON-safe layout of the decode mesh (None without one): the
        parameters' and the cache leaves' resolved specs."""
        if self._mesh_spec is None:
            return None
        from .parallel.partition import partition_summary as _summary
        return _summary(self._mesh_spec, self._layout.shapes)

    # -- the mesh ------------------------------------------------------------
    def _init_members(self, params):
        """Every member's shards of the parameters and of a zeroed pool
        (charged under the mesh key), the heads' axes when the pool is
        head-sharded, and the follower's role on ranks after the first."""
        from .parallel import spmd as _spmd
        from .context import cpu
        spec = self._mesh_spec
        mesh = spec.mesh
        whole = tree_from_numpy(params, ctx=cpu())
        shapes = {n: tuple(t.shape) for n, t in whole.items()}
        shapes.update({n: tuple(s) for n, (s, _)
                       in self.cell.cache_spec(self.slots).items()})
        layout = self._layout = _spmd.MeshParams(spec, shapes)
        self._heads = self._head_axes(layout, list(whole))

        def commit(j):
            layout.groups()
            dev = mesh.devices[j].torch_device()
            held = {n: layout.shard(n, t, dev) for n, t in whole.items()}
            for t in held.values():
                layout.track(t)
            return {"params": held, "device": dev}
        self._members = _spmd.run_members(mesh, commit)
        self._params = self._members[0]["params"]
        self._cache = self._make_cache()
        self._spanning = mesh.processes > 1
        self._follower = self._spanning and mesh.rank != 0
        self._follow_error = None

    def _head_axes(self, layout, param_names):
        """The axes the heads split over when the pool is sharded (the
        layout of ``DECODE_PARTITION_RULES``: dim 1 of the cache leaves
        and of ``wq``/``wk``/``wv``, dim 0 of ``wo``, nothing else), or
        None for a pool held whole on every member."""
        cache = list(self.cell.cache_spec(self.slots))
        if not any(layout.is_sharded(n) for n in cache):
            return None
        pl = layout.placements

        def splits(n):
            return [(d, pl[n].split(d)) for d in range(len(pl[n].spec))
                    if pl[n].split(d)] if layout.is_sharded(n) else []
        if not all(n in pl for n in ("wq", "wk", "wv", "wo")):
            splits = None
        axes = splits(cache[0]) if splits else []
        heads = [(0, axes[0][1])] if len(axes) == 1 else None
        ok = len(axes) == 1 and axes[0][0] == 1 \
            and all(splits(n) == axes for n in cache) \
            and all(splits(w) == axes for w in ("wq", "wk", "wv")) \
            and splits("wo") == heads \
            and not any(layout.is_sharded(n) for n in param_names
                        if n not in ("wq", "wk", "wv", "wo"))
        if not ok:
            raise MXNetError(
                "decode: the cache is sharded as %s; a sharded pool needs "
                "the heads layout of DECODE_PARTITION_RULES (heads of the "
                "cache and of wq/wk/wv/wo over one axis, every other "
                "parameter whole)" % {n: tuple(pl[n].spec) for n in cache})
        return axes[0][1]

    def _on_mesh(self, kind, impl):
        """A program body over the mesh: rank 0 of a launched job first
        broadcasts the dispatch, then every local member runs ``impl`` on
        its shards; member 0's (tokens, logits) come back."""
        def body(params, cache, *rest):
            if self._spanning:
                self._announce(kind, rest)
            tok, logits = self._run_members(impl, rest)
            return cache, tok, logits
        return body

    def _run_members(self, impl, rest):
        from .parallel import collectives as C
        from .parallel import spmd as _spmd
        layout, mesh = self._layout, self._mesh_spec.mesh

        def member(j):
            m = self._members[j]
            if self._heads is not None:
                group = mesh.group(self._heads)
                _, tok, logits = impl(
                    m["params"], m["cache"], *rest,
                    head_sum=lambda t: C._all_reduce(t, group, "sum"))
            else:
                params = {n: layout.whole(n, t)
                          for n, t in m["params"].items()}
                _, tok, logits = impl(params, m["cache"], *rest)
            return tok, logits
        return _spmd.run_members(mesh, member)[0]

    def _announce(self, kind, rest):
        """Rank 0: one dispatch's header and integer payload to every
        follower (a prefill's slot, length and tokens; a step's lanes)."""
        from .parallel import collectives as C
        if kind == _MSG_PREFILL:
            slot, tokens, length = rest
            C.broadcast(torch.tensor([kind, int(slot), int(length),
                                      len(tokens)]))
            C.broadcast(torch.from_numpy(np.asarray(tokens, np.int64)))
        else:
            ids, toks, pos = rest
            C.broadcast(torch.tensor([kind, len(ids), 0, 0]))
            C.broadcast(torch.from_numpy(np.stack([ids, toks, pos])
                                         .astype(np.int64)))

    def _follow(self):
        """A follower's loop: run every dispatch rank 0 broadcasts on this
        process's members, until its stop (a failure is raised by
        ``close()``)."""
        from .parallel import collectives as C
        try:
            with self._device_scope():
                while True:
                    head = C.broadcast(torch.zeros(4, dtype=torch.int64))
                    kind, a, b, c = (int(v) for v in head)
                    if kind == _MSG_STOP:
                        return
                    if kind == _MSG_PREFILL:
                        toks = C.broadcast(torch.zeros(c, dtype=torch.int64))
                        self._run_members(self._prefill_impl, (
                            np.int32(a), toks.numpy().astype(np.int32),
                            np.int32(b)))
                    else:
                        lanes = C.broadcast(torch.zeros(
                            (3, a), dtype=torch.int64)).numpy()
                        self._run_members(self._decode_impl, tuple(
                            lanes.astype(np.int32)))
        except BaseException as e:          # noqa: BLE001 -- close() raises
            self._follow_error = e

    def _not_follower(self, what):
        if self._follower:
            raise MXNetError(
                "decode: %s on rank %d, which follows the engine of rank 0 "
                "(a mesh across processes takes requests on rank 0 only)"
                % (what, self._mesh_spec.mesh.rank))

    def _prefill_compiled(self, card):
        telemetry.counter_inc("decode.prefill_compiles")

    def program_cards(self):
        """{card_id: card} for BOTH of this engine's program families —
        one card per (family, bucket) signature."""
        out = {}
        for prog in (self._prefill_prog, self._decode_prog):
            entry = getattr(prog, "entry", None)
            if entry is None:          # a swapped-in plain callable
                continue
            out.update({k: c for k, c in telemetry.programs().items()
                        if k == entry or k.startswith(entry + "/")})
        return out

    @contextlib.contextmanager
    def _device_scope(self):
        """The engine's device and stream, current for this thread."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            yield

    # -- program bodies ------------------------------------------------------
    def _make_prefill_impl(self):
        cell, S = self.cell, self.slots

        def prefill_impl(params, cache, slot, tokens, length, **cell_kw):
            # slot S (warmup) targets no slot: a zero scratch state whose
            # result is dropped
            slot, length = int(slot), int(length)
            live = slot < S
            state = {n: l[slot] if live else torch.zeros_like(l[0])
                     for n, l in cache.items()}
            dev = next(iter(cache.values())).device
            toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
            state, logits = cell.prefill(params, state, toks, length,
                                         **cell_kw)
            if live:
                for n, l in cache.items():
                    l[slot].copy_(state[n])
            return cache, torch.argmax(logits, dim=-1), logits

        return prefill_impl

    def _make_decode_impl(self):
        cell, S = self.cell, self.slots

        def decode_impl(params, cache, ids, toks, pos, **cell_kw):
            # live lanes lead; padding lanes carry id S. They gather slot
            # S-1 (read only) and only the n live rows are written back:
            # one program per BUCKET width, not per active set
            ids = np.asarray(ids)
            n = int(np.count_nonzero(ids < S))
            dev = next(iter(cache.values())).device
            lanes = torch.from_numpy(np.stack(
                [np.minimum(ids, S - 1), toks, pos]).astype(np.int64)).to(dev)
            idx, tok, p = lanes
            state = {name: l.index_select(0, idx)
                     for name, l in cache.items()}
            state, logits = cell.step(params, state, tok, p, **cell_kw)
            live = idx[:n]
            for name, l in cache.items():
                l.index_copy_(0, live, state[name][:n].to(l.dtype))
            return cache, torch.argmax(logits, dim=-1), logits

        return decode_impl

    def _fetch_rows(self, logits):
        """Logits rows to the host as float32 (bfloat16 widens exactly)."""
        return logits.to(torch.float32).cpu().numpy()

    # -- buckets -------------------------------------------------------------
    def prompt_bucket_for(self, n):
        for b in self.prompt_buckets:
            if b >= n:
                return b
        raise MXNetError("decode: prompt length %d exceeds "
                         "max_prompt_len=%d" % (n, self.max_prompt_len))

    def slot_bucket_for(self, n):
        for b in self.slot_buckets:
            if b >= n:
                return b
        raise MXNetError("decode: %d active slots exceed the pool (%d)"
                         % (n, self.slots))

    def warmup(self):
        """Dispatch every prompt bucket's prefill and every slot bucket's
        decode once, on the scheduler thread (whose cuBLAS handle and
        workspace the traffic uses), and fetch their results as traffic
        does. Nothing is written: the prefills target slot S and every
        decode lane is padding, so the pool keeps its contents. After it,
        steady traffic allocates no new allocator segment. A follower's
        members warm up with rank 0's."""
        if self._follower:
            return None
        call = _Call(self._warmup_now)
        with self._lock:
            if self._closed:
                raise EngineClosed("decode: engine is closed")
            self._q.put(call)
        return call.future.result()

    def _warmup_now(self):
        # ``build`` runs the call and makes its card without counting a
        # dispatch (the JAX package's warm-up compiles without executing)
        S = self.slots
        prefill = getattr(self._prefill_prog, "build", self._prefill_prog)
        decode = getattr(self._decode_prog, "build", self._decode_prog)
        for lb in self.prompt_buckets:
            _, tok, logits = prefill(
                self._params, self._cache, np.int32(S),
                np.zeros(lb, np.int32), np.int32(1))
            tok.item()
            if self._keep_logits:
                self._fetch_rows(logits)
        for sb in self.slot_buckets:
            pad = np.full(sb, S, np.int32)
            z = np.zeros(sb, np.int32)
            _, toks, logits = decode(self._params, self._cache, pad, z, z)
            toks.cpu()
            if self._keep_logits:
                self._fetch_rows(logits)

    # -- request surface -----------------------------------------------------
    def _record_latency_locked(self, req):
        self._req_lat.append((time.perf_counter() - req.t0) * 1e3)

    def submit(self, prompt, max_new_tokens=None, deadline_ms=None,
               eos_id=None):
        """Enqueue one sequence; returns a Future resolving to a
        ``DecodeResult``. ``prompt`` is a 1-D int token-id array
        (1 <= len <= max_prompt_len, ids in ``[0, vocab)``; prompt + new
        tokens must fit the cell's ``max_len``). ``deadline_ms`` bounds
        the whole submit-to-resolve life: expired waiters shed at
        admission when the slot pool is saturated, and a decoding
        sequence past its deadline sheds at the step boundary
        (``DeadlineExceeded``). A full bounded queue sheds
        (``QueueOverflow``) or blocks per the ``overload`` policy; an open
        breaker fast-fails (``CircuitOpen``)."""
        self._not_follower("submit")
        if self._closed:
            raise EngineClosed("decode: engine is closed")
        if self._breaker_tripped():
            with self._lock:
                self._stats["breaker_fastfail"] += 1
                consecutive = self._consecutive_failures
            telemetry.counter_inc("decode.breaker_fastfail")
            raise CircuitOpen(
                "decode: breaker open after %d consecutive dispatch "
                "failures — fast-failing instead of queuing onto a "
                "failing backend (retries again %.1fs after the trip)"
                % (consecutive, self._breaker_reset_s))
        prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
        if prompt.ndim != 1 or not prompt.size:
            raise MXNetError("decode: prompt must be a non-empty 1-D "
                             "token-id array, got shape %s"
                             % (prompt.shape,))
        if prompt.size > self.max_prompt_len:
            raise MXNetError("decode: prompt length %d exceeds "
                             "max_prompt_len=%d"
                             % (prompt.size, self.max_prompt_len))
        # an out-of-range id would fault the device's gather
        if prompt.min() < 0 or prompt.max() >= self.cell.vocab:
            raise MXNetError("decode: prompt token ids must lie in [0, %d)"
                             % self.cell.vocab)
        max_new = self.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise MXNetError("decode: max_new_tokens must be >= 1")
        if prompt.size + max_new > self.max_len:
            raise MXNetError(
                "decode: prompt (%d) + max_new_tokens (%d) exceed the "
                "cell's max_len %d — the cache cannot hold the "
                "sequence" % (prompt.size, max_new, self.max_len))
        dl_s = self.deadline_s if deadline_ms is None \
            else float(deadline_ms) / 1e3
        deadline = None if dl_s is None else time.monotonic() + dl_s
        req = _DecodeRequest(prompt, max_new,
                             self.eos_id if eos_id is None else eos_id,
                             deadline=deadline)

        def _drop_locked(exc, shed=False, deadline_hit=False):
            # admission-rejected: never enqueued, but the spans entered
            # at construction close, its rejection time is a latency
            # sample and a shed is accounted
            req.wait_span.__exit__(None, None, None)
            req.req_span.__exit__(None, None, None)
            self._record_latency_locked(req)
            if shed:
                self._stats["shed_requests"] += 1
                self._stats["shed.admission"] += 1
                telemetry.counter_inc("decode.shed")
                telemetry.counter_inc("decode.shed.admission")
                telemetry.record_event("decode.shed", req_id=req.req_id,
                                       cause="admission")
                if deadline_hit:
                    telemetry.counter_inc("decode.deadline_exceeded")
            raise exc

        with self._space:
            if self._closed:
                _drop_locked(EngineClosed("decode: engine is closed"))
            while self.max_queue is not None \
                    and self._queued + 1 > self.max_queue:
                if self.overload == "shed":
                    _drop_locked(QueueOverflow(
                        "decode: admission queue full (%d sequences "
                        "waiting for a slot, max_queue=%d) — shedding"
                        % (self._queued, self.max_queue)), shed=True)
                timeout = None if deadline is None \
                    else deadline - time.monotonic()
                if timeout is not None and timeout <= 0 \
                        or not self._space.wait(timeout):
                    _drop_locked(DeadlineExceeded(
                        "decode: deadline expired while blocked on a "
                        "full admission queue (max_queue=%d)"
                        % self.max_queue), shed=True, deadline_hit=True)
                if self._closed:
                    _drop_locked(EngineClosed("decode: engine is "
                                              "closed"))
            self._stats["requests"] += 1
            self._queued += 1
            self._q.put(req)
        telemetry.counter_inc("decode.requests")
        return req.future

    def generate(self, prompt, **kwargs):
        """Blocking convenience: ``submit`` + ``result()``."""
        return self.submit(prompt, **kwargs).result()

    # -- stats / state -------------------------------------------------------
    def stats(self):
        """Engine counters, slot occupancy, the cache's bytes and the
        per-token and request latency percentiles."""
        with self._lock:
            st = dict(self._stats)
            queued = self._queued
            active = sum(1 for s in self._slot_table if s is not None)
            breaker_open = self._breaker_tripped()
            consecutive = self._consecutive_failures
            tok_lat = np.asarray(self._tok_lat, dtype=np.float64)
            req_lat = np.asarray(self._req_lat, dtype=np.float64)
        kv_bytes = self.kv_cache_bytes()
        return {
            "requests": st.get("requests", 0),
            "resolved": st.get("resolved", 0),
            "failed_requests": st.get("failed_requests", 0),
            "shed_requests": st.get("shed_requests", 0),
            "shed_by_cause": {k[len("shed."):]: v for k, v in st.items()
                              if k.startswith("shed.")},
            "tokens": st.get("tokens", 0),
            "steps": st.get("steps", 0),
            "slot_admit": st.get("slot_admit", 0),
            "slot_retire": st.get("slot_retire", 0),
            "queued": queued,
            "max_queue": self.max_queue,
            "overload": self.overload,
            "deadline_ms": None if self.deadline_s is None
            else round(self.deadline_s * 1e3, 3),
            "slots": self.slots,
            "active_slots": active,
            "slot_fill": round(active / self.slots, 4),
            "retries": st.get("retries", 0),
            "dispatch_failures": st.get("dispatch_failures", 0),
            "breaker": {
                "open": breaker_open,
                "threshold": self._breaker_threshold,
                "consecutive_failures": consecutive,
                "trips": st.get("breaker_trips", 0),
                "fastfail": st.get("breaker_fastfail", 0),
            },
            "kv_cache_bytes": kv_bytes,
            "kv_cache_bytes_per_slot": kv_bytes // self.slots,
            "token_latency_ms": _percentiles(tok_lat),
            "request_latency_ms": _percentiles(req_lat),
        }

    def corpus_record(self):
        """One JSON-safe record of measured decode data for the card
        corpus. None until at least one step ran."""
        from . import compile_cache
        st = self.stats()
        if not st["steps"]:
            return None
        cards = {
            k: {kk: c.get(kk) for kk in
                ("kind", "flops", "bytes_accessed", "peak_bytes",
                 "compile_ms", "deserialize_ms", "source", "dispatches")}
            for k, c in self.program_cards().items()}
        spans = {k: v for k, v in telemetry.span_stats().items()
                 if k in telemetry.DECODE_SPANS}
        return {
            "kind": "decode",
            "ts": time.time(),
            "env": compile_cache.env_meta(),
            "slots": self.slots,
            "slot_buckets": list(self.slot_buckets),
            "prompt_buckets": list(self.prompt_buckets),
            "layout": self.partition_summary(),
            "cell": type(self.cell).__name__,
            "tokens": st["tokens"],
            "steps": st["steps"],
            "requests": st["requests"],
            "kv_cache_bytes": st["kv_cache_bytes"],
            "spans": spans,
            "cards": cards,
        }

    def kv_cache_bytes(self):
        """Device bytes of this engine's cache pool (on a mesh, of this
        process's members' shards of it)."""
        if self._mesh_spec is not None:
            return int(sum(t.nbytes for m in self._members
                           for t in m["cache"].values()))
        cache = self._cache        # one atomic read: the scheduler may
        # rebind the whole dict (pool rebuild)
        return int(sum(t.nbytes for t in cache.values()))

    def overload_state(self):
        """Light lock-held view of the engine's load."""
        with self._lock:
            return {
                "queued_rows": self._queued,
                "max_queue_rows": self.max_queue,
                "active_slots": sum(1 for s in self._slot_table
                                    if s is not None),
                "slots": self.slots,
                "breaker_open": self._breaker_tripped(),
                "consecutive_failures": self._consecutive_failures,
                "closed": self._closed,
            }

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Drain and stop: every already-submitted sequence resolves
        (finishes generating, or sheds on its own deadline) before
        close() returns; later submits raise ``EngineClosed``. Rank 0 of
        a mesh across processes then releases the followers, whose
        ``close()`` returns once that stop arrives."""
        if self._follower:
            with self._space:
                already, self._close_done = self._close_done, True
                self._closed = True
            if not already:
                self._thread.join()
                if self._follow_error is not None:
                    raise MXNetError("decode: this follower's loop failed "
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
        if self._mesh_spec is not None and self._spanning:
            from .parallel import collectives as C
            C.broadcast(torch.tensor([_MSG_STOP, 0, 0, 0]))
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
                self._logger.log_decode(self, force=True)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- breaker -------------------------------------------------------------
    def _breaker_tripped(self):
        opened = self._breaker_open_at
        if opened is None:
            return False
        return (time.monotonic() - opened) < self._breaker_reset_s

    def reset_breaker(self):
        """Force the breaker closed (operator override)."""
        with self._lock:
            self._breaker_open_at = None
            self._consecutive_failures = 0

    def _dispatch_failed(self):
        with self._lock:
            self._stats["dispatch_failures"] += 1
            self._consecutive_failures += 1
            consecutive = self._consecutive_failures
            trip = (self._breaker_threshold > 0
                    and consecutive >= self._breaker_threshold)
            if trip:
                self._breaker_open_at = time.monotonic()
                self._stats["breaker_trips"] += 1
        telemetry.counter_inc("decode.dispatch_failures")
        if trip:
            telemetry.counter_inc("decode.breaker_trips")
            telemetry.record_event("decode.breaker_trip",
                                   consecutive=consecutive)
            flight.postmortem("breaker_trip",
                              extra={"engine": self.overload_state(),
                                     "consecutive": consecutive})

    def _dispatch_succeeded(self):
        with self._lock:
            self._consecutive_failures = 0
            self._breaker_open_at = None

    # -- terminal request paths ---------------------------------------------
    def _shed(self, req, cause, exc):
        """Resolve one sequence's future with a structured shed error and
        account it by cause; the future resolves exactly once."""
        if req.future.done():
            return
        req.wait_span.__exit__(None, None, None)
        req.req_span.__exit__(None, None, None)
        req.future.set_exception(exc)
        with self._lock:
            self._record_latency_locked(req)
            self._stats["shed_requests"] += 1
            self._stats["shed.%s" % cause] += 1
        telemetry.counter_inc("decode.shed")
        telemetry.counter_inc("decode.shed.%s" % cause)
        telemetry.record_event("decode.shed", req_id=req.req_id,
                               cause=cause)
        if isinstance(exc, DeadlineExceeded):
            telemetry.counter_inc("decode.deadline_exceeded")

    def _fail_requests(self, reqs, exc):
        """Resolve every still-pending member with ``exc``: a failed
        sequence is neither resolved nor shed and has its own counter."""
        failed = 0
        for r in reqs:
            if not r.future.done():
                r.wait_span.__exit__(None, None, None)
                r.req_span.__exit__(None, None, None)
                r.future.set_exception(exc)
                with self._lock:
                    self._record_latency_locked(r)
                failed += 1
        if failed:
            with self._lock:
                self._stats["failed_requests"] += failed
            telemetry.counter_inc("decode.failed_requests", failed)

    def _retire(self, req):
        """One sequence finished: assemble the result on the host
        (``serve_detokenize``, the flow chain's last hop before
        serve_request), free the slot, resolve the future."""
        with telemetry.span("serve_detokenize",
                            ctx={"req_id": req.req_id}):
            logits = None
            if self._keep_logits and req.out_logits:
                logits = np.stack(req.out_logits)
            result = DecodeResult(tokens=list(req.out_tokens),
                                  logits=logits)
        with self._space:
            self._slot_table[req.slot] = None
            self._stats["resolved"] += 1
            self._stats["slot_retire"] += 1
            self._record_latency_locked(req)
            self._space.notify_all()
        telemetry.counter_inc("decode.resolved")
        telemetry.counter_inc("decode.slot_retire")
        telemetry.record_event("decode.retire", req_id=req.req_id,
                               slot=req.slot, tokens=len(req.out_tokens))
        req.req_span.__exit__(None, None, None)
        if not req.future.done():
            req.future.set_result(result)

    def _shed_active(self, req, cause, exc):
        """Shed a SLOTTED sequence (deadline hit mid-decode): free the
        slot, resolve with the structured error."""
        with self._space:
            self._slot_table[req.slot] = None
            self._stats["slot_retire"] += 1
            self._space.notify_all()
        telemetry.counter_inc("decode.slot_retire")
        self._shed(req, cause, exc)

    # -- scheduler -----------------------------------------------------------
    def _decode_loop(self):
        """The scheduler thread: drain admissions, fill free slots
        (prefill), advance every active slot one token (decode), retire
        finishers — one iteration per generated token per slot. It owns
        the slot cursors and every launch on the device; the slot TABLE
        is mutated under the engine lock so ``stats()`` never tears."""
        pending = []
        shutting = False
        try:
            with self._device_scope():
                while True:
                    with self._lock:
                        idle = not any(s is not None
                                       for s in self._slot_table)
                    block = idle and not pending and not shutting
                    while True:
                        try:
                            item = self._q.get() if block \
                                else self._q.get_nowait()
                        except queue.Empty:
                            break
                        block = False
                        if item is _SHUTDOWN:
                            shutting = True
                        elif isinstance(item, _Call):
                            item.run()
                        else:
                            pending.append(item)
                    self._admit(pending)
                    with self._lock:
                        active = [s for s in self._slot_table
                                  if s is not None]
                    if shutting and not active and not pending:
                        break
                    if active:
                        self._step(active)
        except BaseException as e:
            self._scheduler_died(pending, e)
            raise

    def _admit(self, pending):
        """Fill free slots from the waiting line, shedding expired
        waiters: a saturated slot pool must not hold a prompt past its
        deadline just to decode an answer nobody is waiting for."""
        while pending:
            now = time.monotonic()
            with self._lock:
                free = next((i for i, s in enumerate(self._slot_table)
                             if s is None), None)
            if free is None:
                # pool saturated: shed the already-expired waiters now
                for r in [r for r in pending if r.expired(now)]:
                    pending.remove(r)
                    with self._space:
                        self._queued -= 1
                        self._space.notify_all()
                    self._shed(r, "slot_wait", DeadlineExceeded(
                        "decode: deadline expired waiting for a slot "
                        "(pool of %d saturated)" % self.slots))
                return
            req = pending.pop(0)
            with self._space:
                self._queued -= 1
                self._space.notify_all()
            if req.expired(now):
                self._shed(req, "slot_wait", DeadlineExceeded(
                    "decode: deadline expired waiting for a slot "
                    "(pool of %d saturated)" % self.slots))
                continue
            self._prefill_one(req, free)

    def _should_retry(self, attempt, exc):
        """True (after the backoff) when a failed dispatch should run
        again: transient and within the retry budget."""
        if attempt >= self._retry_budget or not _is_transient(exc):
            return False
        with self._lock:
            self._stats["retries"] += 1
        telemetry.counter_inc("decode.retries")
        time.sleep(self._retry_backoff_s * (2 ** attempt))
        return True

    def _prefill_one(self, req, slot):
        """Admit one sequence into ``slot``: dispatch its prompt bucket's
        prefill (writes the slot's cache, returns the first generated
        token) and install the cursor."""
        req.wait_span.__exit__(None, None, None)
        lp = int(req.prompt.size)
        lb = self.prompt_bucket_for(lp)
        toks = np.zeros(lb, np.int32)
        toks[:lp] = req.prompt
        attempt = 0
        while True:
            try:
                record_dispatch("decode_prefill")
                with telemetry.span("serve_prefill",
                                    ctx={"req_id": req.req_id}):
                    self._cache, tok0, logits0 = self._prefill_prog(
                        self._params, self._cache, np.int32(slot), toks,
                        np.int32(lp))
                    # the generated token IS the next step's input: the
                    # one host sync of a step
                    tok_host = int(tok0.item())
                    row = self._fetch_rows(logits0) \
                        if self._keep_logits else None
                break
            except Exception as e:
                if self._should_retry(attempt, e):
                    attempt += 1
                    continue
                self._poisoned("prefill", req, e)
                return
        self._dispatch_succeeded()
        req.slot = slot
        req.next_token = tok_host
        req.pos = lp                      # the next input's position
        req.out_tokens.append(tok_host)
        if row is not None:
            req.out_logits.append(row)
        with self._space:
            self._slot_table[slot] = req
            self._stats["slot_admit"] += 1
            self._stats["tokens"] += 1
        telemetry.counter_inc("decode.slot_admit")
        telemetry.counter_inc("decode.tokens")
        telemetry.record_event("decode.admit", req_id=req.req_id,
                               slot=slot, prompt_len=lp)
        if req.finished:                  # max_new == 1, or instant EOS
            self._retire(req)

    def _step(self, active):
        """ONE continuous-batching decode step: advance every active slot
        one token in a single batched dispatch at the smallest covering
        slot bucket, append the fetched tokens, retire finishers and shed
        the deadline-expired."""
        n = len(active)
        bucket = self.slot_bucket_for(n)
        ids = np.full(bucket, self.slots, np.int32)   # pad = out of range
        toks = np.zeros(bucket, np.int32)
        pos = np.zeros(bucket, np.int32)
        for i, req in enumerate(active):
            ids[i] = req.slot
            toks[i] = req.next_token
            pos[i] = req.pos
        rids = [r.req_id for r in active]
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                record_dispatch("decode")
                with telemetry.span("serve_decode_step",
                                    ctx={"req_ids": rids}):
                    self._cache, toks_out, logits_out = self._decode_prog(
                        self._params, self._cache, ids, toks, pos)
                    toks_host = toks_out.cpu().numpy()
                    rows = self._fetch_rows(logits_out[:n]) \
                        if self._keep_logits else None
                break
            except Exception as e:
                if self._should_retry(attempt, e):
                    attempt += 1
                    continue
                self._poisoned("decode", None, e)
                return
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._dispatch_succeeded()
        with self._lock:
            self._stats["steps"] += 1
            self._stats["tokens"] += n
            self._tok_lat.append(dt_ms)
        telemetry.counter_inc("decode.steps")
        telemetry.counter_inc("decode.tokens", n)
        now = time.monotonic()
        for i, req in enumerate(active):
            tok = int(toks_host[i])
            req.out_tokens.append(tok)
            if rows is not None:
                req.out_logits.append(rows[i])
            req.next_token = tok
            req.pos += 1
            if req.finished:
                self._retire(req)
            elif req.expired(now):
                self._shed_active(req, "decode", DeadlineExceeded(
                    "decode: deadline expired after %d tokens"
                    % len(req.out_tokens)))
        if self._logger is not None:
            try:
                self._logger.log_decode(self)
            except Exception:
                pass

    def _poisoned(self, phase, req, exc):
        """A prefill/decode dispatch failed for good. The pool was being
        updated in place by the failed call, so every slotted sequence's
        state is unrecoverable: fail them all, rebuild a zeroed pool,
        keep serving new admissions. Feeds the breaker like any dispatch
        failure. The pool is rebuilt before any future fails, so a caller
        who sees the failure submits onto the new pool."""
        self._dispatch_failed()
        err = MXNetError(
            "decode: %s dispatch failed (%s: %s) — the cache pool is "
            "poisoned; every in-flight sequence failed and the pool was "
            "rebuilt" % (phase, type(exc).__name__, exc))
        with self._lock:
            active = [s for s in self._slot_table if s is not None]
            self._slot_table = [None] * self.slots
        self._cache = self._make_cache()
        victims = list(active)
        if req is not None:
            victims.append(req)
        self._fail_requests(victims, err)
        with self._space:
            self._space.notify_all()
        telemetry.record_event("decode.pool_rebuilt", phase=phase,
                               failed=len(victims))
        flight.postmortem("decode_dispatch_failure", exc=exc,
                          extra={"engine": self.overload_state(),
                                 "phase": phase,
                                 "req_ids": [r.req_id for r in victims]})

    def _scheduler_died(self, pending, exc):
        """Terminal cleanup for a dying scheduler thread: every pending,
        queued and slotted sequence resolves with a structured error, a
        queued warmup fails, and blocked submitters wake into
        ``EngineClosed``: no admitted sequence is left unresolved."""
        with self._space:
            self._closed = True
            self._space.notify_all()
        err = MXNetError(
            "decode: scheduler thread died (%s: %s) — the engine is "
            "closed and this sequence was never completed"
            % (type(exc).__name__, exc))
        left = list(pending)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _Call):
                item.future.set_exception(err)
            elif item is not _SHUTDOWN:
                left.append(item)
        with self._space:
            self._queued -= len(left)
            active = [s for s in self._slot_table if s is not None]
            self._slot_table = [None] * self.slots
            self._space.notify_all()
        for r in left:
            self._shed(r, "scheduler_death", err)
        self._fail_requests(active, err)
        flight.postmortem("decode_scheduler_death", exc=exc,
                          extra={"engine": self.overload_state(),
                                 "failed_requests": len(left)
                                 + len(active)})


def _percentiles(samples):
    return latency_percentiles(samples)
