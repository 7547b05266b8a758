"""Runtime implementation tuning, and the serving autotuner.

Counterpart of ``mxnet_tpu/tuner.py`` (parity target: the reference's
``src/operator/operator_tune.{h,cc,-inl.h}``, which times each
elementwise kernel at start-up to choose OMP or serial per op and size).

``OperatorTuner`` chooses between named implementations of one op: it
measures each candidate the first time an (op, static signature) pair is
seen, caches the winner in the process and, with ``MXNET_TUNING_CACHE``,
in a JSON file. On a card the candidates are timed with CUDA events after
a synchronise; on the host with the wall clock around work that ends in
its result. The port has no call site for it: the JAX package's two
(``pallas/flash_attention.py:78``, ``parallel/ring_attention.py:282``)
choose between a Pallas kernel and a plain composition, and the port runs
no plain version of a kernel on the card.

Env knobs (the reference's names):
- ``MXNET_USE_OPERATOR_TUNING`` (default 1): 0 turns measurement off and
  every choice falls to the first (default) candidate;
- ``MXNET_OUTPUT_TUNING_DATA`` (default 0): log each measurement;
- ``MXNET_TUNING_CACHE``: a JSON file that decisions are loaded from and
  saved to;
- ``MXNET_TUNING_REPEAT`` (default 3): timed runs per candidate.

The serving autotuner (``plan_serving`` and its helpers, a copy of
``mxnet_tpu/tuner.py:178-389``) derives the SERVING CONFIGURATION (the
bucket set, the pipeline depth) from the persisted corpus
(``compile_cache.corpus_records``) — measured per-bucket step-ms and the
observed coalesced-row histogram across past runs — instead of pow-2
defaults. The learned-cost-model framing is Kaufman et al.
(arXiv:2008.01040): the corpus is the feature store, the interpolated
cost model below its first, deliberately simple reader.
"""
from __future__ import annotations

import json
import math
import os
import time

import torch

from .base import get_env
from .log import get_logger

__all__ = ["OperatorTuner", "tuner", "tuned_choice", "plan_serving"]

_log = get_logger("tuner")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    data = getattr(x, "_data", None)       # an NDArray
    return [data] if isinstance(data, torch.Tensor) else []


def _is_abstract(x):
    """Whether ``x`` carries no data to time: a ``meta`` tensor (the
    executor's shape inference) or a value traced by ``torch.compile``
    (the JAX package's tracer test)."""
    return torch.compiler.is_compiling() or any(
        t.is_meta for t in _tensors(x))


class OperatorTuner:
    """Measure-and-cache chooser over named implementation candidates.

    ``choose(op, key, candidates)`` returns the label of the fastest
    candidate for this (op, key) signature. ``candidates`` is an ordered
    ``(label, thunk)`` sequence; each thunk runs its implementation once
    on synthetic data and returns tensors (timed to completion: CUDA
    events when the result lies on a card, the wall clock otherwise).
    The first candidate is the default: it wins without measurement when
    tuning is off, and when every candidate fails.
    """

    def __init__(self):
        self._cache = {}
        self._records = []          # (op, key, label, {label: seconds})
        self._loaded_path = None

    # -- persistence -------------------------------------------------------
    def _persist_path(self):
        return get_env("MXNET_TUNING_CACHE", "", str) or None

    def _load_persisted(self):
        path = self._persist_path()
        if path and path != self._loaded_path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._cache.update(json.load(f))
            except (OSError, ValueError) as e:
                _log.warning("tuner: could not load %s: %s", path, e)
            self._loaded_path = path

    def _save_persisted(self):
        path = self._persist_path()
        if not path:
            return
        try:
            with open(path, "w") as f:
                json.dump(self._cache, f, indent=0, sort_keys=True)
        except OSError as e:
            _log.warning("tuner: could not save %s: %s", path, e)

    # -- core --------------------------------------------------------------
    @staticmethod
    def enabled():
        return bool(get_env("MXNET_USE_OPERATOR_TUNING", 1, int))

    @staticmethod
    def _cache_key(op, key):
        return "%s|%s" % (op, key)

    def choose(self, op, key, candidates):
        """Pick a label from ``candidates`` for signature ``(op, key)``."""
        candidates = list(candidates)
        labels = [lab for lab, _ in candidates]
        if len(candidates) == 1:
            return labels[0]
        self._load_persisted()
        ck = self._cache_key(op, key)
        hit = self._cache.get(ck)
        if hit in labels:
            return hit
        if not self.enabled():
            return labels[0]
        best = self._measure(op, key, candidates)
        self._cache[ck] = best
        self._save_persisted()
        return best

    def cached(self, op, key, default):
        """The cached choice, never measured (for abstract values, where
        running real work must not happen)."""
        self._load_persisted()
        return self._cache.get(self._cache_key(op, key), default)

    @staticmethod
    def _time_once(thunk, cuda):
        """Seconds of one call: CUDA events around it on the card (after
        a synchronise, so no earlier work is counted), else the wall
        clock around the call and a wait for its tensors."""
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            thunk()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        _tensors(thunk())           # host tensors are ready on return
        return time.perf_counter() - t0

    def _measure(self, op, key, candidates):
        repeat = max(1, get_env("MXNET_TUNING_REPEAT", 3, int))
        timings = {}
        for label, thunk in candidates:
            try:
                warm = _tensors(thunk())                # first call: warm
                cuda = any(t.is_cuda for t in warm)
                timings[label] = min(self._time_once(thunk, cuda)
                                     for _ in range(repeat))
            except Exception as e:                   # candidate invalid here
                _log.debug("tuner: %s[%s] candidate %r failed: %s",
                           op, key, label, e)
                timings[label] = float("inf")
        winner = min(timings, key=timings.get)
        if not (timings[winner] < float("inf")):
            winner = candidates[0][0]                # all failed: default
        self._records.append((op, key, winner, dict(timings)))
        if get_env("MXNET_OUTPUT_TUNING_DATA", 0, int):
            _log.info("tuner: %s[%s] -> %r  (%s)", op, key, winner,
                      ", ".join("%s=%.3gms" % (l, t * 1e3)
                                for l, t in timings.items()))
        return winner

    # -- introspection -----------------------------------------------------
    def records(self):
        """Measurement log: list of (op, key, winner, {label: seconds})."""
        return list(self._records)

    def clear(self):
        self._cache.clear()
        self._records.clear()
        self._loaded_path = None


_TUNER = OperatorTuner()


def tuner():
    """The process-wide tuner."""
    return _TUNER


def tuned_choice(op, key, candidates, args=()):
    """The measured choice, or the cached one (else the default
    candidate) when any of ``args`` is abstract (a ``meta`` tensor, or
    traced by ``torch.compile``)."""
    candidates = list(candidates)
    if any(_is_abstract(a) for a in args):
        return _TUNER.cached(op, key, candidates[0][0])
    return _TUNER.choose(op, key, candidates)


# ---------------------------------------------------------------------------
# The serving autotuner (card-corpus plans)
# ---------------------------------------------------------------------------

def _merge_rows_hist(records, max_batch):
    hist = {}
    for r in records:
        for k, v in (r.get("rows_hist") or {}).items():
            try:
                rows, n = int(k), int(v)
            except (TypeError, ValueError):
                continue
            if 1 <= rows <= max_batch and n > 0:
                hist[rows] = hist.get(rows, 0) + n
    return hist


def _merge_bucket_ms(records):
    """{bucket: mean dispatch->fetched ms} pooled over records."""
    acc = {}
    for r in records:
        for b, st in (r.get("bucket_ms") or {}).items():
            try:
                b = int(b)
                t = float(st.get("total_ms", 0.0))
                c = int(st.get("count", 0))
            except (TypeError, ValueError, AttributeError):
                continue
            if c > 0:
                e = acc.setdefault(b, [0.0, 0])
                e[0] += t
                e[1] += c
    return {b: t / c for b, (t, c) in acc.items() if c}


def _cost_model(mean_ms):
    """ms(batch) from measured per-bucket means: linear interpolation
    between measured points, proportional extrapolation outside them,
    and a plain ``ms = batch`` (pure linear) prior with NO measurements
    — so the planner still works on a rows-histogram-only corpus."""
    pts = sorted(mean_ms.items())

    def cost(b):
        if not pts:
            return float(b)
        if b <= pts[0][0]:
            return pts[0][1] * b / pts[0][0]
        if b >= pts[-1][0]:
            return pts[-1][1] * b / pts[-1][0]
        for (b0, m0), (b1, m1) in zip(pts, pts[1:]):
            if b0 <= b <= b1:
                f = (b - b0) / float(b1 - b0)
                return m0 + f * (m1 - m0)
        return float(b)
    return cost


def _pick_buckets(hist, max_batch, cost, max_buckets):
    """Optimal <=max_buckets bucket-top set over the observed row
    counts, minimising expected per-batch cost
    sum_r hist[r] * cost(smallest chosen bucket >= r) by exact DP over
    the candidate tops (every observed row count, plus max_batch which
    MUST be in the set so any request is coverable). Deterministic:
    ties break toward fewer buckets, then the lexicographically
    smaller set."""
    cands = sorted(set(list(hist) + [max_batch]))
    n = len(cands)
    weights = [hist.get(c, 0) for c in cands]
    # seg_cost[j][i]: rows in cands(j..i] served at bucket cands[i]
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + w)

    def seg_cost(j, i):
        # candidates j+1..i (0-based, inclusive) map to bucket cands[i]
        return (prefix[i + 1] - prefix[j + 1]) * cost(cands[i])

    first_cost = [ (prefix[i + 1] - prefix[0]) * cost(cands[i])
                   for i in range(n)]
    INF = float("inf")
    # dp[k][i]: min cost covering cands[0..i] with k buckets, cands[i]
    # a bucket top; parent pointers reconstruct the set
    max_k = max(1, min(int(max_buckets), n))
    dp = [[INF] * n for _ in range(max_k + 1)]
    parent = [[None] * n for _ in range(max_k + 1)]
    for i in range(n):
        dp[1][i] = first_cost[i]
    for k in range(2, max_k + 1):
        for i in range(k - 1, n):
            best, arg = INF, None
            for j in range(k - 2, i):
                c = dp[k - 1][j] + seg_cost(j, i)
                if c < best:
                    best, arg = c, j
            dp[k][i] = best
            parent[k][i] = arg
    last = n - 1               # max_batch must top the set
    best_k, best_cost = 1, dp[1][last]
    for k in range(2, max_k + 1):
        # strict improvement required: ties prefer FEWER buckets
        if dp[k][last] < best_cost - 1e-12:
            best_k, best_cost = k, dp[k][last]
    tops, k, i = [], best_k, last
    while i is not None and k >= 1:
        tops.append(cands[i])
        i = parent[k][i]
        k -= 1
    return sorted(tops), best_cost


def _plan_inflight(records, default=2, cap=8):
    """Pipeline depth from the measured serve spans: while a batch's
    d2h fetch blocks a resolver, the coalescer can keep ~d2h/batch
    extra batches in flight; +1 for the one being built. Falls back to
    ``default`` without span data."""
    d2h, batch = [0.0, 0], [0.0, 0]
    for r in records:
        sp = r.get("spans") or {}
        for name, acc in (("serve_d2h", d2h), ("serve_batch", batch)):
            st = sp.get(name) or {}
            try:
                t, c = float(st.get("total_ms", 0.0)), int(
                    st.get("count", 0))
            except (TypeError, ValueError):
                continue
            if c > 0:
                acc[0] += t
                acc[1] += c
    if not d2h[1] or not batch[1]:
        return int(default)
    d2h_ms = d2h[0] / d2h[1]
    batch_ms = max(batch[0] / batch[1], 1e-6)
    return max(1, min(int(cap), 1 + int(math.ceil(d2h_ms / batch_ms))))


def _layout_key(layout):
    """Comparable identity of one partition layout: mesh axes + data
    axis + the RULE TREE, with the resolved ``sharded_params`` map
    stripped — that field is derived from whichever parameter shapes
    happened to be in hand when the summary was taken (an engine
    summarising at plan-load time has none yet; a corpus row banked at
    close has all of them), so keeping it would make identical layouts
    compare unequal. None (no partitioning) is its own identity."""
    if not isinstance(layout, dict):
        return None
    part = layout.get("partition")
    if isinstance(part, dict):
        part = {k: v for k, v in part.items() if k != "sharded_params"}
    key = dict(layout, partition=part)
    return json.dumps(key, sort_keys=True)


def plan_serving(records, max_batch=None, max_buckets=6,
                 default_inflight=2, graph=None, layout=None):
    """Deterministic serving plan from ``kind == "serving"`` corpus
    records: the bucket set minimising expected padded batch cost over
    the observed coalesced-row histogram (measured per-bucket step-ms
    as the cost model, linear prior without measurements) and a
    ``max_inflight`` derived from the measured d2h/batch span ratio.

    ``graph`` (an engine's ``graph_fingerprint()``) restricts planning
    to records stamped with the SAME graph — corpora are shared per
    cache dir, and another model's traffic must not shape this one's
    buckets. ``layout`` (an engine's ``partition_summary()``) rides
    into the returned plan AND restricts planning the same way: rows
    measured under an mp-sharded layout carry different per-bucket
    step costs than replicated rows of the same graph — the filter
    ALWAYS applies (a replicated engine, ``layout=None``, only plans
    from rows with no layout stamp), comparing via ``_layout_key`` so
    the derived ``sharded_params`` map never splits identical
    layouts.

    Returns a JSON-native dict (it round-trips through the JSONL
    corpus store unchanged) or None when the corpus holds no usable
    serving data. Same records -> same plan, always: the autotuner
    must be a pure function of the corpus.
    """
    recs = [r for r in (records or [])
            if isinstance(r, dict) and r.get("kind") == "serving"]
    if graph is not None:
        recs = [r for r in recs if r.get("graph") == graph]
    lkey = _layout_key(layout)
    recs = [r for r in recs if _layout_key(r.get("layout")) == lkey]
    if max_batch is None:
        max_batch = max((int(r.get("max_batch") or 0) for r in recs),
                        default=0)
    max_batch = int(max_batch or 0)
    if max_batch < 1:
        return None
    hist = _merge_rows_hist(recs, max_batch)
    if not hist:
        return None
    mean_ms = _merge_bucket_ms(recs)
    cost = _cost_model(mean_ms)
    buckets, expected = _pick_buckets(hist, max_batch, cost, max_buckets)
    total_batches = sum(hist.values())
    return {
        "kind": "autotune_plan",
        "version": 1,
        "graph": graph,
        "layout": layout,
        "max_batch": max_batch,
        "buckets": [int(b) for b in buckets],
        "max_inflight": _plan_inflight(recs, default=default_inflight),
        "expected_cost_ms_per_batch": round(expected / total_batches, 4)
        if total_batches else None,
        "basis": {
            "records": len(recs),
            "observed_batches": total_batches,
            "distinct_rows": len(hist),
            "measured_buckets": sorted(int(b) for b in mean_ms),
        },
    }
