"""The serving autotuner: a bucket plan from the program-card corpus.

A copy of ``mxnet_tpu/tuner.py:178-389`` (``plan_serving`` and its
helpers): the SERVING CONFIGURATION (batch-bucket set, pipeline depth)
from the persisted corpus (``compile_cache.corpus_records``) — measured
per-bucket step-ms and the observed coalesced-row histogram across past
runs — instead of pow-2 defaults. The learned-cost-model framing is
Kaufman et al. (arXiv:2008.01040): the corpus is the feature store, the
interpolated cost model below its first, deliberately simple reader.

``OperatorTuner`` and ``tuned_choice`` (:47-176, :390), which time
implementations of one op against each other, are not ported yet
(ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import json
import math

__all__ = ["plan_serving"]


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
