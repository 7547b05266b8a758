"""The port's worker liveness (``mxnet_tpu_torch/heartbeat.py``): the
counterparts of ``tests/test_heartbeat.py``'s cases, run against the
port's module, and the two packages' interplay. Both packages write and
read the same files, so a JAX worker's heartbeat reads as alive to the
port and the other way round, a gate of each package crosses one
generation in one directory, and the same synthetic arrivals give equal
``gate_stats()`` and equal ``dist.straggler`` events in both.
"""
import os
import threading
import time

import pytest

from mxnet_tpu import faults as jfaults, heartbeat as jheartbeat
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import faults, heartbeat
from mxnet_tpu_torch.heartbeat import CollectiveGate, DeadWorkerError


def _wait_for(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_beat_writes_atomically_and_stop_removes_file(tmp_path):
    root = str(tmp_path)
    heartbeat.start_heartbeat(0, root=root, interval=0.05)
    try:
        path = os.path.join(root, "worker-0")
        assert _wait_for(lambda: os.path.exists(path))
        # the visible file is always COMPLETE: a reader never sees the
        # zero-length truncate window the old in-place write had
        for _ in range(20):
            with open(path) as f:
                content = f.read()
            assert content and float(content) > 0
            time.sleep(0.01)
        assert heartbeat.count_dead(1, root=root, timeout=10) == 0
    finally:
        heartbeat.stop_heartbeat()
    # stop removes the file (and its temp): the worker reads as
    # departed immediately, not alive-until-stale
    assert _wait_for(lambda: not os.path.exists(path))
    assert not os.path.exists(path + ".tmp")
    assert heartbeat.count_dead(1, root=root, timeout=10) == 1


def test_stop_heartbeat_idempotent(tmp_path):
    heartbeat.stop_heartbeat()          # no beat running: no-op
    heartbeat.start_heartbeat(3, root=str(tmp_path), interval=0.05)
    heartbeat.stop_heartbeat()
    heartbeat.stop_heartbeat()          # second stop: still a no-op


def test_count_dead_stale_file_still_counts(tmp_path):
    # a worker that died WITHOUT a clean stop leaves a stale file — the
    # timeout path still catches it
    root = str(tmp_path)
    path = os.path.join(root, "worker-0")
    with open(path, "w") as f:
        f.write(str(time.time() - 100))
    os.utime(path, (time.time() - 100, time.time() - 100))
    assert heartbeat.count_dead(1, root=root, timeout=10) == 1


# ---------------------------------------------------------------------------
# clock-skew tolerance, .tmp hygiene, liveness scan
# ---------------------------------------------------------------------------

def _fresh_worker(root, rank, age=0.0):
    path = os.path.join(root, "worker-%d" % rank)
    with open(path, "w") as f:
        f.write(str(time.time()))
    if age:
        t = time.time() - age
        os.utime(path, (t, t))
    return path


def test_count_dead_ignores_leftover_tmp_files(tmp_path):
    """A writer that died mid-rename leaves ``worker-N.tmp`` — it must
    never read as a live worker (and a dead rank with ONLY a .tmp file
    still counts dead)."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    with open(os.path.join(root, "worker-1.tmp"), "w") as f:
        f.write(str(time.time()))
    assert heartbeat.alive_ranks(root=root, timeout=10) == {0}
    assert heartbeat.count_dead(2, root=root, timeout=10) == 1


def test_staleness_is_clock_skew_tolerant(tmp_path, monkeypatch):
    """Staleness compares worker-file mtimes against a PROBE file's
    mtime in the same directory — the reader's wall clock is never
    consulted, so a reader skewed hours from the file server (NFS /
    GCS-fuse) neither reads live peers as dead nor dead peers as
    forever-live."""
    root = str(tmp_path)
    _fresh_worker(root, 0)            # fresh
    _fresh_worker(root, 1, age=100)   # genuinely stale
    real_time = time.time
    # reader clock skewed far ahead AND far behind: the verdicts of the
    # old now-vs-payload (and now-vs-mtime with a local now) comparison
    # would flip; the probe-based comparison cannot
    for skew in (+3600.0, -3600.0):
        monkeypatch.setattr(time, "time", lambda: real_time() + skew)
        assert heartbeat.count_dead(2, root=root, timeout=10) == 1
        assert heartbeat.alive_ranks(root=root, timeout=10) == {0}
    monkeypatch.setattr(time, "time", real_time)


def test_staleness_uses_mtime_not_payload(tmp_path):
    """The beat payload text is informational only: a file with a
    bogus (skewed-writer) timestamp payload but a fresh mtime is a
    LIVE worker."""
    root = str(tmp_path)
    path = _fresh_worker(root, 0)
    with open(path, "w") as f:
        f.write(str(time.time() - 99999.0))   # skewed payload
    assert heartbeat.count_dead(1, root=root, timeout=10) == 0


def test_stale_ranks_subset(tmp_path):
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 2, age=50)
    assert heartbeat.stale_ranks([0, 1, 2], root=root, timeout=10) == [1, 2]
    # no root configured: no verdicts (the surface is inert)
    assert heartbeat.stale_ranks([0, 1], root=None, timeout=10) == []


# ---------------------------------------------------------------------------
# CollectiveGate: the pre-collective barrier-file protocol
# ---------------------------------------------------------------------------

def test_gate_both_members_pass(tmp_path):
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)
    g0 = CollectiveGate(0, (0, 1), root=root, poll=0.01)
    g1 = CollectiveGate(1, (0, 1), root=root, poll=0.01)
    out = {}

    def cross(gate, key):
        out[key] = gate.arrive_and_wait()

    t = threading.Thread(target=cross, args=(g1, "r1"))
    t.start()
    cross(g0, "r0")
    t.join(5)
    assert out == {"r0": 1, "r1": 1}
    # a second crossing bumps the generation — same files, rewritten
    t = threading.Thread(target=cross, args=(g1, "r1"))
    t.start()
    cross(g0, "r0")
    t.join(5)
    assert out == {"r0": 2, "r1": 2}


def test_gate_detects_dead_peer(tmp_path):
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1, age=100)   # peer's heartbeat is stale
    g0 = CollectiveGate(0, (0, 1), root=root, timeout=10, poll=0.01)
    with pytest.raises(DeadWorkerError) as ei:
        g0.arrive_and_wait()
    assert ei.value.ranks == (1,)
    assert ei.value.channel == "step"
    assert ei.value.generation == 1
    assert not ei.value.timed_out


def test_gate_waits_for_slow_but_live_peer_then_hard_timeout(tmp_path):
    """A missing peer whose heartbeat stays FRESH is slow, not dead —
    the gate keeps waiting, and only the hard cap raises (flagged
    ``timed_out`` so the caller can tell the two apart)."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)            # fresh heartbeat, never arrives
    g0 = CollectiveGate(0, (0, 1), root=root, timeout=10,
                        gate_timeout=0.3, poll=0.01)
    t0 = time.monotonic()
    with pytest.raises(DeadWorkerError) as ei:
        g0.arrive_and_wait()
    assert time.monotonic() - t0 >= 0.25
    assert ei.value.timed_out
    assert ei.value.ranks == (1,)


def test_gate_disabled_without_root_or_peers(tmp_path):
    # no heartbeat dir: crossings are no-ops (still generation-counted)
    g = CollectiveGate(0, (0, 1), root=None)
    assert not g.enabled
    assert g.arrive_and_wait() == 1
    # single member: nothing to guard
    g = CollectiveGate(0, (0,), root=str(tmp_path))
    assert not g.enabled
    assert g.arrive_and_wait() == 1


def test_gate_kv_collective_fault_site_fires_before_arrival(tmp_path):
    """The chaos lane's deterministic kill point: an injected raise at
    ``kv_collective`` fires BEFORE the arrival is published, so peers
    observe an absent arrival — exactly a mid-training death."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    g = CollectiveGate(0, (0, 1), root=root, poll=0.01)
    faults.configure("kv_collective:raise:n=1")
    try:
        with pytest.raises(faults.InjectedFault):
            g.arrive_and_wait()
        assert not os.path.exists(g._member_path(0))
        assert faults.counts()["kv_collective"]["fired"] == 1
    finally:
        faults.clear()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_heartbeat_fault_site_kills_the_beat(tmp_path):
    """``heartbeat:raise`` kills the beat thread: the worker computes
    on but reads as dead — the zombie case the liveness tier must
    treat as a member loss. (The thread dying on the injected raise is
    the point — its unhandled-exception warning is expected.)"""
    root = str(tmp_path)
    faults.configure("heartbeat:raise:first=1000000")
    try:
        heartbeat.start_heartbeat(0, root=root, interval=0.02)
        deadline = time.time() + 5
        while time.time() < deadline \
                and not faults.counts().get("heartbeat", {}).get("fired"):
            time.sleep(0.02)
        assert faults.counts()["heartbeat"]["fired"] >= 1
        # the raise fired before the first write: no live file ever
        assert heartbeat.alive_ranks(root=root, timeout=10) == set()
        assert heartbeat.count_dead(1, root=root, timeout=10) == 1
    finally:
        faults.clear()
        heartbeat.stop_heartbeat()


# ---------------------------------------------------------------------------
# unlink-on-failure for every temp+rename site (a failed rename must never
# leave .tmp artifacts on the shared mount)
# ---------------------------------------------------------------------------

def test_fs_now_failed_rename_leaves_no_tmp(tmp_path, monkeypatch):
    root = str(tmp_path)

    def _boom(src, dst):
        raise OSError("replace failed")

    monkeypatch.setattr(heartbeat.os, "replace", _boom)
    t0 = time.time()
    now = heartbeat._fs_now(root)
    assert now >= t0 - 1.0             # fell back to the local clock
    assert not [n for n in os.listdir(root) if n.endswith(".tmp")]


def test_beat_failed_rename_leaves_no_tmp(tmp_path, monkeypatch):
    root = str(tmp_path)
    real_replace = os.replace
    fails = []

    def _boom(src, dst):
        if dst.endswith("worker-7"):
            fails.append(dst)
            raise OSError("replace failed")
        return real_replace(src, dst)

    monkeypatch.setattr(heartbeat.os, "replace", _boom)
    heartbeat.start_heartbeat(7, root=root, interval=0.02)
    try:
        # generous window: the 0.02s beat loop needs two failed beats,
        # but a loaded CI box can stall daemon threads for seconds
        assert _wait_for(lambda: len(fails) >= 2, timeout=20.0)
        # every failed beat cleans its temp — POLL for the absence:
        # fails.append runs inside the patched os.replace, i.e. while
        # the .tmp still exists, so a one-shot listdir can race the
        # beat thread's except-clause unlink
        assert _wait_for(lambda: not [n for n in os.listdir(root)
                                      if n.endswith(".tmp")])
        # the worker file itself never appeared (all renames failed)
        assert not os.path.exists(os.path.join(root, "worker-7"))
    finally:
        heartbeat.stop_heartbeat()


def test_gate_publish_failure_cleans_tmp_and_raises(tmp_path,
                                                    monkeypatch):
    root = str(tmp_path)
    g = CollectiveGate(0, (0, 1), root=root, poll=0.01)

    def _boom(src, dst):
        raise OSError("replace failed")

    monkeypatch.setattr(heartbeat.os, "replace", _boom)
    with pytest.raises(OSError):
        g._publish(1)
    # the crossing failed loudly AND left nothing for peers to scan
    assert not [n for n in os.listdir(root) if n.endswith(".tmp")]


# ---------------------------------------------------------------------------
# gate-wait straggler attribution: per-crossing gate_wait spans with causal
# (channel, generation) ctx, arrival order read back from the gate files,
# the self-time skew signal, and the streak machine behind the structured
# dist.straggler event
# ---------------------------------------------------------------------------

@pytest.fixture()
def _telemetry():
    from mxnet_tpu_torch import telemetry
    telemetry.enable()
    telemetry.reset()
    yield telemetry
    telemetry.reset()


def _cross_pair(g0, g1, delay1=0.0, self_work=None, n=1):
    """Cross both gates n times from two threads; rank 1 sleeps
    ``delay1`` seconds before each arrival. ``self_work`` optionally
    maps rank -> per-crossing own-work seconds slept WITHOUT a
    matching delay on the other side (the self-time skew case)."""
    def run(gate, delay, work):
        for _ in range(n):
            if work:
                time.sleep(work)
            if delay:
                time.sleep(delay)
            gate.arrive_and_wait()
    sw = self_work or {}
    t = threading.Thread(target=run, args=(g1, delay1, sw.get(1)))
    t.start()
    run(g0, 0.0, sw.get(0))
    t.join(10)


def _gate_wait_spans(telemetry, channel=None):
    return [s for s in telemetry.recent_spans()
            if s["name"] == "gate_wait"
            and (channel is None or s["ctx"].get("channel") == channel)]


def test_gate_wait_span_attributes_last_arriver(tmp_path, _telemetry):
    """Every completed crossing records a gate_wait span whose ctx
    names the channel, generation, the last arriver (read back from
    the gate files' mtimes — the shared filesystem's own clock) and
    its excess over the fleet median arrival."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)
    g0 = CollectiveGate(0, (0, 1), root=root, poll=0.01)
    g1 = CollectiveGate(1, (0, 1), root=root, poll=0.01)
    _cross_pair(g0, g1, delay1=0.15)
    spans = _gate_wait_spans(_telemetry, "step")
    assert len(spans) == 2              # one per rank
    for s in spans:
        c = s["ctx"]
        assert c["generation"] == 1
        assert c["last_rank"] == 1
        assert c["excess_ms"] >= 50
        # arrival order: rank 0 first at rel 0, rank 1 late
        ranks = [r for r, _rel in c["arrivals"]]
        assert ranks == [0, 1]
    # the early rank actually WAITED; the late rank cleared instantly
    by_wait = sorted(spans, key=lambda s: s["ctx"]["wait_ms"])
    assert by_wait[-1]["ctx"]["wait_ms"] >= 50
    cnt = _telemetry.counters()
    assert cnt.get("heartbeat.gate_crossings.step") == 2
    assert cnt.get("heartbeat.gate_wait_ms.step", 0) >= 50


def test_gate_straggler_streak_emits_event(tmp_path, _telemetry):
    """One slow crossing is noise; the SAME rank trailing the fleet
    median by >= the threshold for K consecutive crossings is a
    straggler — a structured dist.straggler event naming it, every
    crossing the streak persists."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)
    g0 = CollectiveGate(0, (0, 1), root=root, poll=0.01)
    g1 = CollectiveGate(1, (0, 1), root=root, poll=0.01)
    assert g0.straggler_k == 3          # default
    _cross_pair(g0, g1, delay1=0.15, n=4)
    evs = [e for e in _telemetry.events()
           if e["kind"] == "dist.straggler"]
    # streak hits K=3 at crossing 3 and persists through 4 — both
    # ranks run the same verdict from the same files
    assert len(evs) == 4
    for e in evs:
        d = e["data"]
        assert d["rank"] == 1
        assert d["channel"] == "step"
        assert d["excess_ms"] >= 50
        assert d["streak"] >= 3
    assert _telemetry.counters().get("dist.straggler") == 4


def test_gate_self_time_skew_names_hidden_straggler(tmp_path,
                                                    _telemetry):
    """A straggler whose slowness a synchronizing collective absorbs
    (peers blocked in the completion await arrive at the next gate
    TOGETHER) is invisible to arrival order — the self-time half of
    the verdict catches it: each rank publishes own-work time (wall
    window minus note_wait-reported waits) in its gate file, and the
    rank whose self-time exceeds the fleet median by the threshold is
    named."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)
    g0 = CollectiveGate(0, (0, 1), root=root, poll=0.01)
    g1 = CollectiveGate(1, (0, 1), root=root, poll=0.01)

    def run0():
        for _ in range(4):
            time.sleep(0.005)           # own work
            time.sleep(0.085)           # blocked on the "collective"
            g0.note_wait(85.0)          # ...reported as WAIT
            g0.arrive_and_wait()

    def run1():
        for _ in range(4):
            time.sleep(0.090)           # all own work
            g1.arrive_and_wait()

    t = threading.Thread(target=run1)
    t.start()
    run0()
    t.join(10)
    evs = [e for e in _telemetry.events()
           if e["kind"] == "dist.straggler"]
    assert evs and all(e["data"]["rank"] == 1 for e in evs)
    # the published self-times ride in the span ctx: rank 1's own-work
    # dominates while the arrivals themselves are near-simultaneous
    with_self = [s for s in _gate_wait_spans(_telemetry, "step")
                 if "self_ms" in s["ctx"]]
    assert with_self
    c = with_self[-1]["ctx"]
    assert c["self_ms"][1] - c["self_ms"][0] >= 50
    assert c["excess_ms"] >= 50


def test_gate_error_crossing_blames_dead_rank_no_streak(tmp_path,
                                                        _telemetry):
    """An aborted crossing (DeadWorkerError) attributes the FULL wait
    to the dead rank — the pre-death spike the fleet view pins on the
    victim — but never feeds the straggler streak (death is not
    slowness)."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1, age=100)     # peer heartbeat stale
    g0 = CollectiveGate(0, (0, 1), root=root, timeout=10, poll=0.01)
    with pytest.raises(DeadWorkerError):
        g0.arrive_and_wait()
    spans = _gate_wait_spans(_telemetry, "step")
    assert len(spans) == 1
    c = spans[0]["ctx"]
    assert c["last_rank"] == 1
    assert c["dead_ranks"] == [1]
    assert c["timed_out"] is False
    assert c["excess_ms"] == pytest.approx(c["wait_ms"])
    assert not [e for e in _telemetry.events()
                if e["kind"] == "dist.straggler"]


def test_gate_stats_and_module_merge(tmp_path, _telemetry):
    """Per-gate stats() feed gate_stats(), the per-channel merge the
    flight sampler folds into its series samples."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)
    # a channel name unique to this test: the process-global gate
    # registry may still hold gates a prior test's exception pinned
    g0 = CollectiveGate(0, (0, 1), root=root, poll=0.01,
                        channel="mergetest")
    g1 = CollectiveGate(1, (0, 1), root=root, poll=0.01,
                        channel="mergetest")
    _cross_pair(g0, g1, delay1=0.06, n=2)
    st = g0.stats()
    assert st["crossings"] == 2
    assert st["last_rank"] == 1
    assert st["wait_ms_total"] >= st["last_wait_ms"] > 0
    merged = heartbeat.gate_stats()
    assert "mergetest" in merged
    # BOTH live gates on the channel merge: totals sum
    assert merged["mergetest"]["crossings"] == 4


def test_gate_attribution_disabled_with_telemetry_off(tmp_path):
    """telemetry.disable() turns the whole attribution path off — no
    spans, no counters, no events — while the barrier protocol itself
    keeps working."""
    from mxnet_tpu_torch import telemetry
    telemetry.reset()
    telemetry.disable()
    try:
        root = str(tmp_path)
        _fresh_worker(root, 0)
        _fresh_worker(root, 1)
        g0 = CollectiveGate(0, (0, 1), root=root, poll=0.01)
        g1 = CollectiveGate(1, (0, 1), root=root, poll=0.01)
        _cross_pair(g0, g1)
    finally:
        telemetry.enable()
    assert not _gate_wait_spans(telemetry)
    assert not telemetry.counters()
    telemetry.reset()


# ---------------------------------------------------------------------------
# the two packages together: one file format, one protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_heartbeat(tmp_path, writer):
    """A beat of one package is a live worker to the other's queries,
    and a clean stop of it reads as departed there at once."""
    root = str(tmp_path)
    w, r = (jheartbeat, heartbeat) if writer == "jax" \
        else (heartbeat, jheartbeat)
    w.start_heartbeat(5, root=root, interval=0.05)
    try:
        assert _wait_for(lambda: r.alive_ranks(root=root, timeout=10)
                         == {5})
        assert r.stale_ranks([4, 5], root=root, timeout=10) == [4]
        assert r.count_dead(6, root=root, timeout=10) == 5
    finally:
        w.stop_heartbeat()
    assert r.alive_ranks(root=root, timeout=10) == set()
    # and a stale file is stale to both
    _fresh_worker(root, 2, age=100)
    assert r.stale_ranks([2], root=root, timeout=10) == [2]
    assert w.stale_ranks([2], root=root, timeout=10) == [2]


def test_gates_of_both_packages_cross_one_generation(tmp_path):
    """A JAX gate (rank 0) and a port gate (rank 1) in one directory
    wait for each other: two crossings, the generations agree, and the
    port's side waited for the JAX side's late arrival."""
    root = str(tmp_path)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1)
    gj = jheartbeat.CollectiveGate(0, (0, 1), root=root, poll=0.01,
                                   channel="mixed")
    gt = CollectiveGate(1, (0, 1), root=root, poll=0.01, channel="mixed")
    assert gj._dir == gt._dir
    out = {}

    def cross_jax():
        for i in range(2):
            time.sleep(0.1)
            out.setdefault("jax", []).append(gj.arrive_and_wait())

    t = threading.Thread(target=cross_jax)
    t.start()
    t0 = time.monotonic()
    got = [gt.arrive_and_wait() for _ in range(2)]
    waited = time.monotonic() - t0
    t.join(10)
    assert got == out["jax"] == [1, 2]
    assert waited >= 0.15
    # a dead JAX peer is named by the port's gate, and the reverse
    _fresh_worker(root, 0, age=100)
    with pytest.raises(DeadWorkerError) as ei:
        CollectiveGate(1, (0, 1), root=root, timeout=10, poll=0.01,
                       channel="dead").arrive_and_wait()
    assert ei.value.ranks == (0,)
    _fresh_worker(root, 0)
    _fresh_worker(root, 1, age=100)
    with pytest.raises(jheartbeat.DeadWorkerError) as ej:
        jheartbeat.CollectiveGate(0, (0, 1), root=root, timeout=10,
                                  poll=0.01,
                                  channel="dead2").arrive_and_wait()
    assert ej.value.ranks == (1,)


def _synthetic_crossings(pkg, root, channel, n, t0_ns, now_ns):
    """Rank 0's gate of ``pkg`` records ``n`` crossings from the same
    files: rank 1 arrives 80 ms after rank 0 each time and publishes 90
    ms of self-time against rank 0's 5."""
    gate = pkg.CollectiveGate(0, (0, 1), root=root, channel=channel)
    os.makedirs(gate._dir, exist_ok=True)
    base = 1.7e9
    for gen in range(1, n + 1):
        for rank, dt, self_ms in ((0, 0.0, "5.000"), (1, 0.08, "90.000")):
            path = gate._member_path(rank)
            with open(path, "w") as f:
                f.write("%d %.6f %s" % (gen, base + gen + dt, self_ms))
            os.utime(path, (base + gen + dt, base + gen + dt))
        gate._record_crossing(gen, t0_ns)
    return gate


def test_same_arrivals_same_verdicts_in_both_packages(tmp_path,
                                                      monkeypatch):
    """The same gate files, read back by each package's gate at the same
    clock, give equal per-gate stats, equal ``gate_stats()`` and equal
    ``dist.straggler`` events."""
    from mxnet_tpu_torch import telemetry
    now_ns = time.perf_counter_ns()
    monkeypatch.setattr(time, "perf_counter_ns", lambda: now_ns)
    stats, evs = {}, {}
    for name, pkg, tel in (("jax", jheartbeat, jtelemetry),
                           ("torch", heartbeat, telemetry)):
        tel.enable()
        tel.reset()
        root = str(tmp_path / name)
        gate = _synthetic_crossings(pkg, root, "synthetic", 5,
                                    now_ns - 12_000_000, now_ns)
        stats[name] = (gate.stats(), pkg.gate_stats()["synthetic"])
        evs[name] = [(e["kind"], e["data"]) for e in tel.events()
                     if e["kind"] == "dist.straggler"]
        tel.reset()
    assert stats["torch"] == stats["jax"]
    assert stats["torch"][0]["last_rank"] == 1
    assert stats["torch"][0]["stragglers"] == 3
    assert evs["torch"] == evs["jax"]
    assert [d["streak"] for _, d in evs["torch"]] == [3, 4, 5]
    assert all(d["rank"] == 1 and d["excess_ms"] == 85.0
               for _, d in evs["torch"])
